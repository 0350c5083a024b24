"""Ulysses attention: the port on a 2-rank gloo world of CPU processes
against the JAX package's ``ulysses_attention`` on a {"seq": 2} mesh of the
virtual CPU devices.

Inputs come from numpy with a seed; each rank takes its sequence shard, and
the shards of the port's output and gradients (of sum(out * dO)) are put
back together and compared with the JAX arrays. Plain path (JAX "xla"):
causal and full attention, MHA and GQA, output within 1e-5 and gradients
within 1e-4 (fp32); flash path (the port's flash kernels' plain versions on
the gathered sequence against the Pallas kernels in interpret mode) within
the flash parity tolerances (1e-4 forward, 1e-3 gradients). A KV-head count
the degree does not divide raises in both packages. One world a module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_runner_fns
from maggy_tpu.parallel import make_mesh as jax_make_mesh
from maggy_tpu.parallel.ulysses import ulysses_attention as jax_ulysses

pytestmark = [pytest.mark.torch, pytest.mark.timeout(150)]

WORLD = 2
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
FLASH_OUT_TOL, FLASH_GRAD_TOL = 1e-4, 1e-3

# name -> (B, S, H, Hkv, D, causal, impl)
CASES = {
    "plain_causal_gqa": (2, 64, 4, 2, 16, True, "plain"),
    "plain_full_gqa": (2, 64, 8, 2, 16, False, "plain"),
    "plain_causal_mha": (1, 32, 4, 4, 8, True, "plain"),
    "flash_causal_gqa": (1, 256, 4, 2, 64, True, "flash"),
    "kv_heads_indivisible": (1, 64, 4, 1, 16, True, "plain"),
}


def _case(name):
    B, S, H, Hkv, D, causal, impl = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return {"q": rng.normal(size=(B, S, H, D)).astype(np.float32),
            "k": rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            "v": rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            "do": rng.normal(size=(B, S, H, D)).astype(np.float32),
            "causal": causal, "impl": impl, "fn": "ulysses"}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases = {name: _case(name) for name in CASES}
    out_dir = str(tmp_path_factory.mktemp("ulysses_world"))
    return torch_runner_fns.run_world(torch_runner_fns.ring_rank, WORLD, out_dir, (cases,))


def _jax(case):
    mesh = jax_make_mesh({"seq": WORLD}, devices=jax.devices()[:WORLD])
    impl = "xla" if case["impl"] == "plain" else "flash"

    def objective(q, k, v, do):
        out = jax_ulysses(q, k, v, mesh, causal=case["causal"], impl=impl,
                          interpret=impl == "flash")
        return jnp.sum(out * do), out

    (_, out), grads = jax.jit(jax.value_and_grad(objective, (0, 1, 2), has_aux=True))(
        *(jnp.asarray(case[x]) for x in ("q", "k", "v", "do")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(n for n in CASES if n != "kv_heads_indivisible"))
def test_ulysses_matches_jax_outputs_and_gradients(port, name):
    out_tol, grad_tol = (FLASH_OUT_TOL, FLASH_GRAD_TOL) if name.startswith("flash") \
        else (OUT_TOL, GRAD_TOL)
    ref, ref_grads = _jax(_case(name))
    out = np.concatenate([r[name]["out"] for r in port], axis=1)
    assert out.shape == ref.shape
    assert float(np.abs(out - ref).max()) < out_tol
    for key, g in zip(("dq", "dk", "dv"), ref_grads):
        got = np.concatenate([r[name][key] for r in port], axis=1)
        assert float(np.abs(got - g).max()) < grad_tol, key


def test_kv_heads_indivisible_by_the_degree_raise_in_both(port):
    with pytest.raises(ValueError, match="KV-head count \\(1\\) divisible"):
        _jax(_case("kv_heads_indivisible"))
    for r in port:
        assert "KV-head count (1) divisible by the 'seq' degree (2)" in \
            r["kv_heads_indivisible"]["error"]
