"""Ring attention: the port on a 4-rank gloo world of CPU processes against
the JAX package's ``ring_attention`` on a {"seq": 4} mesh of the virtual
CPU devices.

Inputs come from numpy with a seed; every rank takes its sequence shard of
the same global arrays, and the shards of the port's output and gradients
(of sum(out * dO)) are put back together and compared with the global JAX
arrays. Plain path (JAX "xla"): causal and full attention with GQA, output
within 1e-5 and gradients within 1e-4 (fp32, sums in another order). Flash
path at S/n = 128, D = 64: the port's ring Function over its flash kernels'
plain versions against the JAX ring over the Pallas kernels in interpret
mode, within the flash parity tolerances of tests/test_torch_attention.py
(1e-4 forward, 1e-3 gradients). The ranks run in one world a module,
started by a module fixture (``torch_runner_fns.run_world``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_runner_fns
from maggy_tpu.parallel import make_mesh as jax_make_mesh
from maggy_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from maggy_tpu_torch.parallel import ring_attention, split_sequence

pytestmark = [pytest.mark.torch, pytest.mark.timeout(150)]

WORLD = 4
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
FLASH_OUT_TOL, FLASH_GRAD_TOL = 1e-4, 1e-3

# name -> (B, S, H, Hkv, D, causal, impl)
CASES = {
    "plain_causal_gqa": (2, 64, 4, 2, 16, True, "plain"),
    "plain_full_gqa": (2, 64, 4, 2, 16, False, "plain"),
    "plain_causal_mha": (1, 32, 2, 2, 8, True, "plain"),
    "flash_causal_gqa": (1, 512, 4, 2, 64, True, "flash"),
    "flash_full_gqa": (1, 512, 2, 1, 64, False, "flash"),
}


def _inputs(B, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return {"q": rng.normal(size=(B, S, H, D)).astype(np.float32),
            "k": rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            "v": rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            "do": rng.normal(size=(B, S, H, D)).astype(np.float32)}


def _case(name):
    B, S, H, Hkv, D, causal, impl = CASES[name]
    return {**_inputs(B, S, H, Hkv, D, seed=sorted(CASES).index(name)), "causal": causal,
            "impl": impl, "fn": "ring"}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases = {name: _case(name) for name in CASES}
    out_dir = str(tmp_path_factory.mktemp("ring_world"))
    return torch_runner_fns.run_world(torch_runner_fns.ring_rank, WORLD, out_dir, (cases,))


def _gathered(port, name, key):
    return np.concatenate([r[name][key] for r in port], axis=1)


def _jax(name):
    case = _case(name)
    mesh = jax_make_mesh({"seq": WORLD}, devices=jax.devices()[:WORLD])
    impl = "xla" if case["impl"] == "plain" else "flash"

    def fn(q, k, v):
        return jax_ring_attention(q, k, v, mesh, causal=case["causal"], impl=impl,
                                  interpret=impl == "flash")

    def objective(q, k, v, do):
        out = fn(q, k, v)
        return jnp.sum(out * do), out

    # One compile for the output and the gradients.
    (_, out), grads = jax.jit(jax.value_and_grad(objective, (0, 1, 2), has_aux=True))(
        *(jnp.asarray(case[x]) for x in ("q", "k", "v", "do")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_jax_outputs_and_gradients(port, name):
    out_tol, grad_tol = (FLASH_OUT_TOL, FLASH_GRAD_TOL) if name.startswith("flash") \
        else (OUT_TOL, GRAD_TOL)
    ref, ref_grads = _jax(name)
    out = _gathered(port, name, "out")
    assert out.shape == ref.shape
    assert float(np.abs(out - ref).max()) < out_tol
    for key, g in zip(("dq", "dk", "dv"), ref_grads):
        assert float(np.abs(_gathered(port, name, key) - g).max()) < grad_tol, key


def test_one_rank_ring_is_attention():
    """A ring of one (no group) is plain causal attention, both impls."""
    from maggy_tpu_torch.ops.attention import attention_reference

    case = _inputs(1, 128, 4, 2, 64, seed=3)
    q, k, v = (torch.tensor(case[x]) for x in ("q", "k", "v"))
    ref = attention_reference(q, k, v, causal=True)
    for impl in ("plain", "flash"):
        assert float((ring_attention(q, k, v, None, True, impl) - ref).abs().max()) < 1e-5


def test_errors_match_jax():
    mesh = jax_make_mesh({"seq": WORLD}, devices=jax.devices()[:WORLD])
    x = jnp.zeros((1, 10, 4, 8))
    with pytest.raises(ValueError, match="must divide over 4 'seq' shards"):
        jax_ring_attention(x, x, x, mesh, impl="xla")
    with pytest.raises(ValueError, match="must divide over 4 'seq' shards"):
        split_sequence(torch.zeros(1, 10, 4, 8), WORLD, 0)
    kv = jnp.zeros((1, 16, 3, 8))
    with pytest.raises(ValueError, match="not divisible by Hkv"):
        jax_ring_attention(jnp.zeros((1, 16, 4, 8)), kv, kv, mesh, impl="xla")
    with pytest.raises(ValueError, match="not divisible by Hkv"):
        ring_attention(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 3, 8),
                       torch.zeros(1, 4, 3, 8), None)
    # A flash ring on a shard the kernels do not build raises; it does not
    # fall back to the plain blocks.
    with pytest.raises(ValueError, match="impl='flash' needs S/n divisible by 128"):
        ring_attention(torch.zeros(1, 64, 4, 64), torch.zeros(1, 64, 2, 64),
                       torch.zeros(1, 64, 2, 64), None, impl="flash")
