"""Pipeline parallelism (``maggy_tpu_torch/parallel/pipeline.py``) against
the JAX package's ``maggy_tpu/parallel/pipeline.py``, following
``tests/test_parallel_strategies.py:178-306``.

The port's stages are rank processes of a gloo world on the CPU (one stage
a rank): {"pipe": 2} on two ranks and {"pipe": 2, "data": 2} on four. The
JAX functions run on as many of the virtual CPU devices. The same numpy
draws go through both, in fp32:

- ``PipelinedLM.apply`` (JAX params carried across by
  ``pipelined_lm_state``) against JAX's ``apply`` and ``apply_sequential``
  (each rank's rows of each microbatch), within 1e-5;
- tanh stages: GPipe (``pipeline_apply`` and autograd) and
  ``pipeline_1f1b_grads``, loss and each stage's gradient against JAX's
  GPipe ``value_and_grad`` and JAX's 1F1B, loss within rel 1e-5, gradients
  within 1e-5 + rel 1e-4 (JAX's own test: rtol 1e-5 and 1e-4);
- a batch that does not divide into the microbatches raises, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_runner_fns
from maggy_tpu.parallel import make_mesh as jax_make_mesh
from maggy_tpu.parallel.pipeline import PipelinedLM as JaxPipelinedLM
from maggy_tpu.parallel.pipeline import pipeline_1f1b_grads, pipeline_apply

pytestmark = [pytest.mark.torch, pytest.mark.timeout(240)]

LM = (64, 16, 32, 2, 2)  # vocab, hidden, intermediate, stages, layers a stage
OUT_TOL = 1e-5
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, LM[0], size=(B, S)).astype(np.int32)


def _tanh_case(n, M, B, shape, seed):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    return {"w": (rng.normal(size=(n, D, D)) * 0.1).astype(np.float32),
            "x": rng.normal(size=(B,) + shape).astype(np.float32),
            "targets": rng.normal(size=(B,) + shape).astype(np.float32), "M": M}


def _jax_tanh(case, mesh):
    M, x, targets = case["M"], jnp.asarray(case["x"]), jnp.asarray(case["targets"])
    B = x.shape[0]
    sp = {"w": jnp.asarray(case["w"])}

    def stage_fn(p, a):
        return a + jnp.tanh(jnp.dot(a, p["w"]))

    def loss_fn(out, tgt):
        return jnp.mean((out - tgt) ** 2)

    def gpipe_loss(sp):
        y = pipeline_apply(stage_fn, sp, x, mesh, num_microbatches=M)
        y_mb = y.reshape((M, B // M) + y.shape[1:])
        t_mb = targets.reshape((M, B // M) + targets.shape[1:])
        return jnp.mean(jax.vmap(loss_fn)(y_mb, t_mb))

    y = pipeline_apply(stage_fn, sp, x, mesh, num_microbatches=M)
    loss, grads = jax.value_and_grad(gpipe_loss)(sp)
    l1, g1 = pipeline_1f1b_grads(stage_fn, loss_fn, sp, x, targets, mesh, num_microbatches=M)
    return {"out": np.asarray(y), "loss": float(loss), "grad": np.asarray(grads["w"]),
            "loss_1f1b": float(l1), "grad_1f1b": np.asarray(g1["w"])}


def _run(world, mesh_shape, tmp_path_factory, name):
    mesh = jax_make_mesh(mesh_shape, devices=jax.devices()[:world])
    lm = JaxPipelinedLM(*LM, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, lm.init(jax.random.key(0), mesh))
    tokens = _tokens(8, 8, 3)
    lm_ref = {"apply": np.asarray(lm.apply(params, jnp.asarray(tokens), mesh,
                                           num_microbatches=4)),
              "sequential": np.asarray(lm.apply_sequential(params, jnp.asarray(tokens))),
              "grads": jax.tree_util.tree_map(np.asarray, jax.grad(
                  lambda p: jnp.mean(lm.apply_sequential(p, jnp.asarray(tokens)) ** 2))(
                      params)["stages"])}
    tanh = _tanh_case(2, 4, 8, (4, 6), seed=world)
    cases = {"lm": {"mesh": mesh_shape, "lm": LM, "params": params, "tokens": tokens, "M": 4},
             "tanh": {"mesh": mesh_shape, **tanh},
             "bad": {"mesh": mesh_shape, "lm": LM, "params": params, "M": 4,
                     "tokens": _tokens(6, 4, 1)}}
    out_dir = str(tmp_path_factory.mktemp(name))
    ranks = torch_runner_fns.run_world(torch_runner_fns.pipeline_rank, world, out_dir, (cases,))
    return {"lm": lm_ref, "tanh": _jax_tanh(tanh, mesh), "case": tanh}, ranks


@pytest.fixture(scope="module")
def pipe2(tmp_path_factory):
    return _run(2, {"pipe": 2}, tmp_path_factory, "pipe2")


@pytest.fixture(scope="module")
def pipe2_data2(tmp_path_factory):
    return _run(4, {"pipe": 2, "data": 2}, tmp_path_factory, "pipe2_data2")


def _rows(full, M, rank, dp):
    """A rank's rows of each microbatch of the global [B, ...] ``full``."""
    mb = full.reshape((M, -1) + full.shape[1:])
    rows = mb.shape[1] // dp
    d = rank["coord"].get("data", 0)
    return mb[:, d * rows:(d + 1) * rows].reshape((-1,) + full.shape[1:])


@pytest.mark.parametrize("world", ["pipe2", "pipe2_data2"])
def test_pipelined_lm_matches_jax_apply_and_sequential(world, request):
    ref, ranks = request.getfixturevalue(world)
    dp = 2 if world == "pipe2_data2" else 1
    for r in ranks:
        got = r["lm"]["out"]
        for want in (ref["lm"]["apply"], ref["lm"]["sequential"]):
            want = _rows(want, 4, r["lm"], dp)
            assert got.shape == want.shape
            assert float(np.abs(got - want).max()) < OUT_TOL


@pytest.mark.parametrize("world", ["pipe2", "pipe2_data2"])
def test_pipelined_lm_stage_gradients_match_jax(world, request):
    """``PipelinedLM.apply``'s backward (one compute-dtype copy of the stage
    read by every tick) gives each rank its stage's gradient of the JAX
    ``apply_sequential``'s loss."""
    ref, ranks = request.getfixturevalue(world)
    for r in ranks:
        stage = r["lm"]["coord"]["pipe"]
        for k, got in r["lm"]["grads"].items():
            np.testing.assert_allclose(got, ref["lm"]["grads"][k][stage], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("world", ["pipe2", "pipe2_data2"])
def test_gpipe_and_1f1b_match_jax(world, request):
    ref, ranks = request.getfixturevalue(world)
    dp = 2 if world == "pipe2_data2" else 1
    jt = ref["tanh"]
    for r in ranks:
        t = r["tanh"]
        stage = t["coord"]["pipe"]
        assert float(np.abs(t["out"] - _rows(jt["out"], 4, t, dp)).max()) < OUT_TOL
        np.testing.assert_allclose(t["gpipe_loss"], jt["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["loss_1f1b"], jt["loss_1f1b"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["loss_1f1b"], t["gpipe_loss"], rtol=LOSS_RTOL)
        for got in (t["gpipe_grad"], t["grad_1f1b"]):
            np.testing.assert_allclose(got, jt["grad"][stage], rtol=GRAD_RTOL, atol=GRAD_ATOL)
        np.testing.assert_allclose(t["grad_1f1b"], jt["grad_1f1b"][stage], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    # Every rank holds the same loss.
    assert len({r["tanh"]["loss_1f1b"] for r in ranks}) == 1


def test_bad_microbatch_count_raises(pipe2):
    _, ranks = pipe2
    mesh = jax_make_mesh({"pipe": 2}, devices=jax.devices()[:2])
    lm = JaxPipelinedLM(16, 8, 16, 2)
    params = lm.init(jax.random.key(0), mesh)
    with pytest.raises(ValueError, match="microbatch"):
        lm.apply(params, jnp.asarray(_tokens(6, 4, 1) % 16), mesh, num_microbatches=4)
    for r in ranks:
        assert "must divide into 4 microbatches" in r["bad"]["error"]
