"""BatchNorm on a mesh: the port's mesh Trainer normalizes with the
statistics of the global batch, as GSPMD does. A ResNet-18 (width 8, CIFAR
stem, Flax's init) takes two adam steps under "dp" on a 2-rank gloo world
of CPU processes, 4 images a rank, against the JAX Trainer on ONE device
at the global batch of 8 images: the same losses (rel 1e-5) and the same
parameters and running statistics (1e-4 relative to 1 + the largest
value: ``test_torch_resnet.py``'s three-step tolerances). With each rank's
own batch statistics both would differ: the per-rank means and variances
of 4 images are not the global batch's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_runner_fns
from maggy_tpu.models.resnet import ResNet as JaxResNet
from maggy_tpu.parallel import make_mesh
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train import cross_entropy_loss as jax_xent
from maggy_tpu_torch.models.resnet import flax_to_state_dict

pytestmark = [pytest.mark.torch, pytest.mark.timeout(240)]

KW = dict(depth=18, num_classes=2, width=8, cifar_stem=True)
SIDE, B, STEPS, LR = 16, 8, 2, 1e-3
LOSS_RTOL, STEP_TOL = 1e-5, 1e-4


def _batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        x = rng.normal(size=(B, SIDE, SIDE, 3)).astype(np.float32)
        out.append((x, (x.mean(axis=(1, 2, 3)) > 0).astype(np.int64)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(JaxResNet(**KW), optax.adam(LR),
                          lambda logits, b: jax_xent(logits, b["labels"]), mesh,
                          has_aux_collections=True, train_kwargs={"train": True},
                          warm_start=False)
    jtrainer.init(jax.random.key(0), (jnp.zeros((1, SIDE, SIDE, 3)),),
                  init_kwargs={"train": True})
    v = jtrainer.variables
    state = {k: t.numpy() for k, t in flax_to_state_dict(v["params"], v["batch_stats"]).items()}
    batches = _batches()
    jlosses = [float(jtrainer.step(jtrainer.place_batch(
        {"inputs": (jnp.asarray(x),), "labels": jnp.asarray(y.astype(np.int32))})))
        for x, y in batches]
    v = jtrainer.variables
    ref = {k: t.numpy() for k, t in flax_to_state_dict(v["params"], v["batch_stats"]).items()}
    spec = {"dp": dict(model="resnet", fields=KW, state=state, mesh={"data": 2},
                       strategy="dp", lr=LR, aux=True, train_kwargs={"train": True},
                       batches=[{"inputs": (x,), "labels": y} for x, y in batches])}
    ranks = torch_runner_fns.run_world(torch_runner_fns.mesh_train_rank, 2,
                                       str(tmp_path_factory.mktemp("bn")), (spec,))
    return jlosses, ref, ranks


def test_two_rank_dp_losses_equal_one_device_at_the_global_batch(runs):
    jlosses, _, ranks = runs
    assert ranks[0]["dp"]["losses"] == ranks[1]["dp"]["losses"]
    np.testing.assert_allclose(ranks[0]["dp"]["losses"], jlosses, rtol=LOSS_RTOL)
    assert "bn_all_reduce" in ranks[0]["dp"]["traffic"]


def test_two_rank_dp_parameters_and_running_statistics_equal_one_device(runs):
    _, ref, ranks = runs
    for r in ranks:
        state = r["dp"]["state"]
        assert set(state) == set(ref)
        for name, want in ref.items():
            err = float(np.abs(state[name] - want).max())
            assert err < STEP_TOL * (1 + float(np.abs(want).max())), (name, err)
