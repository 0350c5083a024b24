"""The MNIST slice of the port against maggy_tpu on the CPU: MnistCNN and
MnistMLP on converted Flax params, ``adam`` against ``optax.adam``, the
input pipeline's index sequences, and a few Trainer steps of the bench
headline's CNN through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maggy_tpu.models import MnistCNN as JaxMnistCNN
from maggy_tpu.models import MnistMLP as JaxMnistMLP
from maggy_tpu.parallel import make_mesh
from maggy_tpu.train import ShardedBatchIterator as JaxIterator
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train import cross_entropy_loss as jax_xent
from maggy_tpu.train.data import prefetch_iterator as jax_prefetch_iterator

from maggy_tpu_torch.models import MnistCNN, MnistMLP
from maggy_tpu_torch.models.mnist_cnn import flax_to_state_dict
from maggy_tpu_torch.train import (ShardedBatchIterator, Trainer, adam, cross_entropy_loss,
                                   prefetch_iterator)

# Each test bounded; the Trainer test sets its own, longer bound.
pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

#: fp32 on both sides; the sums run in another order (XLA's convolutions
#: and products against oneDNN's), a few ulps of unit-scale logits.
LOGIT_TOL = 1e-5


def _images(n, side, seed):
    return np.random.default_rng(seed).normal(size=(n, side, side, 1)).astype(np.float32)


def _converted(jax_model, model, side):
    params = jax_model.init(jax.random.key(0), jnp.zeros((1, side, side, 1)))["params"]
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return params


@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("pool", [2, 3])
@pytest.mark.parametrize("side", [28, 16])
def test_cnn_logits_match_flax(kernel, pool, side):
    kw = dict(kernel_size=kernel, pool_size=pool, dropout=0.25, features=16, num_classes=10)
    jax_model = JaxMnistCNN(**kw)
    model = MnistCNN(image_size=side, device="cpu", **kw)
    params = _converted(jax_model, model, side)
    x = _images(8, side, seed=kernel + pool + side)
    ref = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = model(torch.from_numpy(x), train=False).numpy()
    assert out.shape == (8, 10)
    np.testing.assert_allclose(out, ref, rtol=0, atol=LOGIT_TOL)


def test_mlp_logits_match_flax():
    jax_model = JaxMnistMLP(features=8, num_classes=2)
    model = MnistMLP(features=8, num_classes=2, image_size=16, device="cpu")
    params = _converted(jax_model, model, 16)
    x = _images(8, 16, seed=1)
    ref = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=LOGIT_TOL)


def test_init_weights_follow_flax_shapes_and_scales():
    model = MnistCNN(kernel_size=3, pool_size=2, features=16, num_classes=2, image_size=16,
                     device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    params = JaxMnistCNN(kernel_size=3, pool_size=2, features=16, num_classes=2).init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 1)))["params"]
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for name, p in state.items():
        if name.endswith("bias"):
            assert not p.any()
        else:  # lecun_normal: std sqrt(1 / fan_in), within sampling error
            fan_in = p[0].numel()
            assert abs(float(p.std()) * np.sqrt(fan_in) - 1.0) < 0.2, name
            assert float(p.abs().max()) <= 2 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6


def test_two_adam_steps_match_optax():
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(2)]
    tx = optax.adam(3e-3)
    w, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, sched = adam(3e-3)([p])
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shard_count, current_shard", [(1, 0), (3, 0), (3, 2)])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_index_sequences_match_maggy_tpu(shard_count, current_shard, drop_remainder,
                                               shuffle):
    data = {"i": np.arange(103), "x": np.arange(103, dtype=np.float32) * 2}
    kw = dict(batch_size=8, shard_count=shard_count, current_shard=current_shard,
              shuffle=shuffle, seed=5, drop_remainder=drop_remainder, epochs=3)
    ref = [b["i"].tolist() for b in JaxIterator(data, **kw)]
    it = ShardedBatchIterator(data, **kw)
    ours = [b["i"].tolist() for b in it]
    assert ours == ref and len(it) == len(ref) == len(JaxIterator(data, **kw))
    # Placed on a device (here the CPU), through the prefetch thread.
    placed = list(ShardedBatchIterator(data, device="cpu", prefetch=2, **kw))
    assert [b["i"].tolist() for b in placed] == ref
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
               for b in placed)


@pytest.mark.parametrize("fn", [prefetch_iterator, jax_prefetch_iterator])
def test_prefetch_iterator_reraises_a_producer_error(fn):
    def source():
        yield 1
        yield 2
        raise KeyError("producer failed")

    got = []
    with pytest.raises(KeyError, match="producer failed"):
        for item in fn(source(), size=1):
            got.append(item)
    assert got == [1, 2]
    with pytest.raises(ValueError):
        next(fn(iter([]), size=0))


@pytest.mark.timeout(120)
def test_trainer_steps_of_the_bench_cnn_match_maggy_tpu():
    """bench.py's headline trial (MnistCNN(3, 2, features 16, 2 classes) on
    16 x 16 inputs, adam) for five steps through both packages' Trainer and
    input pipeline, from the same converted params: the same losses."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 16, 16, 1)).astype(np.float32)
    y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    kw = dict(kernel_size=3, pool_size=2, features=16, num_classes=2)
    lr, steps = 3e-3, 5
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(JaxMnistCNN(**kw), optax.adam(lr),
                          lambda logits, b: jax_xent(logits, b["labels"]), mesh,
                          strategy="dp", warm_start=False)
    jtrainer.init(jax.random.key(0), (jnp.zeros((1, 16, 16, 1)),))
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jtrainer.variables["params"]))
    trainer = Trainer(MnistCNN(image_size=16, device="cpu", **kw), adam(lr),
                      lambda logits, b: cross_entropy_loss(logits, b["labels"]),
                      device="cpu").init(state_dict=state)
    jit = iter(JaxIterator({"x": X, "y": y}, batch_size=32, epochs=None, seed=1))
    it = iter(ShardedBatchIterator({"x": X, "y": y}, batch_size=32, epochs=None, seed=1,
                                   device="cpu"))
    for step in range(steps):
        jb, b = next(jit), next(it)
        jloss = float(jtrainer.step(jtrainer.place_batch(
            {"inputs": (jnp.asarray(jb["x"]),), "labels": jnp.asarray(jb["y"])})))
        loss = float(trainer.step({"inputs": (b["x"],), "labels": b["y"]}))
        assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-6), step
