"""ResNet parity: the port's ResNet against maggy_tpu's on the CPU, from
converted Flax params and batch statistics. ResNet-18 and ResNet-50 at
widths 8 and 4, CIFAR and ImageNet stems (the latter's asymmetric 7x7
stride-2 padding and -inf max-pool), eval and train forwards, the running
statistics after a train forward (Flax updates the running variance with
the biased batch variance), and three Trainer steps with
has_aux_collections=True against the JAX Trainer. Every BatchNorm scale and
bias and every running statistic is drawn from numpy first: Flax zeroes the
last scale of each block, which would leave the blocks' convolutions out of
the function. Tolerances: fp32 on both sides, sums in another order
(XLA's convolutions against oneDNN's). Eval logits: 1e-5 relative to the
largest (measured: 5e-7 at most). Train-mode forwards: 1e-3 relative to
the largest logit, and 1e-4 relative to (1 + the largest value) on the
running statistics, because the batch variance E[x^2] - E[x]^2 over the
few values of the late stages (n = 8 behind the ImageNet stem) loses
digits to cancellation in fp32, and more so on the JAX side: on
ResNet-50 at 32 x 32 behind that stem, its logits are 3.3e-3 off a float64
evaluation of the same function, the port's 9.7e-4, and the two 4.3e-4
apart relative to the largest logit (2.0e-5 on the statistics). Over three
steps: 1e-5 relative on the loss, 1e-4 on parameters and statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from maggy_tpu.models.resnet import ResNet as JaxResNet
from maggy_tpu.parallel import make_mesh
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train import cross_entropy_loss as jax_xent

from maggy_tpu_torch.models import ResNet
from maggy_tpu_torch.models.resnet import (STAGE_SIZES, BasicBlock, BottleneckBlock,
                                           flax_to_state_dict, same_padding)
from maggy_tpu_torch.train import Trainer, adamw, cross_entropy_loss

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]

EVAL_RTOL = 1e-5
TRAIN_RTOL = 1e-3
STAT_RTOL = 1e-4
STEP_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six files
    at once on the machine's cores, beside timing-bound tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# (depth, width, side, cifar_stem): the ImageNet stem on 16 x 16 pads its
# 7x7 stride-2 conv (2, 3) and its max-pool (0, 1); ResNet-50's first block
# projects (width -> 4 x width) at stride 1.
CASES = [(18, 8, 32, True), (18, 8, 16, False), (50, 4, 16, True), (50, 4, 32, False)]


def _images(n, side, seed):
    return np.random.default_rng(seed).normal(size=(n, side, side, 3)).astype(np.float32)


def _randomized(variables, seed):
    """Flax variables with every BatchNorm scale, bias and running mean
    drawn from numpy and each running variance positive."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        key = path[-1].key
        if key in ("scale", "bias", "mean"):
            return rng.normal(0.0, 0.5, size=x.shape).astype(np.float32) + (key == "scale")
        if key == "var":
            return rng.uniform(0.5, 2.0, size=x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _pair(depth, width, side, cifar_stem, seed=0):
    """(Flax model, its randomized variables, the port model holding them)."""
    jax_model = JaxResNet(depth=depth, num_classes=10, width=width, cifar_stem=cifar_stem)
    variables = jax.jit(jax_model.init)(jax.random.key(0), jnp.zeros((1, side, side, 3)))
    variables = _randomized(variables, seed)
    model = ResNet(depth=depth, num_classes=10, width=width, cifar_stem=cifar_stem,
                   device="cpu")
    model.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
    return jax_model, variables, model


def _buffers(model):
    return {k: v.numpy().copy() for k, v in model.named_buffers()}


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _stat_tol(ref):
    return STAT_RTOL * (1.0 + float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("n, k, s", [(32, 3, 2), (16, 3, 2), (224, 7, 2), (16, 7, 2),
                                     (112, 3, 2), (8, 3, 2), (7, 3, 2), (32, 3, 1),
                                     (32, 1, 2), (15, 1, 2), (1, 3, 2)])
def test_same_padding_matches_lax(n, k, s):
    assert same_padding(n, k, s) == tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


def test_stride2_conv_pads_like_flax_not_like_torch():
    """A 3x3 stride-2 conv on 32 x 32: Flax pads (0, 1), ``padding=1`` pads
    (1, 1). The shapes agree; the values do not."""
    x = _images(1, 32, 3)
    kernel = np.random.default_rng(4).normal(size=(3, 3, 3, 5)).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    from maggy_tpu_torch.models.resnet import Conv

    conv = Conv(3, 5, 3, 2, torch.float32, "cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        ours = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        torch_pad = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), conv.weight, stride=2,
                             padding=1).permute(0, 2, 3, 1).numpy()
    assert ours.shape == torch_pad.shape == ref.shape == (1, 16, 16, 5)
    assert _maxdiff(ours, ref) < 1e-4
    assert _maxdiff(torch_pad, ref) > 1e-1


@pytest.mark.parametrize("depth, width, side, cifar_stem", CASES)
def test_forward_and_running_statistics_match_flax(depth, width, side, cifar_stem):
    jax_model, variables, model = _pair(depth, width, side, cifar_stem)
    x = _images(8, side, seed=depth + side)
    # Eval: the running statistics normalize.
    ref = np.asarray(jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        out = model(torch.from_numpy(x), train=False).numpy()
    assert out.shape == (8, 10)
    np.testing.assert_allclose(out, ref, rtol=0, atol=EVAL_RTOL * np.abs(ref).max())
    # Train: the batch's statistics normalize, and the running ones move.
    ref, updates = jax.jit(lambda v, x: jax_model.apply(v, x, train=True,
                                                        mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        out = model(torch.from_numpy(x), train=True).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0,
                               atol=TRAIN_RTOL * np.abs(np.asarray(ref)).max())
    stats = flax_to_state_dict(variables["params"], updates["batch_stats"])
    buffers = _buffers(model)
    assert set(buffers) == {k for k in stats if k.endswith((".mean", ".var"))}
    for name, value in buffers.items():
        assert _maxdiff(value, stats[name]) < _stat_tol(stats[name]), name


def test_running_variance_is_the_biased_batch_variance():
    """The stem's running variance after one train forward at n = B*H*W = 32
    is Flax's (biased); PyTorch's batch_norm, which updates with the
    unbiased variance (n / (n - 1), 3% here), misses it."""
    jax_model, variables, model = _pair(18, 8, 4, True)
    x = _images(2, 4, seed=9)
    _, updates = jax.jit(lambda v, x: jax_model.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    flax_var = np.asarray(updates["batch_stats"]["BatchNorm_0"]["var"])
    norm = model.stem_norm
    mean0, var0 = norm.mean.clone(), norm.var.clone()
    with torch.no_grad():
        conv_out = model.stem(torch.from_numpy(x).permute(0, 3, 1, 2))
        model(torch.from_numpy(x), train=True)
        F.batch_norm(conv_out, mean0, var0, norm.scale, norm.bias, training=True,
                     momentum=0.1, eps=1e-5)
    assert _maxdiff(norm.var.numpy(), flax_var) < _stat_tol(flax_var)
    assert _maxdiff(var0.numpy(), flax_var) > 10 * _stat_tol(flax_var)


def test_cuda_default_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ResNet(depth=18, num_classes=2, width=8)


def test_immutable_buffers_refuse_a_train_forward_as_flax_does():
    jax_model, variables, model = _pair(18, 8, 16, True)
    x = _images(1, 16, seed=1)
    with pytest.raises(Exception):
        jax_model.apply(variables, x, train=True)
    from maggy_tpu_torch.models.variables import mutable_buffers

    with mutable_buffers(False), pytest.raises(ValueError, match="has_aux_collections"):
        model(torch.from_numpy(x), train=True)


@pytest.mark.parametrize("depth, width", [(18, 8), (50, 4)])
def test_state_dict_layout_and_init_follow_flax(depth, width):
    """flax_to_state_dict covers the port's state_dict exactly (strict
    load) and round-trips; init_weights draws Flax's initializers: unit
    scales but each block's last, zero biases, lecun_normal kernels, and
    the running statistics at 0 and 1."""
    jax_model = JaxResNet(depth=depth, num_classes=10, width=width)
    variables = jax.jit(jax_model.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 3)))
    ref = flax_to_state_dict(variables["params"], variables["batch_stats"])
    model = ResNet(depth=depth, num_classes=10, width=width, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    model.load_state_dict(ref, strict=True)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in ref.items())
    block_cls = STAGE_SIZES[depth][1]
    last = "norms.{}".format(1 if block_cls is BasicBlock else 2)
    for name, p in state.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "mean", "var", "bias"):
            assert torch.equal(p, ref[name]), name  # constants: 0, 1, or 0 for the last scale
            if leaf == "scale":
                assert float(p.max()) == (0.0 if last + ".scale" in name else 1.0), name
        else:
            fan_in = p[0].numel()
            assert abs(float(p.std()) * np.sqrt(fan_in) - 1.0) < 0.35, name
    assert isinstance(model.blocks[0], block_cls) and block_cls in (BasicBlock, BottleneckBlock)


def _loss(logits, batch):
    return cross_entropy_loss(logits, batch["labels"])


@pytest.mark.parametrize("depth, width, side, cifar_stem, randomized",
                         [(18, 8, 16, True, True), (50, 4, 16, True, False)])
def test_three_trainer_steps_with_batch_stats_match_jax(depth, width, side, cifar_stem,
                                                        randomized):
    """examples/resnet_cifar_asha.py's trainer at small width: AdamW with
    weight decay, has_aux_collections=True, train=True; losses, parameters
    and running statistics after three steps against the JAX Trainer.
    ResNet-50 starts from Flax's own init (the example's): from the
    randomized statistics its batch-4 gradients in the last stage are
    ill-conditioned, and the JAX package's fp32 gradients there were
    measured 2-5% off a float64 evaluation of the same function where the
    port's were 2e-5 off, which AdamW's first (sign-like) update turns into
    lr-sized parameter differences. The ImageNet stem is held in the
    forward tests: behind it the last stages normalize over B values."""
    lr, wd, steps = 1e-3, 1e-4, 3
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    kw = dict(depth=depth, num_classes=2, width=width, cifar_stem=cifar_stem)
    jtrainer = JaxTrainer(JaxResNet(**kw),
                          optax.adamw(lr, weight_decay=wd),
                          lambda logits, b: jax_xent(logits, b["labels"]), mesh,
                          has_aux_collections=True, train_kwargs={"train": True},
                          warm_start=False)
    jtrainer.init(jax.random.key(0), (jnp.zeros((1, side, side, 3)),),
                  init_kwargs={"train": True})
    if randomized:
        jtrainer.variables = jax.tree_util.tree_map(jnp.asarray,
                                                    _randomized(jtrainer.variables, 3))
    v = jtrainer.variables
    trainer = Trainer(ResNet(device="cpu", **kw),
                      adamw(lr, weight_decay=wd), _loss, device="cpu",
                      has_aux_collections=True, train_kwargs={"train": True}).init(
        state_dict=flax_to_state_dict(v["params"], v["batch_stats"]))
    rng = np.random.default_rng(5)
    for step in range(steps):
        x = rng.normal(size=(4, side, side, 3)).astype(np.float32)
        y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
        jloss = float(jtrainer.step(jtrainer.place_batch(
            {"inputs": (jnp.asarray(x),), "labels": jnp.asarray(y)})))
        loss = float(trainer.step({"inputs": (torch.from_numpy(x),),
                                   "labels": torch.from_numpy(y)}))
        assert loss == pytest.approx(jloss, rel=1e-5), step
    assert trainer.aux_loss is None
    v = jtrainer.variables
    ref = flax_to_state_dict(v["params"], v["batch_stats"])
    for name, value in trainer.model.state_dict().items():
        assert _maxdiff(value.numpy(), ref[name]) < STEP_TOL, name


def test_warm_hit_after_a_stepped_trial_reinitializes_buffers_in_place():
    """A second trial of a swept ResNet program takes the unit the first
    retired after three train steps: right after init its parameters and
    running statistics (mean 0, variance 1) are bitwise a cold build's,
    the buffers are the same tensors the unit's step read (a captured
    step would go on updating a reassigned buffer's old tensor), and its
    three steps' losses and statistics are bitwise the cold trial's."""
    from maggy_tpu_torch.train import clear_warm, swept_transform, warm

    clear_warm()

    def trainer(lr, warm_start=None):
        return Trainer(ResNet(depth=18, num_classes=2, width=4, device="meta"),
                       swept_transform(adamw, learning_rate=lr, weight_decay=1e-4), _loss,
                       device="cpu", has_aux_collections=True, train_kwargs={"train": True},
                       warm_start=warm_start)

    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
        batches.append({"inputs": (torch.from_numpy(x),),
                        "labels": torch.from_numpy((x.mean(axis=(1, 2, 3)) > 0).astype(np.int64))})
    try:
        first = trainer(3e-3).init(seed=1)
        for b in batches:
            first.step(b)
        buffers = [b.data_ptr() for b in first.model.buffers()]
        assert any(float(b.abs().sum()) not in (0.0, float(b.numel())) for b in first.model.buffers())
        first.retire_to_warm_cache()
        hits = warm.counters()["warm_hits"]
        hot = trainer(1e-3).init(seed=0)
        assert warm.counters()["warm_hits"] == hits + 1
        assert [b.data_ptr() for b in hot.model.buffers()] == buffers
        cold = trainer(1e-3, warm_start=False).init(seed=0)
        for (name, a), b in zip(hot.model.state_dict().items(), cold.model.state_dict().values()):
            assert torch.equal(a, b), name
        for name, buf in hot.model.named_buffers():
            assert torch.equal(buf, torch.zeros_like(buf) if name.endswith("mean")
                               else torch.ones_like(buf)), name
        for b in batches:
            assert torch.equal(hot.step(b), cold.step(b))
        for (name, a), b in zip(hot.model.state_dict().items(), cold.model.state_dict().values()):
            assert torch.equal(a, b), name
    finally:
        clear_warm()


def test_has_aux_collections_joins_the_program_key():
    from maggy_tpu_torch.train import clear_warm, swept_transform

    clear_warm()
    try:
        def slot(aux):
            return Trainer(ResNet(depth=18, num_classes=2, width=4, device="meta"),
                           swept_transform(adamw, learning_rate=1e-3), _loss, device="cpu",
                           has_aux_collections=aux, train_kwargs={"train": True})._slot

        with_aux, without = slot(True), slot(False)
        assert with_aux is not without and with_aux.key != without.key
        assert slot(True) is with_aux
    finally:
        clear_warm()
