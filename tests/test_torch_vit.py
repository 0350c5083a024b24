"""ViT parity: the port's ViT against maggy_tpu's on the CPU, from
converted Flax params: ViTConfig.tiny() logits in fp32 and in bf16, three
Trainer steps against the JAX Trainer (examples/vit_cifar_hpo.py's AdamW),
the wrong-size ValueError, the initializers, and that neither package can
send a ViT's attention to the flash kernels: (n / p)^2 + 1 tokens never
tile by 128. Tolerances: fp32 logits 1e-5 relative to the largest (sums
in another order), bf16 logits 3e-2 relative (the residual stream,
products and attention probabilities rounded to bf16 at other places on
the two sides: a few roundings of 2^-8), the losses of three fp32 steps
1e-5 relative."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import maggy_tpu.ops.attention as jax_attention
from maggy_tpu.models.vit import ViT as JaxViT
from maggy_tpu.models.vit import ViTConfig as JaxViTConfig
from maggy_tpu.parallel import make_mesh
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train import cross_entropy_loss as jax_xent

from maggy_tpu_torch.models import ViT, ViTConfig
from maggy_tpu_torch.models.vit import flax_to_state_dict
from maggy_tpu_torch.ops.attention import multi_head_attention
from maggy_tpu_torch.train import Trainer, adamw, cross_entropy_loss

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]

FP32_RTOL = 1e-5
BF16_RTOL = 3e-2
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six files
    at once on the machine's cores, beside timing-bound tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(dtype=torch.float32, **overrides):
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    tiny = dataclasses.asdict(JaxViTConfig.tiny(num_classes=10))
    tiny.update(overrides, dtype=jdtype)
    jcfg = JaxViTConfig(**tiny)
    tiny.update(dtype=dtype, param_dtype=torch.float32)
    return jcfg, ViTConfig(**tiny)


def _images(n, side, seed):
    return np.random.default_rng(seed).normal(size=(n, side, side, 3)).astype(np.float32)


def _flax_params(jcfg, seed=0):
    """Flax init with the CLS token and every bias drawn from numpy (Flax
    zeroes them, which would leave them out of the comparison)."""
    side = jcfg.image_size
    variables = jax.jit(JaxViT(jcfg).init)(jax.random.key(seed), jnp.zeros((1, side, side, 3)))
    rng = np.random.default_rng(seed + 1)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key in ("cls_token", "bias"):
            return rng.normal(0.0, 0.1, size=x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, nn.meta.unbox(variables)["params"])


@pytest.mark.parametrize("dtype, rtol", [(torch.float32, FP32_RTOL),
                                         (torch.bfloat16, BF16_RTOL)])
def test_tiny_logits_match_flax(dtype, rtol):
    jcfg, tcfg = _configs(dtype)
    params = _flax_params(jcfg)
    x = _images(4, jcfg.image_size, seed=2)
    ref = np.asarray(jax.jit(JaxViT(jcfg).apply)({"params": params}, jnp.asarray(x)))
    model = ViT(tcfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (4, 10)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=rtol * np.abs(ref).max())


def test_three_trainer_steps_match_jax():
    lr, steps = 3e-3, 3
    jcfg, tcfg = _configs()
    params = _flax_params(jcfg)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(JaxViT(jcfg), optax.adamw(lr),
                          lambda logits, b: jax_xent(logits, b["labels"]), mesh,
                          warm_start=False)
    jtrainer.init(jax.random.key(0), (jnp.zeros((1, 32, 32, 3)),))
    jtrainer.variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    trainer = Trainer(ViT(tcfg, device="cpu"), adamw(lr),
                      lambda logits, b: cross_entropy_loss(logits, b["labels"]),
                      device="cpu").init(state_dict=flax_to_state_dict(params))
    for step in range(steps):
        x = _images(8, 32, seed=10 + step)
        y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
        jloss = float(jtrainer.step(jtrainer.place_batch(
            {"inputs": (jnp.asarray(x),), "labels": jnp.asarray(y)})))
        loss = float(trainer.step({"inputs": (torch.from_numpy(x),),
                                   "labels": torch.from_numpy(y)}))
        assert loss == pytest.approx(jloss, rel=LOSS_RTOL), step
    after = flax_to_state_dict(jtrainer.variables["params"])
    for name, p in trainer.model.named_parameters():
        assert float((p.detach() - after[name]).abs().max()) < 1e-4, name


def test_wrong_image_size_raises_as_in_jax():
    jcfg, tcfg = _configs()
    x = _images(1, 24, seed=0)
    with pytest.raises(ValueError, match="Expected 32x32 images, got 24x24"):
        JaxViT(jcfg).init(jax.random.key(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="Expected 32x32 images, got 24x24"):
        ViT(tcfg, device="cpu")(torch.from_numpy(x))


def test_state_dict_layout_and_init_follow_flax():
    jcfg, tcfg = _configs()
    variables = jax.jit(JaxViT(jcfg).init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    ref = flax_to_state_dict(nn.meta.unbox(variables)["params"])
    model = ViT(tcfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for name, p in state.items():
        if p.ndim == 1 or name == "cls_token":  # biases, LayerNorms, CLS: constants
            assert torch.equal(p, ref[name]), name
        else:  # normal(0.02)
            assert abs(float(p.std()) / 0.02 - 1.0) < 0.2, name
    assert not state["cls_token"].any()


def test_cuda_default_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ViT(ViTConfig.tiny())


@pytest.mark.parametrize("cfg", [ViTConfig.tiny(), ViTConfig.base(),
                                 ViTConfig(image_size=384, patch_size=16)])
def test_vit_attention_takes_the_reference_path_in_both_packages(cfg, monkeypatch):
    """(n / p)^2 + 1 tokens never tile by 128, so both gates refuse the
    flash kernels for a ViT's attention shape; and the JAX package's
    dispatch, told it runs on a TPU whose kernel compiles, still sends a
    tiny ViT to its reference path."""
    S = cfg.num_patches + 1
    head_dim = cfg.hidden_dim // cfg.num_heads
    assert S % 128 != 0
    q = np.random.default_rng(0).normal(size=(1, S, cfg.num_heads, head_dim)).astype(np.float32)
    mask = np.ones((1, 1, 1, S), bool)
    with pytest.raises(ValueError, match="128-tiling"):
        multi_head_attention(*(torch.from_numpy(q),) * 3, causal=False,
                             mask=torch.from_numpy(mask), force="flash")
    with pytest.raises(ValueError, match="128-tiling"):
        jax_attention.multi_head_attention(*(jnp.asarray(q),) * 3, causal=False,
                                           mask=jnp.asarray(mask), force="flash")
    if cfg == ViTConfig.tiny():
        def refuse(*args, **kwargs):
            raise AssertionError("a ViT reached the flash kernel")

        monkeypatch.setattr(jax_attention, "_tpu_backend", lambda: True)
        monkeypatch.setattr(jax_attention, "_flash_compiles", lambda *a, **k: True)
        monkeypatch.setattr(jax_attention, "flash_attention", refuse)
        jcfg, _ = _configs()
        x = jnp.asarray(_images(1, 32, seed=0))
        JaxViT(jcfg).init(jax.random.key(0), x)
