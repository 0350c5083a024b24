"""BERT parity: Flax params converted into the port, logits and five
AdamW + warmup-cosine training steps against the JAX package, on a D=64
config (hidden 128, two heads, two layers) computing in fp32."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maggy_tpu.models.bert import BertConfig as JaxBertConfig
from maggy_tpu.models.bert import BertEncoder as JaxBertEncoder
from maggy_tpu.parallel import make_mesh
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train import cross_entropy_loss as jax_ce
from maggy_tpu_torch.models import BertConfig, BertEncoder, flax_to_state_dict
from maggy_tpu_torch.train import (Trainer, adamw, cross_entropy_loss,
                                   warmup_cosine_decay_schedule)

pytestmark = pytest.mark.torch

B, S = 4, 128
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-4


def _configs():
    fields = dict(vocab_size=128, hidden_dim=128, intermediate_dim=256, num_layers=2,
                  num_heads=2, max_seq_len=256, num_classes=2, dropout=0.0)
    return (JaxBertConfig(dtype=jnp.float32, **fields),
            BertConfig(dtype=torch.float32, **fields))


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, 128, size=(n, S)).astype(np.int32)
    lens = rng.integers(16, S + 1, size=n)
    mask = np.arange(S)[None, :] < lens[:, None]
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    return tokens, mask, labels


def _flax_params(jcfg):
    variables = JaxBertEncoder(jcfg).init(jax.random.key(0), jnp.ones((1, S), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(variables)["params"])


def test_converted_logits_match_flax():
    jcfg, tcfg = _configs()
    params = _flax_params(jcfg)
    tokens, mask, _ = _batch(1)
    ref = np.asarray(JaxBertEncoder(jcfg).apply({"params": params}, jnp.asarray(tokens),
                                                jnp.asarray(mask)))
    model = BertEncoder(tcfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        out = model(torch.as_tensor(tokens, dtype=torch.long), torch.as_tensor(mask))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert float(np.abs(out.numpy() - ref).max()) < LOGIT_TOL


def test_schedule_matches_optax():
    for warmup in (0, 3):
        ours = warmup_cosine_decay_schedule(0.0, 1e-3, warmup, 12)
        ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, 12)
        for step in range(16):
            # optax evaluates in float32 (about 1e-7 relative per op).
            assert ours(step) == pytest.approx(float(ref(step)), rel=1e-5, abs=1e-12)


def test_five_trainer_steps_match_jax_trainer():
    jcfg, tcfg = _configs()
    lr, warmup, total = 5e-4, 2, 5
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(
        JaxBertEncoder(jcfg),
        optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)),
        lambda logits, b: jax_ce(logits, b["labels"]), mesh, warm_start=False)
    jtrainer.init(jax.random.key(0), (jnp.ones((1, S), jnp.int32),))
    params = jax.tree_util.tree_map(np.asarray, jtrainer.variables["params"])

    trainer = Trainer(BertEncoder(tcfg, device="cpu"),
                      adamw(warmup_cosine_decay_schedule(0.0, lr, warmup, total)),
                      lambda logits, b: cross_entropy_loss(logits, b["labels"]),
                      device="cpu").init(state_dict=flax_to_state_dict(params))
    for step in range(total):
        tokens, mask, labels = _batch(10 + step)
        jloss = float(jtrainer.step(jtrainer.place_batch(
            {"inputs": (tokens, mask), "labels": labels})))
        loss = float(trainer.step(trainer.place_batch(
            {"inputs": (tokens.astype(np.int64), mask), "labels": labels})))
        assert loss == pytest.approx(jloss, rel=LOSS_RTOL), step


def test_cuda_default_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BertEncoder(_configs()[1])
