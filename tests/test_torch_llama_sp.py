"""Llama's ring path (sequence parallelism): ``tests/test_parallel_strategies.
py:37-65`` through both packages, on a {"data": 2, "seq": 2} mesh — the
port's as a 4-rank gloo world of CPU processes, the JAX package's on 4 of
the virtual CPU devices.

The JAX Trainer (strategy "dp_sp", adam 1e-2, next-token loss) initializes
the weights; ``models/llama.py``'s ``flax_to_state_dict`` carries them to
every rank. Each rank runs the ring Llama on its (batch, sequence) shard:
the gathered logits must match the JAX ring Llama's and its dense Llama's
within the Llama parity tolerance of tests/test_torch_llama.py (1e-4, fp32);
then five mesh-Trainer steps on one batch (labels shifted over the global
sequence, the sharded next-token loss, gradients averaged over data and
seq) must give the JAX Trainer's losses within rel 1e-4, the same loss on
every rank.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_runner_fns
from maggy_tpu.models.llama import Llama as JaxLlama
from maggy_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from maggy_tpu.parallel import make_mesh as jax_make_mesh
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train.trainer import next_token_loss as jax_next_token_loss
from maggy_tpu_torch.models import Llama, LlamaConfig
from maggy_tpu_torch.models.llama import flax_to_state_dict
from maggy_tpu_torch.parallel import make_mesh

pytestmark = [pytest.mark.torch, pytest.mark.timeout(150)]

MESH = {"data": 2, "seq": 2}
WORLD = 4
B, S, VOCAB = 4, 64, 256
FIELDS = dict(vocab_size=VOCAB, hidden_dim=64, intermediate_dim=128, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128, remat=False)
LR, STEPS = 1e-2, 5
OUT_TOL, LOSS_RTOL = 1e-4, 1e-4


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    mesh = jax_make_mesh(MESH, devices=jax.devices()[:WORLD])
    jcfg = dataclasses.replace(JaxLlamaConfig(dtype=jnp.float32, **FIELDS),
                               attention_impl="ring", seq_mesh=mesh)
    trainer = JaxTrainer(JaxLlama(jcfg), optax.adam(LR),
                         lambda logits, batch: jax_next_token_loss(logits, batch["tokens"]),
                         mesh, strategy="dp_sp", warm_start=False)
    trainer.init(jax.random.key(0), (jnp.ones((1, S), jnp.int32),))
    params = jax.tree_util.tree_map(np.asarray, trainer.variables["params"])
    state = flax_to_state_dict(params)
    tokens = _tokens(1)
    dense_cfg = dataclasses.replace(jcfg, attention_impl="auto", seq_mesh=None)
    jax_out = {"ring": np.asarray(JaxLlama(jcfg).apply({"params": params}, jnp.asarray(tokens))),
               "dense": np.asarray(JaxLlama(dense_cfg).apply({"params": params},
                                                             jnp.asarray(tokens)))}
    # The JAX test steps one batch five times: the loss must fall.
    steps = [_tokens(0)] * STEPS
    jax_out["losses"] = [float(trainer.step(trainer.place_batch(
        {"inputs": (t,), "tokens": t}))) for t in steps]
    out_dir = str(tmp_path_factory.mktemp("llama_sp_world"))
    port = torch_runner_fns.run_world(
        torch_runner_fns.llama_sp_rank, WORLD, out_dir,
        (FIELDS, state, tokens, steps, LR, MESH))
    return jax_out, port


def _gathered_logits(port):
    rows = []
    for d in range(MESH["data"]):
        shards = sorted((r for r in port if r["coord"][0] == d), key=lambda r: r["coord"][1])
        rows.append(np.concatenate([r["logits"] for r in shards], axis=1))
    return np.concatenate(rows, axis=0)


def test_ring_llama_matches_dense_llama(both):
    jax_out, port = both
    logits = _gathered_logits(port)
    assert logits.shape == (B, S, VOCAB)
    assert float(np.abs(logits - jax_out["ring"]).max()) < OUT_TOL
    assert float(np.abs(logits - jax_out["dense"]).max()) < OUT_TOL


def test_ring_llama_train_step(both):
    jax_out, port = both
    losses = port[0]["losses"]
    assert all(r["losses"] == losses for r in port)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jax_out["losses"], rtol=LOSS_RTOL)


def test_ring_rejects_explicit_mask_and_needs_a_mesh():
    cfg = dataclasses.replace(LlamaConfig(dtype=torch.float32, **FIELDS),
                              attention_impl="ring", seq_mesh=make_mesh({"seq": 1}, "cpu"))
    model = Llama(cfg, device="cpu")
    x = torch.ones(2, 64, cfg.hidden_dim)
    positions = torch.arange(64).expand(2, 64)
    with pytest.raises(ValueError, match="causal"):
        model.layers[0].attn(x, positions, torch.ones(2, 1, 64, 64, dtype=torch.bool))
    with pytest.raises(ValueError, match="seq_mesh"):
        Llama(dataclasses.replace(cfg, seq_mesh=None), device="cpu")
