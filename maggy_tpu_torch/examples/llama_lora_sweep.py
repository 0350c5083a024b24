"""Llama LoRA hyperparameter sweep (examples/llama_lora_sweep.py on the
port, BASELINE.md config 5): ASHA over (lora_rank, lora_alpha, lr).

The base model stays frozen (``only_lora`` builds the optimizer over the
adapters alone: no moments for the base's weights) and the loss is
computed vocab-chunked from pre-head activations, never materializing the
[B, S, vocab] logits (``ops/losses.py``). Where the JAX example shards a
trial over every visible device with fsdp, a trial here trains on one
device (``trial_device()``): the port's thread runners run one trial a
device.

The defaults are the JAX example's tiny Llama on 16 x 64 tokens, which
never reaches a flash kernel (head dim 16). At Llama-3-8B's widths, set
the module's settings before ``main``, e.g. (depth cut to fit one card)::

    llama_lora_sweep.CONFIG = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=4)
    llama_lora_sweep.ROWS, llama_lora_sweep.SEQ = 2, 2048
    llama_lora_sweep.VOCAB_CHUNK = 16384
    llama_lora_sweep.CORPUS = llama_lora_sweep.make_corpus(
        seq=2048, vocab=llama_lora_sweep.CONFIG.vocab_size)

Run: python -m maggy_tpu_torch.examples.llama_lora_sweep [--trials 9]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.fleet.agent import trial_device
from maggy_tpu_torch.models import Llama, LlamaConfig
from maggy_tpu_torch.ops.losses import chunked_next_token_loss
from maggy_tpu_torch.optimizers import Asha
from maggy_tpu_torch.train import Trainer, adamw, only_lora

VOCAB = 256
#: The base model: a trial sets its swept lora_rank and lora_alpha.
CONFIG = LlamaConfig.tiny(vocab_size=VOCAB)
#: A step's batch (ROWS x SEQ tokens of CORPUS) and the loss's vocab chunk.
ROWS, SEQ, VOCAB_CHUNK = 16, 64, 128


def make_corpus(n=256, seq=SEQ, seed=0, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(n, seq)).astype(np.int32)


CORPUS = make_corpus()


def train_fn(lora_rank, lora_alpha, lr, budget=1, reporter=None):
    cfg = dataclasses.replace(CONFIG, lora_rank=int(lora_rank), lora_alpha=float(lora_alpha))
    trainer = Trainer(
        Llama(cfg, device="meta"), only_lora(adamw(lr)),
        lambda out, batch: chunked_next_token_loss(
            out[0], out[1], batch["tokens"], vocab_chunk=VOCAB_CHUNK),
        device=trial_device(), train_kwargs={"return_hidden": True},
    ).init(seed=0)
    steps = int(20 * budget)
    loss = None
    for i in range(steps):
        lo = (i * ROWS) % (len(CORPUS) - ROWS)
        batch_tokens = CORPUS[lo:lo + ROWS]
        loss = trainer.step(trainer.place_batch(
            {"inputs": (batch_tokens,), "tokens": batch_tokens}))
        if reporter is not None and i % 5 == 0:
            reporter.broadcast(-loss, step=i)
    return {"metric": -float(loss), "final_loss": float(loss)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=9)
    ap.add_argument("--resource-max", type=float, default=9,
                    help="ASHA top-rung budget (1 = single rung, e.g. for "
                         "smoke runs with few trials)")
    args = ap.parse_args(argv)

    sp = Searchspace(
        lora_rank=("DISCRETE", [4, 8, 16]),
        lora_alpha=("DOUBLE", [4.0, 32.0]),
        lr=("DOUBLE", [1e-4, 3e-3]),
    )
    config = OptimizationConfig(
        name="llama_lora_sweep", num_trials=args.trials,
        optimizer=Asha(reduction_factor=3, resource_min=1,
                       resource_max=args.resource_max, seed=0),
        searchspace=sp, direction="max", num_workers=3, es_policy="none",
        seed=0,
    )
    result = experiment.lagom(train_fn, config)
    print("Best:", result["best_val"], "with", result["best_hp"])
    return result


if __name__ == "__main__":
    main()
