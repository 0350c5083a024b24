"""BERT GLUE-style fine-tune HPO (examples/bert_glue_hpo.py on the port,
BASELINE.md config 4): TPE over (lr, warmup, batch) with median stopping.

The default model is the JAX example's tiny BERT on 32-token rows, which
never reaches a flash kernel (head dim 16). At BASELINE's widths, set the
module's settings before ``main``::

    bert_glue_hpo.CONFIG = BertConfig.base(num_classes=2)
    bert_glue_hpo.TOKENS, bert_glue_hpo.LABELS = bert_glue_hpo.make_sst_like(seq=128)

and every step's attention runs through the flash kernels (head dim 64,
128 tokens). The model is called without an attention mask, so every key
is kept.

Run: python -m maggy_tpu_torch.examples.bert_glue_hpo [--trials 8]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from maggy_tpu_torch import OptimizationConfig, Searchspace, device_gate, experiment
from maggy_tpu_torch.fleet.agent import trial_device
from maggy_tpu_torch.models import BertConfig, BertEncoder
from maggy_tpu_torch.train import (Trainer, adamw, cross_entropy_loss,
                                   warmup_cosine_decay_schedule)

VOCAB = 128
#: The model: the JAX package's ``BertConfig.tiny(num_classes=2)`` widths.
CONFIG = BertConfig.tiny(num_classes=2, hidden_dim=32, intermediate_dim=64, max_seq_len=64)


def make_sst_like(n=512, seq=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, VOCAB, size=(n, seq)).astype(np.int32)
    # sentiment = whether "positive tokens" (upper half) dominate
    y = (tokens > VOCAB // 2).mean(axis=1) > 0.5
    return tokens, y.astype(np.int32)


TOKENS, LABELS = make_sst_like()


def train_fn(lr, warmup_frac, batch, reporter=None):
    device = trial_device()
    total_steps = 40
    sched = warmup_cosine_decay_schedule(
        0.0, lr, int(total_steps * warmup_frac), total_steps)
    trainer = Trainer(
        BertEncoder(CONFIG, device="meta"), adamw(sched),
        lambda logits, b: cross_entropy_loss(logits, b["labels"]),
        device=device,
    ).init(seed=0)
    loss = None
    for i in range(total_steps):
        lo = (i * batch) % (len(TOKENS) - batch)
        loss = trainer.step(trainer.place_batch(
            {"inputs": (TOKENS[lo:lo + batch],), "labels": LABELS[lo:lo + batch]}))
        if reporter is not None and i % 10 == 0:
            reporter.broadcast(-loss, step=i)
    # The accuracy pass is a step of the process's device gate: no CUDA
    # graph capture of another runner meets it.
    with device_gate.step(), torch.no_grad():
        preds = trainer.model(torch.as_tensor(TOKENS[:256], device=device)).argmax(-1)
    acc = float((preds.cpu() == torch.as_tensor(LABELS[:256]).long()).float().mean())
    return {"metric": acc, "final_loss": float(loss)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=8)
    args = ap.parse_args(argv)

    sp = Searchspace(
        lr=("DOUBLE", [1e-5, 1e-3]),
        warmup_frac=("DOUBLE", [0.0, 0.3]),
        batch=("DISCRETE", [32, 64]),
    )
    config = OptimizationConfig(
        name="bert_glue_hpo", num_trials=args.trials, optimizer="tpe",
        searchspace=sp, direction="max", num_workers=2,
        es_policy="median", es_min=3, seed=0,
    )
    result = experiment.lagom(train_fn, config)
    print("Best accuracy:", result["best_val"], "with", result["best_hp"])
    return result


if __name__ == "__main__":
    main()
