"""ViT/CIFAR-10 TPE sweep (examples/vit_cifar_hpo.py on the port): the
Vision Transformer over the same HPO machinery as the ResNet example,
with a Bayesian (TPE) optimizer.

lr, width and patch size are swept (each changes the trained model: the
Trainer runs the model without dropout, so a dropout hparam would be
inert). Patches of 8 or 4 give 17 or 65 tokens, which the attention runs
on its reference path (the flash kernels take 128-tiling sequences), as
in the JAX package.

Run: python -m maggy_tpu_torch.examples.vit_cifar_hpo [--trials 8]
"""

from __future__ import annotations

import argparse

import numpy as np

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.fleet.agent import trial_device
from maggy_tpu_torch.models import ViT, ViTConfig
from maggy_tpu_torch.train import Trainer, adamw, cross_entropy_loss

STEPS = 12


def make_cifar_like(n=512, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    return X, y


X_TRAIN, Y_TRAIN = make_cifar_like()


def train_fn(lr, width, patch, reporter=None):
    # Every swept hparam here (width, patch, and lr through a fresh adamw)
    # changes the trained program, so no two trials share a warm slot.
    cfg = ViTConfig(image_size=32, patch_size=int(patch), channels=3,
                    hidden_dim=int(width), intermediate_dim=2 * int(width),
                    num_layers=2, num_heads=2, num_classes=2)
    trainer = Trainer(
        ViT(cfg, device="meta"), adamw(float(lr)),
        lambda logits, batch: cross_entropy_loss(logits, batch["labels"]),
        device=trial_device()).init(seed=0)
    batch = trainer.place_batch({"inputs": (X_TRAIN,), "labels": Y_TRAIN})
    loss = None
    for i in range(STEPS):
        loss = trainer.step(batch)
        if reporter is not None and i % 4 == 0:
            reporter.broadcast(-loss, step=i)
    return {"metric": -float(loss)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, default=8)
    args = p.parse_args(argv)
    sp = Searchspace(lr=("DOUBLE_LOG", [1e-4, 1e-2]),
                     width=("DISCRETE", [32, 48]),
                     patch=("DISCRETE", [4, 8]))
    config = OptimizationConfig(
        name="vit_cifar_tpe", num_trials=args.trials, optimizer="tpe",
        searchspace=sp, direction="max", num_workers=2, seed=0,
        es_policy="none")
    result = experiment.lagom(train_fn, config)
    print("Best:", result["best_hp"], "->", result["best_val"])
    return result


if __name__ == "__main__":
    main()
