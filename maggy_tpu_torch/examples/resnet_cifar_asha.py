"""ResNet/CIFAR-10 ASHA sweep (examples/resnet_cifar_asha.py on the port,
BASELINE.md config 3).

Budget-scaled training steps are ASHA's fidelity axis; lr, width and
weight decay are swept. Depth 18 with small widths by default; pass
``--depth 50`` for the baseline's depth. Where the JAX example trains a
trial data-parallel over every visible device, a trial here trains on one
device (``trial_device()``): the port's thread runners run one trial a
device, and ``DistributedConfig`` is its data-parallel path
(``distributed_training``).

Run: python -m maggy_tpu_torch.examples.resnet_cifar_asha [--trials 9]
         [--resource-max 9] [--depth 50]
"""

from __future__ import annotations

import argparse

import numpy as np

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.fleet.agent import trial_device
from maggy_tpu_torch.models import ResNet
from maggy_tpu_torch.optimizers import Asha
from maggy_tpu_torch.train import (ShardedBatchIterator, Trainer, adamw, cross_entropy_loss,
                                   swept_transform)

DEPTH = 18  # overridden by --depth
STEPS_PER_BUDGET = 8


def make_cifar_like(n=1024, seed=0):
    """Synthetic CIFAR stand-in (no dataset ships with the repo; swap in
    real CIFAR-10 arrays if you have them on disk)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    return X, y


X_TRAIN, Y_TRAIN = make_cifar_like()


def loss_fn(logits, batch):
    return cross_entropy_loss(logits, batch["labels"])


def train_fn(lr, width, weight_decay, budget=1, reporter=None):
    """One ASHA trial: budget-scaled ResNet training, BatchNorm statistics
    updated in the step. lr rides the optimizer's learning-rate tensor and
    the loss is module-level, so trials of one width and weight decay
    share a warm slot."""
    device = trial_device()
    model = ResNet(depth=DEPTH, num_classes=2, width=int(width), device="meta")
    trainer = Trainer(
        model, swept_transform(adamw, learning_rate=lr, weight_decay=weight_decay),
        loss_fn, device=device, has_aux_collections=True,
        train_kwargs={"train": True},
    ).init(seed=0)
    it = iter(ShardedBatchIterator({"x": X_TRAIN, "y": Y_TRAIN}, batch_size=128,
                                   epochs=None, seed=1, device=device))
    loss = None
    for step in range(int(STEPS_PER_BUDGET * budget)):
        b = next(it)
        loss = trainer.step({"inputs": (b["x"],), "labels": b["y"]})
        if reporter is not None and step % 2 == 0:
            reporter.broadcast(-loss, step=step)  # read on the heartbeat thread
    return {"metric": -float(loss), "final_loss": float(loss)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=9)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--resource-max", type=float, default=9,
                    help="ASHA top-rung budget (1 = single rung for smoke)")
    ap.add_argument("--depth", type=int, default=18, choices=[18, 50],
                    help="ResNet depth (50 for the full baseline config)")
    args = ap.parse_args(argv)
    global DEPTH
    DEPTH = args.depth

    sp = Searchspace(
        lr=("DOUBLE", [1e-4, 1e-2]),
        width=("DISCRETE", [8, 16, 32]),
        weight_decay=("DOUBLE", [1e-5, 1e-3]),
    )
    config = OptimizationConfig(
        name="resnet_cifar_asha", num_trials=args.trials,
        optimizer=Asha(reduction_factor=3, resource_min=1,
                       resource_max=args.resource_max, seed=0),
        searchspace=sp, direction="max", num_workers=args.workers,
        es_policy="median", es_min=3, seed=0,
    )
    result = experiment.lagom(train_fn, config)
    print("Best:", result["best_val"], "with", result["best_hp"])
    return result


if __name__ == "__main__":
    main()
