"""MNIST CNN random-search HPO (examples/mnist_hpo.py on the port).

Run: python -m maggy_tpu_torch.examples.mnist_hpo [--trials 8] [--workers 4]
"""

from __future__ import annotations

import argparse

import numpy as np

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.fleet.agent import trial_device
from maggy_tpu_torch.models import MnistCNN
from maggy_tpu_torch.train import (ShardedBatchIterator, Trainer, adam, cross_entropy_loss,
                                   swept_transform)


def make_mnist_like(n=4096, seed=0):
    """Synthetic MNIST stand-in (no dataset ships with the repo; swap in
    real MNIST arrays if you have them on disk)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    y = ((X[:, :14].mean(axis=(1, 2, 3)) > X[:, 14:].mean(axis=(1, 2, 3)))
         .astype(np.int32))
    return X, y


X_TRAIN, Y_TRAIN = make_mnist_like()


def loss_fn(logits, batch):
    """Module-level (not a per-trial lambda): the loss joins the warm
    path's program key, so trials that share (kernel, pool, dropout) share
    one warm slot."""
    return cross_entropy_loss(logits, batch["labels"])


def train_fn(kernel, pool, dropout, lr, reporter=None):
    """One trial: train the CNN two epochs, heartbeat the negated loss,
    return it. lr rides the optimizer's learning-rate tensor
    (swept_transform), so only the hparams that change the model build a
    new one."""
    device = trial_device()
    model = MnistCNN(kernel_size=kernel, pool_size=pool, dropout=dropout, num_classes=2,
                     device="meta")
    trainer = Trainer(model, swept_transform(adam, learning_rate=lr), loss_fn,
                      device=device).init(seed=0)
    it = ShardedBatchIterator({"x": X_TRAIN, "y": Y_TRAIN}, batch_size=256, epochs=2, seed=1,
                              device=device)
    for step, b in enumerate(it):
        loss = trainer.step({"inputs": (b["x"],), "labels": b["y"]})
        if reporter is not None and step % 5 == 0:
            reporter.broadcast(-loss, step=step)
    return {"metric": -float(loss), "final_loss": float(loss)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)

    sp = Searchspace(
        kernel=("DISCRETE", [3, 5]),
        pool=("DISCRETE", [2, 3]),
        dropout=("DOUBLE", [0.0, 0.5]),
        lr=("DOUBLE", [1e-4, 1e-2]),
    )
    config = OptimizationConfig(
        name="mnist_hpo", num_trials=args.trials, optimizer="randomsearch",
        searchspace=sp, direction="max", num_workers=args.workers,
        es_policy="median", es_min=3, seed=0,
    )
    result = experiment.lagom(train_fn, config)
    print("Best:", result["best_val"], "with", result["best_hp"])
    return result


if __name__ == "__main__":
    main()
