"""Population Based Training over (lr, weight decay) on the MNIST CNN
(examples/pbt_sweep.py on the port).

Each member trains in budgeted segments; between segments the weakest
members clone the strongest member's weights (its checkpoint, read with
``ctx.restore_parent``) and adopt its hyperparameters with a perturbation,
so the learning-rate schedule is discovered during the run instead of
fixed up front (arXiv:1711.09846). Fully async on the trial driver: no
generation barrier, a member's next segment starts the moment its previous
one finalizes.

Run: python -m maggy_tpu_torch.examples.pbt_sweep [--population 6 --generations 4]
"""

from __future__ import annotations

import argparse

import numpy as np

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.fleet.agent import trial_device
from maggy_tpu_torch.models import MnistCNN
from maggy_tpu_torch.optimizers import PBT
from maggy_tpu_torch.train import ShardedBatchIterator, Trainer, adamw, cross_entropy_loss


def make_data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 16, 16, 1)).astype(np.float32)
    y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    return X, y


DATA_X, DATA_Y = make_data()
STEPS_PER_SEGMENT = 15


def loss_fn(logits, batch):
    return cross_entropy_loss(logits, batch["labels"])


def train_fn(lr, wd, generation, member, budget=1, ctx=None, reporter=None):
    device = trial_device()
    model = MnistCNN(kernel_size=3, pool_size=2, features=8, num_classes=2, image_size=16,
                     device="meta")
    trainer = Trainer(model, adamw(lr, weight_decay=wd), loss_fn,
                      device=device).init(seed=member)

    # Exploit/continue: resume this lineage's weights. A fresh gen-0 member
    # starts from its own init.
    if ctx is not None and ctx.parent_trial_id is not None:
        restored = ctx.restore_parent(trainer.model.state_dict())
        if restored is not None:
            trainer.model.load_state_dict(restored)

    it = iter(ShardedBatchIterator({"x": DATA_X, "y": DATA_Y}, batch_size=64, epochs=None,
                                   seed=member, device=device))
    loss = None
    for i in range(int(STEPS_PER_SEGMENT * budget)):
        b = next(it)
        loss = trainer.step({"inputs": (b["x"],), "labels": b["y"]})
        if reporter is not None and i % 5 == 0:
            reporter.broadcast(-loss, step=i)
    if ctx is not None:
        ctx.save_checkpoint(generation, trainer.model.state_dict())
    return {"metric": -float(loss)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--population", type=int, default=6)
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--workers", type=int, default=3)
    args = ap.parse_args(argv)

    sp = Searchspace(lr=("DOUBLE", [1e-4, 3e-2]), wd=("DOUBLE", [0.0, 0.1]))
    opt = PBT(population=args.population, generations=args.generations, seed=0)
    config = OptimizationConfig(
        name="pbt_sweep", num_trials=opt.schedule_size(), optimizer=opt,
        searchspace=sp, direction="max", num_workers=args.workers,
        es_policy="none", seed=0,
    )
    result = experiment.lagom(train_fn, config)
    print("Best:", result["best_val"], "with", result["best_hp"])
    return result


if __name__ == "__main__":
    main()
