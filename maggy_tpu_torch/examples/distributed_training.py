"""Distributed data-parallel training (examples/distributed_training.py on
the port): the train function gets a ``ShardingEnv`` instead of a
DDP-wrapped model, and the mesh Trainer averages the gradients over the
"data" axis.

Where the JAX example spreads one process's mesh over every visible
device, the port runs one rank a device: ``DistributedConfig``'s
``num_workers`` ranks (one here, in a thread of this process) with a
{"data": num_workers} mesh, on ``trial_device()``. The mesh Trainer is the
port's counterpart of the JAX example's ``init_train_state`` +
``make_train_step``.

Run: python -m maggy_tpu_torch.examples.distributed_training
"""

from __future__ import annotations

import numpy as np

from maggy_tpu_torch import DistributedConfig, experiment
from maggy_tpu_torch.fleet.agent import trial_device
from maggy_tpu_torch.models import ResNet
from maggy_tpu_torch.train import ShardedBatchIterator, Trainer, cross_entropy_loss, sgd


def loss_fn(out, batch):
    return cross_entropy_loss(out, batch["labels"])


def train_fn(sharding_env, reporter=None):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(512, 32, 32, 3)).astype(np.float32)
    y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.int32)

    trainer = Trainer(
        ResNet(depth=18, num_classes=2, width=16, device="meta"),
        sgd(0.05, momentum=0.9), loss_fn, has_aux_collections=True,
        train_kwargs={"train": True}, env=sharding_env, strategy="dp",
    ).init(seed=0)
    # Input sharded by this process's rank, then placed for it.
    it = ShardedBatchIterator(
        {"x": X, "y": y}, batch_size=128,
        shard_count=sharding_env.shard_count,
        current_shard=sharding_env.current_shard,
        epochs=4, seed=1, env=sharding_env,
    )
    loss = None
    for i, b in enumerate(it):
        loss = trainer.step({"inputs": (b["x"],), "labels": b["y"]})
        if reporter is not None and i % 4 == 0:
            reporter.broadcast(float(loss), step=i)
    return {"metric": float(loss)}


def main(argv=None):
    del argv  # no options, as in the JAX example
    config = DistributedConfig(
        name="resnet_dp", num_workers=1, mesh_shape={"data": 1},
        device=trial_device(),
    )
    result = experiment.lagom(train_fn, config)
    print("Average final loss across workers:", result["average_metric"])
    return result


if __name__ == "__main__":
    main()
