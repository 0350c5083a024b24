"""Titanic-style tabular LOCO ablation study (examples/titanic_ablation.py
on the port).

The dataset rides in a ``.tfrecord`` file published in the dataset
registry and consumed through the study's ``train_set``: the built-in
feature-dropping pipeline hands each trial the columns minus its ablated
feature, with no TensorFlow import. The layers are torch modules (the
input layer lazy, since an ablated feature leaves four columns); a trial
trains its model with the port's Trainer, full batch.

Run: python -m maggy_tpu_torch.examples.titanic_ablation
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from maggy_tpu_torch import AblationConfig, experiment
from maggy_tpu_torch.ablation import AblationStudy
from maggy_tpu_torch.fleet.agent import trial_device
from maggy_tpu_torch.models.surgery import ablatable_model_generator
from maggy_tpu_torch.train import DatasetRegistry, Trainer, adam, cross_entropy_loss
from maggy_tpu_torch.train.tfrecord import write_tfrecord

FEATURES = ["pclass", "sex", "age", "fare", "embarked"]


def make_titanic_like(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    X = {f: rng.normal(size=n).astype(np.float32) for f in FEATURES}
    logits = 1.5 * X["sex"] - 0.8 * X["pclass"] + 0.3 * X["fare"]
    y = (logits + 0.5 * rng.normal(size=n) > 0).astype(np.int32)
    return X, y


def write_dataset_tfrecord(path):
    """Persist the dataset as tf.train.Example records (one per row)."""
    X, y = make_titanic_like()
    write_tfrecord(path, (
        {**{f: float(X[f][i]) for f in FEATURES}, "survived": int(y[i])}
        for i in range(len(y))))


def model_layers():
    return (
        ("input_dense", lambda: torch.nn.LazyLinear(32)),
        ("hidden_1", lambda: torch.nn.Sequential(torch.nn.Linear(32, 32), torch.nn.ReLU())),
        ("hidden_2", lambda: torch.nn.Sequential(torch.nn.Linear(32, 32), torch.nn.ReLU())),
        ("head", lambda: torch.nn.Linear(32, 2)),
    )


def model_generator(ablated_layers=frozenset()):
    return ablatable_model_generator(model_layers(), ablated_layers)


def loss_fn(logits, batch):
    return cross_entropy_loss(logits, batch["labels"])


def train_fn(dataset_function, model_function, ablated_feature, ablated_layer,
             reporter=None):
    # dataset_function() is the built-in feature dropper over the study's
    # train_set tfrecord: a dict of per-feature arrays (minus the ablated
    # one) plus the label column.
    device = trial_device()
    data = dataset_function()
    y = torch.as_tensor(np.asarray(data.pop("survived"), dtype=np.int32), device=device)
    cols = sorted(data)
    X = torch.as_tensor(np.stack([data[c] for c in cols], axis=1), device=device)
    batch = {"inputs": (X,), "labels": y}
    trainer = Trainer(model_function(), adam(1e-2), loss_fn, device=device).init(
        seed=0, example_inputs=batch["inputs"])
    for i in range(60):
        loss = trainer.step(batch)
        if reporter is not None and i % 20 == 0:
            reporter.broadcast(-loss, step=i)
    with torch.no_grad():
        acc = float((trainer.model(X).argmax(-1) == y).float().mean())
    return {"metric": acc, "loss": float(loss),
            "ablated_feature": str(ablated_feature),
            "ablated_layer": str(ablated_layer)}


def main(argv=None):
    del argv  # no options, as in the JAX example
    data_path = os.path.join(tempfile.mkdtemp(prefix="titanic_"), "titanic.tfrecord")
    write_dataset_tfrecord(data_path)
    # Publish the dataset under a name@version in the dataset registry: the
    # study then addresses it by name only.
    version = DatasetRegistry().register(
        "titanic", data_path, description="synthetic titanic-like tabular")
    study = AblationStudy("titanic", version, "survived")
    study.features.include(*FEATURES)
    study.model.set_base_model_generator(model_generator)
    study.model.layers.include("hidden_1", "hidden_2")
    study.model.layers.include_groups(prefix="hidden")

    config = AblationConfig(name="titanic_loco", ablation_study=study,
                            ablator="loco", direction="max", num_workers=3)
    result = experiment.lagom(train_fn, config)
    print("Trials:", result["num_trials"])
    print("Best (least-harmful ablation):", result["best_hp"],
          "->", result["best_val"])
    print("Worst (most important component):", result["worst_hp"],
          "->", result["worst_val"])
    return result


if __name__ == "__main__":
    main()
