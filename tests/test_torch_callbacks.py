"""The port's callbacks and ``Trainer.fit`` on the CPU.

Counterparts of ``tests/test_callbacks.py``'s cases (BatchEnd's running
step, EpochEnd's given step, a missing metric skipped, the tf.keras shim
driving a real keras fit where tensorflow is installed, and the driver's
STOP raised out of it), plus ``Trainer.fit`` against the JAX Trainer's on
MnistMLP from converted Flax weights: the final loss within fp32 tolerance
(1e-5 relative, tests/test_torch_mnist.py's), the reported steps and the
callbacks' steps the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maggy_tpu.callbacks import BatchEnd as JaxBatchEnd
from maggy_tpu.core.reporter import Reporter as JaxReporter
from maggy_tpu.models import MnistMLP as JaxMnistMLP
from maggy_tpu.parallel import make_mesh
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train import cross_entropy_loss as jax_xent

from maggy_tpu_torch.callbacks import BatchEnd, EpochEnd, keras_reporter_callbacks
from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.exceptions import EarlyStopException
from maggy_tpu_torch.models import MnistMLP
from maggy_tpu_torch.models.mnist_cnn import flax_to_state_dict
from maggy_tpu_torch.train import Trainer, adam, cross_entropy_loss

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]


def _reporter(cls=Reporter):
    rep = cls()
    rep.reset(trial_id="t")
    return rep


def test_batch_end_reports_with_running_step():
    rep = _reporter()
    cb = BatchEnd(rep, metric="loss")
    cb({"loss": 0.5})
    cb({"loss": 0.25})
    data = rep.get_data()
    assert data["metric"] == 0.25 and data["step"] == 1


def test_epoch_end_uses_given_step_and_keeps_a_tensor_lazy():
    rep = _reporter()
    EpochEnd(rep, metric="acc")({"acc": 0.8}, step=3)
    assert rep.get_data() == {"metric": 0.8, "step": 3, "logs": [], "trial_id": "t",
                              "span": None}
    value = torch.tensor(0.5)
    EpochEnd(rep, metric="acc")({"acc": value}, step=4)
    assert rep.metric is value  # broadcast as it is, read on the heartbeat thread
    assert rep.get_data()["metric"] == 0.5


def test_missing_metric_is_skipped_as_jax():
    ours, theirs = _reporter(), _reporter(JaxReporter)
    BatchEnd(ours, metric="nope")({"loss": 1.0})
    JaxBatchEnd(theirs, metric="nope")({"loss": 1.0})
    assert ours.get_data()["metric"] is theirs.get_data()["metric"] is None


def _keras_fit(tf, callbacks, epochs=2):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32)
    model = tf.keras.Sequential([tf.keras.layers.Dense(8, activation="relu"),
                                 tf.keras.layers.Dense(2)])
    model.compile(optimizer="sgd", loss=tf.keras.losses.SparseCategoricalCrossentropy(
        from_logits=True))
    model.fit(x, y, epochs=epochs, batch_size=16, verbose=0, callbacks=callbacks)


def test_keras_shim_streams_through_the_reporter_and_stops():
    tf = pytest.importorskip("tensorflow")
    rep = _reporter()
    _keras_fit(tf, keras_reporter_callbacks(rep, epoch_metric="loss"), epochs=3)
    assert rep.get_data()["step"] == 2  # the last epoch's index
    rep = _reporter()
    cbs = keras_reporter_callbacks(rep, batch_metric="loss", epoch_metric=None)

    class Arm(tf.keras.callbacks.Callback):
        def on_train_batch_end(self, batch, logs=None):
            if batch == 1:
                rep.early_stop()

    with pytest.raises(EarlyStopException):
        _keras_fit(tf, [Arm()] + cbs)


def test_fit_matches_the_jax_trainers_fit():
    """Eight MnistMLP steps through both Trainers' fit from the same
    weights, reporting every third step, a BatchEnd callback each step."""
    rng = np.random.default_rng(0)
    x = rng.random((32, 16, 16, 1)).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0.5).astype(np.int32)
    batches = [{"inputs": (x,), "labels": y}] * 8
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(JaxMnistMLP(features=8, num_classes=2), optax.adam(1e-2),
                          lambda logits, b: jax_xent(logits, b["labels"]), mesh,
                          warm_start=False)
    jtrainer.init(jax.random.key(0), (jnp.asarray(x[:1]),))
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                      jtrainer.variables["params"]))
    seen = {"port": [], "jax": []}

    class Spy:
        def __init__(self, key):
            self.key = key

        def broadcast(self, value, step=None):
            seen[self.key].append(step)

    jloss = jtrainer.fit([{"inputs": (jnp.asarray(x),), "labels": jnp.asarray(y)}] * 8,
                         reporter=Spy("jax"), report_every=3,
                         callbacks=[JaxBatchEnd(Spy("jax"))])
    trainer = Trainer(MnistMLP(features=8, num_classes=2, image_size=16, device="cpu"),
                      adam(1e-2), lambda logits, b: cross_entropy_loss(logits, b["labels"]),
                      device="cpu").init(state_dict=state)
    loss = trainer.fit(batches, reporter=Spy("port"), report_every=3,
                       callbacks=[BatchEnd(Spy("port"))])
    assert isinstance(loss, float) and loss == pytest.approx(jloss, rel=1e-5)
    assert seen["port"] == seen["jax"] == [0, 0, 1, 2, 3, 3, 4, 5, 6, 6, 7]
    assert np.isnan(trainer.fit([]))
