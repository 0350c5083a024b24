"""Training-loop callbacks that stream metrics to the driver.

Copy of ``maggy_tpu/callbacks.py`` (parity: reference `maggy/callbacks.py`
— ``KerasBatchEnd``/``KerasEpochEnd`` report a chosen metric through
``reporter.broadcast`` at batch and epoch ends, :20-66). Callbacks are
plain objects called by ``train.Trainer.fit`` or by a user's loop. A torch
tensor value is broadcast as it is, unsynced (the ``Reporter`` reads it on
its heartbeat thread), where the JAX callbacks convert to a float.
``keras_reporter_callbacks`` needs ``tensorflow``, imported when it is
called; where it is not installed (the card's machine) the call raises
``ImportError``.
"""

from __future__ import annotations

from typing import Optional


def _value(value):
    return value if hasattr(value, "detach") else float(value)


class BatchEnd:
    """Report ``metric`` every batch; step = global batch index."""

    def __init__(self, reporter, metric: str = "loss"):
        self.reporter = reporter
        self.metric = metric
        self._step = -1

    def __call__(self, logs: dict, step: Optional[int] = None) -> None:
        value = logs.get(self.metric)
        if value is None:
            return
        self._step = step if step is not None else self._step + 1
        self.reporter.broadcast(_value(value), step=self._step)


class EpochEnd(BatchEnd):
    """Report ``metric`` once per epoch; step = epoch index."""


def keras_reporter_callbacks(reporter, batch_metric: Optional[str] = None,
                             epoch_metric: Optional[str] = "acc"):
    """tf.keras callbacks of the reference's KerasBatchEnd / KerasEpochEnd
    shapes. Needs tensorflow."""
    from tensorflow import keras  # noqa: PLC0415

    cbs = []
    if batch_metric:
        class _Batch(keras.callbacks.Callback):
            def __init__(self):
                super().__init__()
                self._step = -1

            def on_train_batch_end(self, batch, logs=None):
                if logs and batch_metric in logs:
                    self._step += 1
                    reporter.broadcast(float(logs[batch_metric]), step=self._step)

        cbs.append(_Batch())
    if epoch_metric:
        class _Epoch(keras.callbacks.Callback):
            def on_epoch_end(self, epoch, logs=None):
                if logs and epoch_metric in logs:
                    reporter.broadcast(float(logs[epoch_metric]), step=epoch)

        cbs.append(_Epoch())
    return cbs
