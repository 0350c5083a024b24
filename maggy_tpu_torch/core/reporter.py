"""Runner-side reporter: bridges user code and the heartbeat thread.

Counterpart of ``maggy_tpu/core/reporter.py`` for scalar trials. Parity:
reference `maggy/core/reporter.py` — `broadcast(metric, step)` with type
checks, monotonic steps, latest-value store, and raising
`EarlyStopException` inside the training loop once the driver's STOP reply
set the flag (:78-102); `log()` buffered for heartbeat shipping (:104-133);
`get_data()` drain (:135-141); `reset()` between trials (:143-156);
`early_stop()` armed only after a reported metric (:158-161).

A 0-d or one-element torch tensor is accepted as a metric and kept LAZY:
the training thread never waits on the device. The heartbeat thread starts
an asynchronous device-to-host copy of the newest loss, ships the newest
value already on the host meanwhile, and reads the copy on a later beat
once its CUDA event has completed (the driver dedups by step).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from maggy_tpu_torch import exceptions


class _HostCopy:
    """An in-flight device-to-host copy of one lazy metric tensor."""

    def __init__(self, metric: torch.Tensor):
        self.metric = metric
        self.host = torch.empty((), dtype=metric.dtype, pin_memory=True)
        with torch.cuda.device(metric.device):
            self.host.copy_(metric.detach().reshape(()), non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def ready(self) -> bool:
        return self.event.query()


class Reporter:
    def __init__(self, log_file: Optional[str] = None):
        self.lock = threading.RLock()
        self.metric = None  # guarded-by: lock
        self.step: Optional[int] = None  # guarded-by: lock
        self.trial_id: Optional[str] = None  # guarded-by: lock
        self._stop_flag = False  # guarded-by: lock
        self._log_buffer: List[str] = []  # guarded-by: lock
        self._log_file = log_file
        # (metric object, float value, step) of the newest materialized value.
        self._metric_cache = None  # guarded-by: lock
        self._copy: Optional[_HostCopy] = None  # guarded-by: lock

    # ------------------------------------------------------------- user API

    @staticmethod
    def _scalar_like(metric) -> bool:
        """Plain numbers, and one-element float/int tensors or arrays, judged
        from metadata only (no device sync). Booleans are rejected."""
        if isinstance(metric, bool):
            return False
        if isinstance(metric, (int, float, np.number)):
            return True
        if isinstance(metric, torch.Tensor):
            return metric.numel() == 1 and metric.dtype != torch.bool \
                and not metric.dtype.is_complex
        if isinstance(metric, np.ndarray):
            return metric.size == 1 and (np.issubdtype(metric.dtype, np.floating)
                                         or np.issubdtype(metric.dtype, np.integer))
        return False

    def broadcast(self, metric, step: Optional[int] = None) -> None:
        """Report an interim metric from the training loop. Raises
        `EarlyStopException` if the driver has flagged this trial."""
        with self.lock:
            if not self._scalar_like(metric):
                raise exceptions.BroadcastMetricTypeError(metric)
            if step is not None and (not isinstance(step, (int, np.integer)) or isinstance(step, bool)):
                raise exceptions.BroadcastStepTypeError(step)
            if step is None:
                step = self.step + 1 if self.step is not None else 0
            elif self.step is not None and step <= self.step:
                raise exceptions.BroadcastStepValueError(step, self.step)
            self.metric = float(metric) if isinstance(metric, (int, np.number)) else metric
            self.step = int(step)
            if self._stop_flag:
                raise exceptions.EarlyStopException(self._materialize(self.metric))

    @staticmethod
    def _materialize(metric):
        """Lazy value -> float (waits for the step that produced it)."""
        return metric if metric is None or isinstance(metric, float) else float(metric)

    def log(self, message: str) -> None:
        with self.lock:
            self._log_buffer.append(str(message))
            if self._log_file:
                try:
                    with open(self._log_file, "a") as f:
                        f.write(str(message) + "\n")
                except OSError:
                    pass

    # ------------------------------------------------------- heartbeat side

    def get_data(self) -> Dict[str, Any]:
        """Drain for one heartbeat: the newest host-side (metric, step), the
        buffered logs, and the trial they belong to."""
        with self.lock:
            metric, step, tid = self.metric, self.step, self.trial_id
            cached = self._metric_cache
        if metric is not None and not isinstance(metric, float):
            if cached is not None and cached[0] is metric:
                metric = cached[1]
            elif isinstance(metric, torch.Tensor) and metric.is_cuda:
                metric, step = self._poll_device(metric, step, tid, cached)
            else:
                value = self._materialize(metric)
                with self.lock:
                    if self.trial_id == tid:
                        self._metric_cache = (metric, value, step)
                metric = value
        with self.lock:
            logs = self._log_buffer
            self._log_buffer = []
        return {"metric": metric, "step": step, "logs": logs, "trial_id": tid}

    def _poll_device(self, metric, step, tid, cached):
        """Non-blocking read of a CUDA metric: start its host copy, or read
        a finished one; until then ship the previous materialized pair."""
        with self.lock:
            if self.trial_id != tid:
                return None, None
            copy = self._copy
            if copy is None or copy.metric is not metric:
                copy = self._copy = _HostCopy(metric)
        if copy.ready():
            value = float(copy.host)
            with self.lock:
                # Cache only if the trial has not rolled over meanwhile.
                if self.trial_id == tid:
                    self._metric_cache = (metric, value, step)
                    self._copy = None
            return value, step
        if cached is not None:
            return cached[1], cached[2]
        return None, None

    def early_stop(self, trial_id: Optional[str] = None) -> None:
        """Arm the stop flag (only once a metric exists). ``trial_id``, when
        given, must match the current trial: a STOP reply to a heartbeat
        about the PREVIOUS trial must not stop its successor."""
        with self.lock:
            if trial_id is not None and trial_id != self.trial_id:
                return
            if self.metric is not None:
                self._stop_flag = True

    def reset(self, trial_id: Optional[str] = None) -> None:
        with self.lock:
            self.metric = None
            self.step = None
            self._stop_flag = False
            self._log_buffer = []
            self.trial_id = trial_id
            self._metric_cache = None
            self._copy = None
