"""Runner-side reporter: bridges user code and the heartbeat thread.

Counterpart of ``maggy_tpu/core/reporter.py`` for scalar trials. Parity:
reference `maggy/core/reporter.py` — `broadcast(metric, step)` with type
checks, monotonic steps, latest-value store, and raising
`EarlyStopException` inside the training loop once the driver's STOP reply
set the flag (:78-102); `log()` buffered for heartbeat shipping (:104-133);
`get_data()` drain (:135-141); `reset()` between trials (:143-156);
`early_stop()` armed only after a reported metric (:158-161); a STOP that
carries ``preempt`` marks the stop as a scheduler preemption, which the
executor consumes with ``take_preempt`` (``maggy_tpu/core/reporter.py:
36-39, 299-336``). Each
broadcast is counted in the runner's telemetry stats when the user makes it
(``maggy_tpu/core/reporter.py:115``).

A 0-d or one-element torch tensor is accepted as a metric and kept LAZY:
the training thread never waits on the device. The heartbeat thread starts
an asynchronous device-to-host copy of the newest loss, ships the newest
value already on the host meanwhile, and reads the copy on a later beat
once its CUDA event has completed (the driver dedups by step).

A vectorized K-lane block (``train/vmap.py``; JAX ``reporter.py:45-55,
122-186, 261-319, 349-368``) arms the reporter with ``reset_lanes``; the
training loop reports the block's ``[K]`` loss vector with
``broadcast_lanes``, kept lazy and read on the heartbeat thread through
the same event check, and shipped as one lane-tagged entry per live lane.
A driver stop of one lane arrives through ``stop_lanes`` and never raises:
the loop polls ``take_stopped_lanes`` and masks the lane. Only a
preempting (whole-block) stop raises.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from maggy_tpu_torch import exceptions


class _HostCopy:
    """An in-flight device-to-host copy of one lazy metric tensor (a scalar,
    or a block's [K] loss vector)."""

    def __init__(self, metric: torch.Tensor):
        self.metric = metric
        shape = () if metric.numel() == 1 else tuple(metric.shape)
        self.host = torch.empty(shape, dtype=metric.dtype, pin_memory=True)
        with torch.cuda.device(metric.device):
            self.host.copy_(metric.detach().reshape(shape), non_blocking=True)
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
        # Telemetry span the driver minted for this trial (rides the TRIAL
        # info); every METRIC of the trial carries it.
        self.span: Optional[str] = None  # guarded-by: lock
        # Runner-side stat buffer (telemetry.runnerstats.RunnerStats), set
        # by the trial executor; None outside an experiment.
        self.stats = None
        self._stop_flag = False  # guarded-by: lock
        # The current stop is a scheduler preemption (the STOP reply
        # carried ``preempt``): the executor acks with a preempted FINAL
        # instead of finalizing. Consumed by take_preempt().
        self._preempt_flag = False  # guarded-by: lock
        self._log_buffer: List[str] = []  # guarded-by: lock
        self._log_file = log_file
        # (metric object, float value, step) of the newest materialized value.
        self._metric_cache = None  # guarded-by: lock
        self._copy: Optional[_HostCopy] = None  # guarded-by: lock
        # ---- a vectorized K-lane block (train/vmap.py) ----
        # Lane descriptors in lane order ({"trial_id", "span", "lane"}), or
        # None for a scalar trial.
        self._lanes: Optional[List[Dict[str, Any]]] = None  # guarded-by: lock
        self._lane_vec = None  # guarded-by: lock  # lazy [K] loss vector
        self._lane_step: Optional[int] = None  # guarded-by: lock
        self._lane_cache = None  # guarded-by: lock  # (vector, [floats], step)
        self._lane_copy: Optional[_HostCopy] = None  # guarded-by: lock
        # Lane trial ids the driver stopped; _new: not yet taken by the loop.
        self._lane_stops: set = set()  # guarded-by: lock
        self._lane_stops_new: set = set()  # guarded-by: lock

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
            stats = self.stats
            if stats is not None:
                # Counts the broadcast when the user makes it, before the
                # stop check so the early-stopped step counts too. Pure
                # arithmetic on the host clock: a lazy CUDA metric stays
                # un-synced.
                stats.on_broadcast(self.step)
            if self._stop_flag:
                raise exceptions.EarlyStopException(self._materialize(self.metric))

    def broadcast_lanes(self, values, step: Optional[int] = None) -> None:
        """Report a K-lane block's loss vector (``VmapTrainer.step``'s
        output: K entries, masked lanes included; they are dropped at ship
        time), kept lazy like ``broadcast``. Raises ``EarlyStopException``
        only when the whole block is stopped (a preemption): a lane's stop
        surfaces through ``take_stopped_lanes``."""
        with self.lock:
            if self._lanes is None:
                raise exceptions.BroadcastMetricTypeError(values)
            shape = getattr(values, "shape", None)
            n = shape[0] if shape else len(values)
            if (shape is not None and len(shape) != 1) or n != len(self._lanes):
                raise exceptions.BroadcastMetricTypeError(values)
            if step is not None and (not isinstance(step, (int, np.integer))
                                     or isinstance(step, bool)):
                raise exceptions.BroadcastStepTypeError(step)
            if step is None:
                step = self._lane_step + 1 if self._lane_step is not None else 0
            elif self._lane_step is not None and step <= self._lane_step:
                raise exceptions.BroadcastStepValueError(step, self._lane_step)
            self._lane_vec = values
            self._lane_step = int(step)
            # The leader's beat is step-aligned with the lanes: code keyed on
            # "has this trial reported" (stop arming) reads the scalar step.
            self.step = self._lane_step
            stats = self.stats
            if stats is not None:
                stats.on_broadcast(self._lane_step)
            if self._stop_flag:
                raise exceptions.EarlyStopException(None)

    def stop_lanes(self, trial_ids) -> None:
        """Flag lanes of the current block for early stop (the heartbeat
        thread applies the server's ``stop_lanes`` reply here); unknown ids
        are ignored."""
        with self.lock:
            if not self._lanes:
                return
            known = {entry["trial_id"] for entry in self._lanes}
            for tid in trial_ids or ():
                if tid in known and tid not in self._lane_stops:
                    self._lane_stops.add(tid)
                    self._lane_stops_new.add(tid)

    def take_stopped_lanes(self) -> List[str]:
        """Newly stopped lane trial ids, each returned once: the loop masks
        them (``VmapTrainer.mask_lane``) and retires each with its metric."""
        with self.lock:
            fresh = sorted(self._lane_stops_new)
            self._lane_stops_new = set()
            return fresh

    def stopped_lanes(self) -> List[str]:
        """Every lane trial id stopped so far this block."""
        with self.lock:
            return sorted(self._lane_stops)

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
        lanes_out = self._lane_data(tid)
        with self.lock:
            logs = self._log_buffer
            self._log_buffer = []
            span = self.span if self.trial_id == tid else None
        data = {"metric": metric, "step": step, "logs": logs, "trial_id": tid,
                "span": span}
        if lanes_out is not None:
            data["lanes"] = lanes_out
        return data

    def _lane_data(self, tid) -> Optional[List[Dict[str, Any]]]:
        """The newest lane vector as lane-tagged beat entries, one per live
        lane; None outside a block or before its first broadcast, or while
        a CUDA vector's first host copy is in flight. One [K] copy replaces
        K scalar reads."""
        with self.lock:
            lanes, vec, vstep = self._lanes, self._lane_vec, self._lane_step
            stops = set(self._lane_stops)
            cached = self._lane_cache
        if lanes is None or vec is None:
            return None
        if cached is not None and cached[0] is vec:
            values, vstep = cached[1], cached[2]
        elif isinstance(vec, torch.Tensor) and vec.is_cuda:
            with self.lock:
                if self.trial_id != tid:
                    return None
                copy = self._lane_copy
                if copy is None or copy.metric is not vec:
                    copy = self._lane_copy = _HostCopy(vec)
            if not copy.ready():
                if cached is None:
                    return None
                values, vstep = cached[1], cached[2]
            else:
                values = [float(v) for v in copy.host.reshape(-1).tolist()]
                with self.lock:
                    if self.trial_id == tid:
                        self._lane_cache = (vec, values, vstep)
                        self._lane_copy = None
        else:
            flat = vec.detach().reshape(-1).tolist() if isinstance(vec, torch.Tensor) \
                else np.asarray(vec).reshape(-1)
            values = [float(v) for v in flat]
            with self.lock:
                if self.trial_id == tid:
                    self._lane_cache = (vec, values, vstep)
        return [{"trial_id": entry["trial_id"], "value": values[i], "step": vstep,
                 "span": entry.get("span"), "lane": entry.get("lane", i)}
                for i, entry in enumerate(lanes) if entry["trial_id"] not in stops]

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

    def early_stop(self, trial_id: Optional[str] = None, preempt: bool = False) -> None:
        """Arm the stop flag (only once a metric exists). ``trial_id``, when
        given, must match the current trial: a STOP reply to a heartbeat
        about the PREVIOUS trial must not stop its successor. ``preempt``
        marks the stop as a scheduler preemption. In a block, a preempting
        stop stops the whole block and a plain one goes to the lane's mask
        (``stop_lanes``)."""
        with self.lock:
            if self._lanes is not None:
                lane_ids = {entry["trial_id"] for entry in self._lanes}
                if trial_id is not None and trial_id != self.trial_id \
                        and trial_id not in lane_ids:
                    return
                if preempt:
                    if self._lane_step is not None or self.metric is not None:
                        self._stop_flag = True
                        self._preempt_flag = True
                elif trial_id is not None:
                    self.stop_lanes([trial_id])
                return
            if trial_id is not None and trial_id != self.trial_id:
                return
            if self.metric is not None:
                self._stop_flag = True
                if preempt:
                    self._preempt_flag = True

    def stop_requested(self) -> bool:
        """Whether the driver flagged this trial (the next broadcast
        raises): a gang leader that relays its ranks polls it."""
        with self.lock:
            return self._stop_flag

    def stop_metric(self):
        """The newest metric as a float, the value an early stop carries."""
        with self.lock:
            return self._materialize(self.metric) if self.metric is not None else None

    def take_preempt(self) -> bool:
        """Consume the preemption marker: True exactly once per preempted
        stop (the executor's EarlyStopException handler decides between
        finalize and preempt ack on it)."""
        with self.lock:
            flag = self._preempt_flag
            self._preempt_flag = False
            return flag

    def reset(self, trial_id: Optional[str] = None, span: Optional[str] = None) -> None:
        with self.lock:
            self.metric = None
            self.step = None
            self._stop_flag = False
            self._preempt_flag = False
            self._log_buffer = []
            self.trial_id = trial_id
            self.span = span
            self._metric_cache = None
            self._copy = None
            self._lanes = None
            self._lane_vec = None
            self._lane_step = None
            self._lane_cache = None
            self._lane_copy = None
            self._lane_stops = set()
            self._lane_stops_new = set()

    def reset_lanes(self, trial_id: str, span: Optional[str],
                    lanes: List[Dict[str, Any]]) -> None:
        """Arm the reporter for a K-lane block: ``trial_id`` and ``span``
        are the block leader's (the partition's assignment), ``lanes`` the
        per-lane descriptors of the TRIAL reply's ``vmap_block``."""
        self.reset(trial_id=trial_id, span=span)
        with self.lock:
            self._lanes = [{"trial_id": entry["trial_id"], "span": entry.get("span"),
                            "lane": entry.get("lane", i)} for i, entry in enumerate(lanes)]
