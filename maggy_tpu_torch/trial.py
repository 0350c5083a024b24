"""Trial: the unit of schedulable work and its thread-safe state machine.

Copy of ``maggy_tpu/trial.py`` with its run epoch and ``reset_run_state``
(heartbeat-loss requeue) and its preempt flag (graceful preemption,
``maggy_tpu/trial.py:108-114``).

Parity: reference `maggy/trial.py` — status machine (:33-37), deterministic
md5-derived 16-char trial ids (:110-136), thread-safe early-stop flag and
step-deduplicated metric history (:83-108), json round-trip (:138-176),
ablation trials hashing only the ablated components (:62-67).
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Dict, List, Optional


def _json_default(obj):
    import numpy as np

    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError("Object of type {} is not JSON serializable".format(type(obj)))


class Trial:
    """One evaluation of the user function at a fixed parameter point.

    Shared between the driver's worker thread and the control-plane server
    thread; all mutation is guarded by an RLock (reference `trial.py:24-31`).
    """

    PENDING = "PENDING"
    SCHEDULED = "SCHEDULED"
    RUNNING = "RUNNING"
    ERROR = "ERROR"
    FINALIZED = "FINALIZED"

    def __init__(
        self,
        params: Dict[str, Any],
        trial_type: str = "optimization",
        info_dict: Optional[Dict[str, Any]] = None,
    ):
        self.params = params
        self.trial_type = trial_type
        self.trial_id = Trial._compute_id(params, trial_type)
        self.status = Trial.PENDING  # guarded-by: lock
        self.early_stop = False  # guarded-by: lock
        # Scheduler preemption in flight: the early-stop flag carries the
        # STOP to the runner, this flag marks it as a preemption (the
        # runner acks with a preempted FINAL instead of finalizing).
        self.preempt = False  # guarded-by: lock
        self.final_metric: Optional[float] = None  # guarded-by: lock
        self.metric_history: List[float] = []  # guarded-by: lock
        self.step_history: List[int] = []  # guarded-by: lock
        self.metric_dict: Dict[int, float] = {}  # guarded-by: lock
        self.start: Optional[float] = None  # guarded-by: lock
        self.duration: Optional[float] = None  # guarded-by: lock
        # Run epoch: bumped on every reset_run_state (requeue or gang
        # revocation) and stamped into each dispatch, so the driver can tell
        # a dead run's in-flight FINAL from the live re-run's, even from the
        # same partition (a revoked gang reassembling onto its old leader).
        self.run_epoch = 0  # guarded-by: lock
        self.info_dict: Dict[str, Any] = info_dict or {}
        self.lock = threading.RLock()

    # -------------------------------------------------------------- identity

    @staticmethod
    def _compute_id(params: Dict[str, Any], trial_type: str) -> str:
        """16-char stable id = md5 over the canonical param json.

        Ablation trials hash only the ablated components so structurally
        identical trials dedup (reference `trial.py:62-67,110-136`). Callable
        params never occur here: ablation specs are declarative (see
        `ablation/ablator/loco.py`).
        """
        if trial_type == "ablation":
            material = {
                "ablated_feature": params.get("ablated_feature", "None"),
                "ablated_layer": params.get("ablated_layer", "None"),
                "model_key": params.get("model_key", "base"),
            }
        else:
            material = {k: v for k, v in params.items()}
        blob = json.dumps(material, sort_keys=True, default=_json_default)
        return hashlib.md5(blob.encode("utf-8")).hexdigest()[:16]

    # ----------------------------------------------------------------- state

    def set_status(self, status: str) -> None:
        with self.lock:
            self.status = status

    def get_early_stop(self) -> bool:
        with self.lock:
            return self.early_stop

    def set_early_stop(self) -> None:
        with self.lock:
            self.early_stop = True

    def get_preempt(self) -> bool:
        with self.lock:
            return self.preempt

    def set_preempt(self) -> None:
        with self.lock:
            self.preempt = True

    def reset_run_state(self) -> None:
        """Discard the state of a dead run before a re-run: a requeued trial
        restarts from step 0 on another runner, so stale metric history
        would collide with the new run's steps (dedup by step) and a stale
        early-stop flag would stop it at once (``maggy_tpu/trial.py:116-
        130``)."""
        with self.lock:
            self.early_stop = False
            self.preempt = False
            self.final_metric = None
            self.run_epoch += 1
            self.metric_history = []
            self.step_history = []
            self.metric_dict = {}
            self.start = None
            self.status = Trial.SCHEDULED

    def append_metric(self, metric: float, step: Optional[int] = None) -> bool:
        """Record a heartbeat metric; dedup by step (reference `trial.py:93-108`).

        Returns True if the observation was new.
        """
        with self.lock:
            if metric is None:
                return False
            if step is None:
                step = self.step_history[-1] + 1 if self.step_history else 0
            if step in self.metric_dict:
                return False
            self.metric_dict[step] = float(metric)
            self.metric_history.append(float(metric))
            self.step_history.append(int(step))
            return True

    # ------------------------------------------------------------------ json

    def to_dict(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "id": self.trial_id,
                "trial_type": self.trial_type,
                "params": self.params,
                "status": self.status,
                "early_stop": self.early_stop,
                "final_metric": self.final_metric,
                "metric_history": list(self.metric_history),
                "step_history": list(self.step_history),
                "start": self.start,
                "duration": self.duration,
                "info_dict": dict(self.info_dict),
            }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), default=_json_default)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Trial":
        trial = cls(d["params"], trial_type=d.get("trial_type", "optimization"))
        trial.status = d.get("status", Trial.PENDING)
        trial.early_stop = d.get("early_stop", False)
        trial.final_metric = d.get("final_metric")
        trial.metric_history = list(d.get("metric_history", []))
        trial.step_history = list(d.get("step_history", []))
        trial.metric_dict = dict(zip(trial.step_history, trial.metric_history))
        trial.start = d.get("start")
        trial.duration = d.get("duration")
        trial.info_dict = dict(d.get("info_dict", {}))
        return trial

    @classmethod
    def from_json(cls, blob: str) -> "Trial":
        return cls.from_dict(json.loads(blob))

    def __repr__(self):
        return "Trial(id={}, status={}, params={})".format(
            # unguarded-ok: diagnostic repr — a lock here can deadlock crash logs
            self.trial_id, self.status, self.params
        )
