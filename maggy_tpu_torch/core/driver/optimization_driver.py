"""HPO experiment driver.

The lean counterpart of ``maggy_tpu/core/driver/optimization_driver.py``
(parity: reference `maggy/core/experiment_driver/optimization_driver.py` —
optimizer registry (:35-43), executor clamping (:57-59), controller wiring
to the trial/final stores (:87-93), METRIC/FINAL/IDLE/REG callbacks
(:331-457), result aggregation (:247-307), finalize writing result.json
(:158-194)). A FINAL is processed on the RPC thread and its reply carries
the runner's next assignment. Gangs, vmap blocks, forks, preemption,
heartbeat-loss requeue, resume and the prefetching suggester thread are not
ported yet.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from maggy_tpu_torch import constants, util
from maggy_tpu_torch.config import OptimizationConfig
from maggy_tpu_torch.core.driver.driver import Driver
from maggy_tpu_torch.core.executors.trial_executor import trial_executor_fn
from maggy_tpu_torch.core.rpc import OptimizationServer
from maggy_tpu_torch.core.runner_pool import ThreadRunnerPool, resolve_num_workers
from maggy_tpu_torch.earlystop import MedianStoppingRule, NoStoppingRule
from maggy_tpu_torch.optimizers import Asha, RandomSearch
from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.trial import Trial

CONTROLLER_REGISTRY = {"randomsearch": RandomSearch, "asha": Asha}
ES_REGISTRY = {"median": MedianStoppingRule, "none": NoStoppingRule}


class OptimizationDriver(Driver):
    def __init__(self, config: OptimizationConfig, app_id: str, run_id: int):
        self.controller = self._init_controller(config)
        self.num_trials = config.num_trials
        self.num_executors = min(resolve_num_workers(config), self.num_trials)
        super().__init__(config, app_id, run_id)
        self._trial_store: Dict[str, Trial] = {}  # guarded-by: _store_lock
        self._final_store: List[Trial] = []  # guarded-by: _store_lock
        self._store_lock = threading.RLock()
        # Serializes the schedule: the worker thread (REG/IDLE) and the RPC
        # thread (FINAL) both hand out work. Ordering: sched -> store lock.
        self._sched_lock = threading.RLock()
        self.earlystop_check = self._init_earlystop(config)
        self.es_interval = config.es_interval
        self.es_min = config.es_min
        self.direction = config.direction
        self.optimization_key = config.optimization_key

        # Wire the controller (reference `optimization_driver.py:87-93`).
        self.controller.searchspace = config.searchspace
        self.controller.num_trials = self.num_trials
        self.controller.trial_store = self._trial_store
        self.controller.final_store = self._final_store
        self.controller.direction = config.direction
        self.controller.initialize()

        self.result = {"best_id": None, "best_val": None, "best_hp": None,
                       "worst_id": None, "worst_val": None, "worst_hp": None,
                       "avg": None, "num_trials": 0, "early_stopped": 0}
        self.job_start: Optional[float] = None
        self.maggy_log = ""

    # --------------------------------------------------------------- set up

    @staticmethod
    def _init_controller(config) -> AbstractOptimizer:
        opt = config.optimizer
        if isinstance(opt, str):
            key = opt.lower()
            if key not in CONTROLLER_REGISTRY:
                raise ValueError("Unknown optimizer '{}'; choose from {} or pass an "
                                 "AbstractOptimizer instance.".format(
                                     opt, sorted(CONTROLLER_REGISTRY)))
            return CONTROLLER_REGISTRY[key](seed=config.seed)
        if not isinstance(opt, AbstractOptimizer):
            raise TypeError("optimizer must be a registry name or AbstractOptimizer, "
                            "got {}".format(type(opt)))
        return opt

    @staticmethod
    def _init_earlystop(config):
        pol = config.es_policy
        if isinstance(pol, str):
            if pol.lower() not in ES_REGISTRY:
                raise ValueError("Unknown es_policy '{}'".format(pol))
            return ES_REGISTRY[pol.lower()]
        return pol

    def _make_server(self):
        return OptimizationServer(secret=self.secret)

    def _make_runner_pool(self):
        return ThreadRunnerPool(self.num_executors)

    def _executor_fn(self, train_fn):
        return trial_executor_fn(
            server_addr=self.server_addr, secret=self.server.secret_hex,
            hb_interval=self.hb_interval, exp_dir=self.exp_dir,
            optimization_key=self.optimization_key, train_fn=train_fn)

    def _register_msg_callbacks(self) -> None:
        self.message_callbacks.update(
            METRIC=self._metric_msg_callback,
            IDLE=self._idle_msg_callback,
            REG=self._register_msg_callback,
        )

    def get_trial(self, trial_id):
        with self._store_lock:
            return self._trial_store.get(trial_id)

    # ------------------------------------------------------------ callbacks

    def _metric_msg_callback(self, msg) -> None:
        """Append a heartbeat metric; early-stop check every es_interval
        steps once es_min trials finalized (reference :331-361)."""
        self.add_executor_logs(msg.get("logs"))
        trial = self.get_trial(msg.get("trial_id"))
        if trial is None or msg.get("value") is None:
            return
        if not trial.append_metric(msg["value"], msg.get("step")):
            return
        with trial.lock:
            n_steps = len(trial.step_history)
        with self._store_lock:
            final_snapshot = list(self._final_store)
        if len(final_snapshot) < self.es_min or n_steps % self.es_interval != 0:
            return
        for t in self.earlystop_check.earlystop_check(
                {trial.trial_id: trial}, final_snapshot, self.direction):
            # The rule can re-return an already-flagged trial (its beats go
            # on until the STOP reply lands): count each trial once.
            if not t.get_early_stop():
                t.set_early_stop()
                self.result["early_stopped"] += 1

    def process_final(self, msg) -> None:
        """Finalize the trial, persist its artifacts, report it to the
        controller and assign the runner its next trial (reference
        :369-417). Runs on the RPC thread, before the FINAL reply, so the
        reply can carry the assignment."""
        try:
            with self._sched_lock:
                self._final_locked(msg)
        except Exception as exc:  # noqa: BLE001 - surfaced by run_experiment
            self.fail(exc)

    def _final_locked(self, msg) -> None:
        self.add_executor_logs(msg.get("logs"))
        trial = self.get_trial(msg.get("trial_id"))
        if trial is None:
            # Duplicate FINAL (a retried send whose reply was lost): the
            # result is recorded; the runner still needs work unless it
            # already holds an undelivered assignment.
            if self.server.reservations.get_assigned_trial(msg["partition_id"]) is None:
                self._assign_next(msg["partition_id"], None)
            return
        with trial.lock:
            if msg.get("error"):
                trial.status = Trial.ERROR
                trial.final_metric = None
            else:
                trial.status = Trial.FINALIZED
                trial.final_metric = float(msg["value"])
            trial.duration = time.time() - trial.start if trial.start else None
        with self._store_lock:
            self._trial_store.pop(trial.trial_id, None)
            self._final_store.append(trial)
        self._update_result(trial)
        # Persist BEFORE the hand-off: assigning the last trial flips
        # experiment_done and releases the pool.
        self.env.dump(trial.to_json(), "{}/{}/trial.json".format(self.exp_dir, trial.trial_id))
        self._assign_next(msg["partition_id"], trial)

    def _register_msg_callback(self, msg) -> None:
        self._assign_next(msg["partition_id"], None)

    def _idle_msg_callback(self, msg) -> None:
        """Re-poll the controller after a short tick (reference :419-439)."""
        self._assign_next(msg["partition_id"], None)

    def _rearm_idle(self, partition_id: int) -> None:
        # A timer, not a sleep on the single worker thread: idle runners
        # must not stall METRIC processing.
        timer = threading.Timer(constants.DRIVER_IDLE_REQUEUE_TICK_S, self.enqueue,
                                args=({"type": "IDLE", "partition_id": partition_id},))
        timer.daemon = True
        timer.start()

    def _assign_next(self, partition_id: int, last_trial: Optional[Trial]) -> None:
        """Report ``last_trial`` to the controller and assign the runner
        the next suggestion; the controller, not a trial count, decides when
        the experiment is over (ASHA runs more trials than num_trials)."""
        if self.experiment_done:
            return
        with self._sched_lock:
            suggestion = self.controller.get_suggestion(last_trial)
            if suggestion is None:
                # Over only once nothing is in flight.
                with self._store_lock:
                    in_flight = bool(self._trial_store)
                if in_flight:
                    suggestion = "IDLE"
                else:
                    self.experiment_done = True
                    return
            if suggestion == "IDLE":
                self._rearm_idle(partition_id)
                return
            with self._store_lock:
                if suggestion.trial_id in self._trial_store:
                    self._log("WARNING: controller re-issued in-flight trial id {}; "
                              "the schedule may lose an entry".format(suggestion.trial_id))
                self._trial_store[suggestion.trial_id] = suggestion
            suggestion.set_status(Trial.SCHEDULED)
            self.server.reservations.assign_trial(partition_id, suggestion.trial_id)

    # -------------------------------------------------------------- results

    def _update_result(self, trial: Trial) -> None:
        if trial.final_metric is None:
            return
        metric, maximize = trial.final_metric, self.direction == "max"
        r = self.result
        r["num_trials"] += 1
        if r["best_val"] is None or (metric > r["best_val"] if maximize else metric < r["best_val"]):
            r.update(best_id=trial.trial_id, best_val=metric,
                     best_hp=self.controller._strip_budget(trial.params))
        if r["worst_val"] is None or (metric < r["worst_val"] if maximize else metric > r["worst_val"]):
            r.update(worst_id=trial.trial_id, worst_val=metric,
                     worst_hp=self.controller._strip_budget(trial.params))
        r["avg"] = metric if r["avg"] is None else r["avg"] + (metric - r["avg"]) / r["num_trials"]

    def _exp_startup_callback(self) -> None:
        self.job_start = time.time()
        util.write_hparams_config(self.exp_dir, self.config.searchspace, self.env)

    def _exp_final_callback(self, job_end):
        with self._store_lock:
            finalized = list(self._final_store)
        self.controller.finalize_experiment(finalized)
        duration = job_end - (self.job_start or job_end)
        self.result["duration_s"] = duration
        self.env.dump(json.dumps(self.result, indent=2, default=str),
                      self.exp_dir + "/result.json")
        util.build_summary(self.exp_dir, self.env)
        self.maggy_log = self._result_summary(duration)
        self.env.finalize_experiment(
            self.exp_dir, "FINISHED",
            {"result": {k: self.result[k] for k in
                        ("best_id", "best_val", "avg", "num_trials", "early_stopped")}})
        return dict(self.result)

    def _exp_exception_callback(self, exc) -> None:
        self.env.finalize_experiment(self.exp_dir, "FAILED", {"error": repr(exc)})
        raise exc

    def _result_summary(self, duration: float) -> str:
        """Human-readable final summary (reference
        `optimization_driver.py:172-194`)."""
        r = self.result
        return "\n".join([
            "------ {} results ------ direction({})".format(
                type(self.controller).__name__, self.direction),
            "BEST combination {} -- metric {}".format(
                json.dumps(r["best_hp"], default=str), r["best_val"]),
            "WORST combination {} -- metric {}".format(
                json.dumps(r["worst_hp"], default=str), r["worst_val"]),
            "AVERAGE metric -- {}".format(r["avg"]),
            "EARLY STOPPED trials -- {}".format(r["early_stopped"]),
            "Total job time {:.2f} s ({} trials)".format(duration, r["num_trials"]),
        ])

    def progress_snapshot(self) -> Dict[str, Any]:
        with self._store_lock:
            done = len(self._final_store)
        with self._log_lock:
            log_total = len(self.executor_logs)
            log_tail = list(self.executor_logs[-20:])
        return {"num_trials": self.num_trials, "finalized": done,
                "best_val": self.result["best_val"],
                "early_stopped": self.result["early_stopped"],
                "log_total": log_total, "log_tail": log_tail}
