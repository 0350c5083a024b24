"""HPO experiment driver.

The lean counterpart of ``maggy_tpu/core/driver/optimization_driver.py``
(parity: reference `maggy/core/experiment_driver/optimization_driver.py` —
optimizer registry (:35-43), executor clamping (:57-59), pruner/gridsearch
num_trials overrides (:63-69), controller wiring to the trial/final stores
(:87-93), METRIC/FINAL/IDLE/REG callbacks (:331-457), result aggregation
(:247-307), finalize writing result.json (:158-194)), with the JAX
package's pipelined hand-off (``config.prefetch``, JAX `:240-278,
:1163-1339`): a suggester thread keeps one suggestion per live runner ready,
a FINAL is processed on the RPC thread when the schedule lock is free within
a bounded wait, and its reply carries the runner's next trial. An expensive
controller (Bayesian optimization) never runs suggest() on the RPC thread.
Heartbeat-loss recovery (JAX `:644-697, :847-868, :1381-1407`): a runner
silent for the resolved loss timeout while holding a trial is declared lost,
its trial is reset and requeued ahead of fresh suggestions, the pool kills
the runner where it can, and a FINAL from the revoked run (stale run epoch,
or the trial still waiting in the requeue) is dropped. Every trial's
life is journaled as in the JAX package (`:521-590, :665-697, :1213-1321,
:1426, :2011-2031, :2293-2299`): ``suggested``, ``queued`` (minting the
span), ``assigned``, ``first_metric``, ``stop_flagged``, ``finalized``,
``lost`` and ``requeued``, with ``suggest`` latency events and prefetch
invalidations beside them. result.json's ``pipeline``, ``lost_runners``
and ``recovery`` blocks are read back from that telemetry: its metric
registry and its span events. Gangs, vmap blocks, forks, preemption and
resume are not ported yet.
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
from maggy_tpu_torch.core.runner_pool import (GPURunnerPool, ProcessRunnerPool,
                                              ThreadRunnerPool, resolve_num_workers)
from maggy_tpu_torch.earlystop import MedianStoppingRule, NoStoppingRule
from maggy_tpu_torch.optimizers import Asha, GridSearch, RandomSearch, SingleRun
from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.trial import Trial


def _lazy_gp(**kwargs):
    from maggy_tpu_torch.optimizers.bayes import GP

    return GP(**kwargs)


def _lazy_tpe(**kwargs):
    from maggy_tpu_torch.optimizers.bayes import TPE

    return TPE(**kwargs)


#: Registry names: suggest() calls per calling thread, runners killed per
#: partition.
_SUGGEST_CALLS = "controller.suggest_calls."
_KILLED = "recovery.killed.p"

# "gp"/"tpe" resolve lazily: the BO stack pulls scipy, which experiments
# that never use it need not import.
CONTROLLER_REGISTRY = {"randomsearch": RandomSearch, "gridsearch": GridSearch,
                       "asha": Asha, "tpe": _lazy_tpe, "gp": _lazy_gp, "none": SingleRun}
ES_REGISTRY = {"median": MedianStoppingRule, "none": NoStoppingRule}


class OptimizationDriver(Driver):
    def __init__(self, config: OptimizationConfig, app_id: str, run_id: int):
        self.controller = self._init_controller(config)
        # The pruner must exist before the schedule is sized: it owns
        # num_trials when multi-fidelity.
        self.controller.init_pruner()
        self.num_trials = self._resolve_num_trials(config)
        self.num_executors = min(resolve_num_workers(config), self.num_trials)
        super().__init__(config, app_id, run_id)
        self._trial_store: Dict[str, Trial] = {}  # guarded-by: _store_lock
        self._final_store: List[Trial] = []  # guarded-by: _store_lock
        # Trials of lost runners, served before fresh suggestions.
        self._requeue: List[str] = []  # guarded-by: _store_lock
        self._store_lock = threading.RLock()
        # Serializes the schedule across the worker thread (REG/IDLE and
        # FINAL fallbacks), the RPC thread (the FINAL fast path) and the
        # suggester thread. Ordering: sched -> store lock, never the reverse.
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
        self.controller._initialize()

        self.result = {"best_id": None, "best_val": None, "best_hp": None,
                       "worst_id": None, "worst_val": None, "worst_hp": None,
                       "avg": None, "num_trials": 0, "early_stopped": 0}
        # Serializes the refresh of result.json's telemetry-derived blocks.
        self._result_lock = threading.Lock()
        self._refresh_recovery()
        self.job_start: Optional[float] = None
        self.maggy_log = ""
        self.server.hb_loss_timeout = config.resolved_hb_loss_timeout()

        # ---- pipelined hand-off (config.prefetch) ----
        self._prefetch_enabled = bool(config.prefetch) and self.controller.supports_prefetch()
        # Pre-materialized suggestions (oldest first), each stamped with the
        # controller's schedule_version at suggest time.
        self._prefetched: List[Trial] = []  # guarded-by: _sched_lock
        self._prefetch_versions: Dict[str, int] = {}  # guarded-by: _sched_lock
        self._suggest_wake = threading.Event()
        # >0 while the FINAL fast path runs on the RPC thread: an expensive
        # suggest() must then wait for the suggester instead.
        self._inline_depth = 0  # guarded-by: _sched_lock
        self._suggester_thread: Optional[threading.Thread] = None
        if self._prefetch_enabled:
            self._suggester_thread = threading.Thread(
                target=self._suggester_loop, daemon=True, name="suggester")
            self._suggester_thread.start()

    # --------------------------------------------------------------- set up

    @staticmethod
    def _init_controller(config) -> AbstractOptimizer:
        opt = config.optimizer
        if opt is None:
            return SingleRun(seed=config.seed)
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

    def _resolve_num_trials(self, config) -> int:
        # The pruner owns the schedule; gridsearch computes it from the
        # space (reference `optimization_driver.py:63-69`).
        if self.controller.pruner is not None:
            return self.controller.pruner.num_trials()
        if isinstance(self.controller, GridSearch):
            return GridSearch.get_num_trials(config.searchspace)
        return config.num_trials

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
        pool = self.config.pool
        if pool == "process":
            return ProcessRunnerPool(self.num_executors)
        if pool == "gpu":
            return GPURunnerPool(self.num_executors,
                                 chips_per_trial=self.config.chips_per_trial)
        return ThreadRunnerPool(self.num_executors)

    def _executor_fn(self, train_fn):
        return trial_executor_fn(
            server_addr=self.server_addr, secret=self.server.secret_hex,
            hb_interval=self.hb_interval, exp_dir=self.exp_dir,
            optimization_key=self.optimization_key, train_fn=train_fn)

    def _register_msg_callbacks(self) -> None:
        self.message_callbacks.update(
            METRIC=self._metric_msg_callback,
            FINAL=self._final_msg_callback,
            IDLE=self._idle_msg_callback,
            REG=self._register_msg_callback,
            LOST=self._lost_msg_callback,
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
        if n_steps == 1:
            # Time to first signal: running -> first_metric is the trial's
            # start-up cost as the control plane sees it.
            self.telemetry.trial_event(trial.trial_id, "first_metric",
                                       partition=msg.get("partition_id"))
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
                # The early-stop reaction's opening edge; its closing edge
                # is this trial's "finalized".
                self.telemetry.trial_event(t.trial_id, "stop_flagged")

    def process_final_inline(self, msg) -> bool:
        """RPC-thread FINAL fast path: finalize the trial, report it, drop
        stale prefetches and assign the runner its next trial before the
        FINAL reply is written, so the reply can carry it. True = processed;
        False = the caller enqueues the FINAL for the worker thread (prefetch
        off, or the schedule lock stayed held by a mid-fit suggester for
        PREFETCH_FINAL_LOCK_TIMEOUT_S: every runner's heartbeat and STOP
        reply waits on this thread)."""
        if not self._prefetch_enabled or self.worker_done:
            return False
        if not self._sched_lock.acquire(timeout=constants.PREFETCH_FINAL_LOCK_TIMEOUT_S):
            self.telemetry.metrics.counter("prefetch.lock_fallbacks").inc()
            # This hand-off really falls back to GET polling: a miss, marked
            # so the journal counts the lock fallbacks too.
            self.telemetry.trial_event(msg.get("trial_id"), "prefetch_miss", once=True,
                                       partition=int(msg["partition_id"]), lock_fallback=True)
            return False
        try:
            self._inline_depth += 1
            try:
                self._final_locked(msg)
            finally:
                self._inline_depth -= 1
        except Exception as exc:  # noqa: BLE001 - surfaced by run_experiment
            self.fail(exc)
        finally:
            self._sched_lock.release()
        return True

    def _final_msg_callback(self, msg) -> None:
        """The worker-thread FINAL path (prefetch off, or a lock fallback)."""
        with self._sched_lock:
            self._final_locked(msg)

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
        if self._is_stale_final(trial, msg):
            # The trial was requeued out from under this runner (a false
            # loss: the runner was only slow) while its FINAL was in flight;
            # the requeue is authoritative and the re-run's FINAL counts.
            # The server cleared no assignment for it, so the runner still
            # needs work.
            self.telemetry.metrics.counter("recovery.stale_finals_dropped").inc()
            self._refresh_recovery()
            self._log("dropping stale FINAL for requeued trial {} from runner {}".format(
                trial.trial_id, msg["partition_id"]))
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
            was_error, was_early_stop = trial.status == Trial.ERROR, trial.early_stop
        # The hand-off gap's opening edge and the early-stop reaction's
        # closing edge, journaled before the next assignment.
        self.telemetry.trial_event(trial.trial_id, "finalized", partition=msg.get("partition_id"),
                                   early_stop=was_early_stop, error=was_error)
        with self._store_lock:
            self._trial_store.pop(trial.trial_id, None)
            self._final_store.append(trial)
        if trial.status == Trial.ERROR and self.controller.pruner is not None:
            # Free the failed run's bracket slot, or its rung never fills.
            self.controller.pruner.report_failure(trial.trial_id)
        self._update_result(trial)
        # Persist BEFORE the hand-off: assigning the last trial flips
        # experiment_done and releases the pool.
        self.env.dump(trial.to_json(), "{}/{}/trial.json".format(self.exp_dir, trial.trial_id))
        self._assign_next(msg["partition_id"], trial)

    def _is_stale_final(self, trial: Trial, msg) -> bool:
        """A FINAL from a run that was declared lost: its run epoch is older
        than the trial's (the trial was requeued, and maybe re-dispatched,
        since), or the trial still waits in the requeue and this partition
        does not hold it. The server cleared the partition's assignment
        before this check when it named the trial, so a retried FINAL of a
        live run never lands here: it finds the trial finalized and gone."""
        epoch = msg.get("epoch")
        with trial.lock:
            if epoch is not None and int(epoch) != trial.run_epoch:
                return True
        with self._store_lock:
            waiting = trial.trial_id in self._requeue
        return waiting and self.server.reservations.get_assigned_trial(
            msg["partition_id"]) != trial.trial_id

    def _lost_msg_callback(self, msg) -> None:
        """A runner went silent while holding a trial: the trial goes back
        into the schedule, ahead of fresh suggestions, for whichever runner
        asks for work next, and the pool kills the runner if it can (one
        wedged in a native call never returns, and would block the pool's
        join). Under the schedule lock, so a racing FINAL of the same trial
        either finalizes it first (then there is nothing to requeue) or
        finds it requeued (then it is dropped as stale)."""
        pid = msg["partition_id"]
        with self._sched_lock:
            trial = self.get_trial(msg["trial_id"])
            if trial is None:
                return
            trial.reset_run_state()
            with self._store_lock:
                if trial.trial_id not in self._requeue:
                    self._requeue.append(trial.trial_id)
            self.telemetry.trial_event(trial.trial_id, "lost", partition=pid)
            # The explicit requeue edge recovery latency derives from.
            self.telemetry.trial_event(trial.trial_id, "requeued", partition=pid,
                                       reason="heartbeat_loss")
            self.telemetry.metrics.counter("recovery.lost_runners").inc()
            self._refresh_recovery()
        self._log("runner {} heartbeat lost; trial {} requeued for reassignment".format(
            pid, trial.trial_id))
        pool = self._active_pool
        if pool is not None and pool.kill_worker(pid):
            self.telemetry.metrics.counter("recovery.killed.p{}".format(pid)).inc()
            self._refresh_recovery()
            self._log("runner {} killed after heartbeat loss (presumed wedged)".format(pid))
        # The dead runner's live gauges must not outlive it.
        self.telemetry.prune_partition(pid)

    def _pop_requeue(self) -> Optional[Trial]:
        """The oldest requeued trial still in the store."""
        with self._store_lock:
            while self._requeue:
                trial = self._trial_store.get(self._requeue.pop(0))
                if trial is not None:
                    return trial
        return None

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
        the experiment is over (ASHA and Hyperband run more trials than
        their rung-0 samples)."""
        if self.experiment_done:
            return
        with self._sched_lock:
            self._assign_next_locked(partition_id, last_trial)
        if self._prefetch_enabled:
            self._suggest_wake.set()

    # locked-by: _sched_lock
    def _assign_next_locked(self, partition_id: int, last_trial: Optional[Trial]) -> None:
        # Requeued trials take priority over fresh suggestions, but never
        # swallow a FINAL report: the controller sees ``last_trial`` first.
        if last_trial is None:
            suggestion = "IDLE"
        elif self._prefetch_enabled:
            # Split contract: report on the FINAL path (dropping schedule-
            # stale prefetches), then take the hand-off from the queue.
            self.controller.report(last_trial)
            self._invalidate_stale_prefetch()
            suggestion = self._next_suggestion()
        else:
            suggestion = self._timed("inline", lambda: self.controller.get_suggestion(last_trial))
        if suggestion in (None, "IDLE"):
            requeued = self._pop_requeue()
            if requeued is not None:
                self.server.reservations.assign_trial(partition_id, requeued.trial_id)
                self.telemetry.trial_event(requeued.trial_id, "assigned",
                                           partition=partition_id, requeue="backlog")
                return
            if last_trial is None:
                suggestion = self._next_suggestion() if self._prefetch_enabled else \
                    self._timed("inline", lambda: self.controller.get_suggestion(None))
        if suggestion is None:
            # Over only once nothing is in flight.
            with self._store_lock:
                in_flight = bool(self._trial_store)
            if not in_flight:
                self.experiment_done = True
                return
            suggestion = "IDLE"
        if suggestion == "IDLE":
            self._rearm_idle(partition_id)
            return
        self._mint_span(suggestion)
        with self._store_lock:
            # Prefetched suggestions entered the store at admission and come
            # back here at dispatch: only another object is a collision.
            existing = self._trial_store.get(suggestion.trial_id)
            self._trial_store[suggestion.trial_id] = suggestion
        if existing is not None and existing is not suggestion:
            self._log("WARNING: controller re-issued in-flight trial id {}; "
                      "the schedule may lose an entry".format(suggestion.trial_id))
        suggestion.set_status(Trial.SCHEDULED)
        self.server.reservations.assign_trial(partition_id, suggestion.trial_id)
        self.telemetry.trial_event(suggestion.trial_id, "assigned", partition=partition_id)

    def _mint_span(self, trial: Trial) -> None:
        """Mint the trial's span when the driver commits to it ("queued")
        and plant the span id in its info_dict: the TRIAL reply ships info,
        so the span travels to the runner and back on its METRICs. The
        queued edge carries the trial's params and scheduler info."""
        with trial.lock:
            sched_info = {k: v for k, v in trial.info_dict.items()
                          if k not in ("span", "partition", "epoch")}
        span = self.telemetry.trial_event(trial.trial_id, "queued", params=trial.params,
                                          trial_type=trial.trial_type, info=sched_info)
        if span is not None:
            with trial.lock:
                trial.info_dict["span"] = span

    # ------------------------------------------- pipelined hand-off (prefetch)

    def _suggester_loop(self) -> None:
        """Keeps up to one pre-materialized suggestion per live runner, so an
        expensive suggest() overlaps with training instead of stalling the
        runner that frees up next. Woken by REG/FINAL/dispatch; the idle
        tick bounds the wake-up latency. A controller exception ends the
        experiment, as it would on the worker thread."""
        while not self.worker_done and not self.experiment_done:
            try:
                refilled = self._refill_prefetch()
            except Exception as exc:  # noqa: BLE001 - surfaced by run_experiment
                self.fail(exc)
                return
            if not refilled:
                self._suggest_wake.wait(constants.DRIVER_IDLE_REQUEUE_TICK_S)
                self._suggest_wake.clear()

    def _prefetch_capacity(self) -> int:
        """One suggestion per live (registered, unreleased) runner, never
        more than the executor clamp."""
        return min(self.num_executors, self.server.reservations.live_count())

    def _refill_prefetch(self) -> bool:
        """One refill attempt; True when a suggestion was materialized."""
        with self._sched_lock:
            if self.experiment_done or len(self._prefetched) >= self._prefetch_capacity():
                return False
            suggestion = self._timed("prefetch", self.controller.suggest)
            if suggestion in (None, "IDLE"):
                return False
            self._admit_prefetched(suggestion)
            return True

    def _timed(self, source: str, suggest):
        """Call the controller's ``suggest`` (or ``get_suggestion``) and
        record it (JAX `:1213-1225`): the calling thread's call count and
        the latency histogram always; for a materialized trial a
        ``suggest`` event with its latency and source and, on the split
        contract (prefetch on), the trial's ``suggested`` span edge."""
        t0 = time.monotonic()
        suggestion = suggest()
        ms = (time.monotonic() - t0) * 1e3
        self.telemetry.metrics.counter(
            _SUGGEST_CALLS + threading.current_thread().name).inc()
        self.telemetry.observe_ms("controller.suggest_ms", ms)
        if suggestion in (None, "IDLE"):
            return suggestion
        self.telemetry.event("suggest", ms=round(ms, 3), source=source,
                             trial=suggestion.trial_id)
        if self._prefetch_enabled:
            self.telemetry.trial_event(suggestion.trial_id, "suggested")
        return suggestion

    # locked-by: _sched_lock
    def _admit_prefetched(self, trial: Trial) -> None:
        """Commit a prefetched suggestion: it enters the trial store now, so
        the controller's capacity checks (BO busy locations, ASHA's in-flight
        rung-0 count) see it as in flight and cannot overshoot."""
        with self._store_lock:
            clash = self._trial_store.get(trial.trial_id)
            self._trial_store[trial.trial_id] = trial
        if clash is not None and clash is not trial:
            self._log("WARNING: controller re-issued trial id {} while it was "
                      "still in flight; the schedule may lose an entry".format(trial.trial_id))
        self._prefetched.append(trial)
        self._prefetch_versions[trial.trial_id] = self.controller.schedule_version

    # locked-by: _sched_lock
    def _invalidate_stale_prefetch(self) -> None:
        """Drop prefetched suggestions minted before the controller's current
        schedule_version: a FINAL that made a promotion available or ended
        the experiment must not be beaten to the runner by an older sample.
        They leave the store and go back through controller.recycle()."""
        version = self.controller.schedule_version
        stale = [t for t in self._prefetched if self._prefetch_versions.get(t.trial_id) != version]
        for trial in stale:
            self._prefetched.remove(trial)
            self._prefetch_versions.pop(trial.trial_id, None)
            with self._store_lock:
                self._trial_store.pop(trial.trial_id, None)
            self.controller.recycle(trial)
        if stale:
            self.telemetry.event("prefetch_invalidated", n=len(stale), version=version,
                                 trials=[t.trial_id for t in stale])
            self.telemetry.metrics.counter("prefetch.invalidated").inc(len(stale))
            self._suggest_wake.set()

    # locked-by: _sched_lock
    def _next_suggestion(self):
        """The oldest still-valid prefetched suggestion, else a live
        suggest() — unless this is the RPC fast path and the controller is
        expensive: then "IDLE", the reply falls back to OK, and the suggester
        refills while the freed runner GET-polls."""
        if self._prefetched:
            trial = self._prefetched.pop(0)
            self._prefetch_versions.pop(trial.trial_id, None)
            self._suggest_wake.set()
            return trial
        if self._inline_depth > 0 and self.controller.SUGGEST_COST == "expensive":
            self._suggest_wake.set()
            return "IDLE"
        return self._timed("inline", self.controller.suggest)

    def pipeline_snapshot(self) -> Dict[str, Any]:
        """The hand-off pipeline's numbers, read back from the telemetry:
        counters from its registry; prefetch hits and misses, suggest
        latencies by source and hand-off gaps by runner from its events."""
        counters = self.telemetry.metrics.snapshot()["counters"]
        suggest_ms = {"prefetch": [], "inline": []}
        handoff_ms: Dict[str, List[float]] = {}
        hits = misses = 0
        for ev in self.telemetry.events():
            if ev.get("ev") == "suggest":
                suggest_ms[ev["source"]].append(ev["ms"])
            elif ev.get("ev") != "trial":
                continue
            elif ev["phase"] == "prefetch_hit":
                hits += 1
            elif ev["phase"] == "prefetch_miss":
                misses += 1
            elif ev["phase"] == "running" and "handoff_ms" in ev:
                handoff_ms.setdefault(str(ev["partition"]), []).append(ev["handoff_ms"])
        return {"prefetch": self._prefetch_enabled, "suggest_ms": suggest_ms,
                "suggest_threads": {k[len(_SUGGEST_CALLS):]: n for k, n in counters.items()
                                    if k.startswith(_SUGGEST_CALLS)},
                "prefetch_hits": hits, "prefetch_misses": misses,
                "invalidated": counters.get("prefetch.invalidated", 0),
                "lock_fallbacks": counters.get("prefetch.lock_fallbacks", 0),
                "handoff_ms": handoff_ms}

    def _refresh_recovery(self) -> None:
        """result's ``lost_runners`` and ``recovery`` blocks, read back from
        the telemetry: counters from its registry, each requeue (trial,
        partition, wall time) from its ``requeued`` span events."""
        with self._result_lock:
            counters = self.telemetry.metrics.snapshot()["counters"]
            killed = sorted(int(k[len(_KILLED):]) for k in counters if k.startswith(_KILLED))
            requeued = [{"trial_id": ev["trial"], "partition": ev["partition"], "at": ev["t"]}
                        for ev in self.telemetry.events()
                        if ev.get("ev") == "trial" and ev["phase"] == "requeued"
                        and ev.get("reason") == "heartbeat_loss"]
            self.result["lost_runners"] = counters.get("recovery.lost_runners", 0)
            self.result["recovery"] = {
                "requeued": requeued,
                "stale_finals_dropped": counters.get("recovery.stale_finals_dropped", 0),
                "killed": killed}

    def stop(self) -> None:
        # Retire the suggester before the base teardown: it must not refill
        # from a stopping controller (a mid-fit one gets the join bound; it
        # is a daemon either way).
        self.experiment_done = True
        self._suggest_wake.set()
        t = self._suggester_thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        super().stop()

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
        self._refresh_recovery()
        self.result["pipeline"] = self.pipeline_snapshot()
        self.env.dump(json.dumps(self.result, indent=2, default=str),
                      self.exp_dir + "/result.json")
        util.build_summary(self.exp_dir, self.env)
        self.maggy_log = self._result_summary(duration)
        # The journal is durable at the finish line: the flusher's cadence
        # must not decide whether the last trials' spans land.
        self.telemetry.event("experiment", phase="finalized", duration_s=duration)
        self.telemetry.flush()
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
                "log_total": log_total, "log_tail": log_tail,
                "pipeline": self.pipeline_snapshot()}
