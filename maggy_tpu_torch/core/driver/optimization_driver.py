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
registry and its span events.

Checkpoint-forking search (``config.fork``, JAX `:163-186, :1362-1366,
:1468-1580, :2010-2256`): a parent-carrying suggestion (ASHA promotion, PBT
segment, BO near-duplicate) whose parent checkpointed is stamped with
``forked_from`` and ``resume_step`` before its ``queued`` edge, journals a
``forked_from`` edge when assigned, is held briefly for the runner that ran
its parent, and is downgraded to a from-scratch run (``requeued``, reason
``fork_source_lost``) when a requeue finds its checkpoint gone; parents the
controller calls spent lose their ``checkpoints/`` dir on a short-lived
thread (``ckpt_gc``). ``preempt_partition`` preempts a runner's trial
gracefully: its ack requeues the trial to resume at its checkpoint (or fork)
step.

Experiment resume and crash-only recovery (``config.resume``, JAX
`:66-76, 387-470, 544-594, 1597-1609`): before the run dir is touched an
unseeded RandomSearch or BO controller is refused; then the finalized
trial.json artifacts are reloaded (with their early stops), the in-flight
half is rebuilt from the journal (``recovery.py``), the controller replays
both (``restore_from_finals``), a pruner reloads its bracket state
(``.pruner_state.json``, written on every scheduling transition) and the
``recovered`` event is journaled; the suggester starts only after that. A
runner that registers on a partition holding a trial (a relaunched runner,
or a resumed driver's runner on a restored slot) takes the BLACK path: the
trial is requeued (reason ``blacklist``) and handed back to that slot,
resuming at its fork or preemption step. Gangs and fleet eviction are not
ported yet.

Vectorized lanes (``config.vmap_lanes`` = K > 1, JAX `:193-231, 489-520,
560-656, 1190-1197, 1420-1475, 1889-2007`): when a runner takes a fresh
suggestion, up to K - 1 compatible prefetched ones (same non-float params,
no resume or checkpoint fork; a BO near-duplicate rides as a fork lane) join
it in one block, delivered to that runner as one TRIAL of its leader. Every
lane keeps its own span, lane-tagged ``assigned``, ``running``,
``first_metric`` and ``finalized`` edges and FINAL; a lane FINAL before the
block's last is reported to the controller at once, and the last hands the
runner its next work. A lost, re-registered or preempted block requeues
every unfinished lane once, as a scalar trial. The prefetch queue holds K
suggestions a runner. K = 1 is the scalar path, journal for journal.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from maggy_tpu_torch import constants, util
from maggy_tpu_torch.config import OptimizationConfig
from maggy_tpu_torch.core.driver import recovery
from maggy_tpu_torch.core.driver.driver import Driver
from maggy_tpu_torch.core.executors.trial_executor import trial_executor_fn
from maggy_tpu_torch.core.rpc import OptimizationServer
from maggy_tpu_torch.core.runner_pool import (GPURunnerPool, ProcessRunnerPool,
                                              ThreadRunnerPool, resolve_num_workers)
from maggy_tpu_torch.earlystop import MedianStoppingRule, NoStoppingRule
from maggy_tpu_torch.optimizers import PBT, Asha, GridSearch, RandomSearch, SingleRun
from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.train.checkpoint import latest_checkpoint_step_env
from maggy_tpu_torch.trial import Trial

#: A parent whose checkpoint step is not looked up yet.
_UNRESOLVED = object()


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
                       "asha": Asha, "pbt": PBT, "tpe": _lazy_tpe, "gp": _lazy_gp,
                       "none": SingleRun}
ES_REGISTRY = {"median": MedianStoppingRule, "none": NoStoppingRule}


class OptimizationDriver(Driver):
    def __init__(self, config: OptimizationConfig, app_id: str, run_id: int):
        self.controller = self._init_controller(config)
        # The pruner must exist before the schedule is sized: it owns
        # num_trials when multi-fidelity.
        self.controller.init_pruner()
        if config.resume:
            # Before super().__init__ registers the experiment dir: a late
            # refusal would already have overwritten the interrupted run's
            # experiment.json.
            self._validate_resume()
        self.num_trials = self._resolve_num_trials(config)
        # A controller whose schedule bounds its concurrency (PBT: members
        # are sequential chains) caps the pool, or excess runners idle.
        max_conc = getattr(self.controller, "max_concurrency", None)
        self.num_executors = min(resolve_num_workers(config), self.num_trials,
                                 max_conc() if max_conc is not None else self.num_trials)
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
        # ---- vectorized lanes (config.vmap_lanes) ----
        self._vmap_lanes = int(config.vmap_lanes)
        # Blocks in flight: leader trial id -> {"lanes": [trial ids in lane
        # order], "partition": pid}; and each lane's leader.
        self._vmap_blocks: Dict[str, Dict[str, Any]] = {}  # guarded-by: _store_lock
        self._lane_leader: Dict[str, str] = {}  # guarded-by: _store_lock
        # Lanes-aware controllers (ASHA's rung drain, BO's fork discount)
        # read this.
        self.controller.vmap_lanes = self._vmap_lanes
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

        # ---- checkpoint-forking search (config.fork) ----
        self._fork_enabled = bool(config.fork)
        # (deadline, preferred partition, trial_id): forked trials held
        # briefly for the runner that ran their parent.
        self._fork_hold: List[tuple] = []  # guarded-by: _store_lock
        # Trials that had their one hold (a second would starve them).
        self._fork_held: set = set()  # guarded-by: _store_lock
        # Parents whose checkpoints were retired (ckpt_gc): once only.
        self._ckpt_gced: set = set()  # guarded-by: _store_lock
        # parent trial id -> its newest checkpoint step (or None): a
        # finalized parent's checkpoints never move, so each is listed once.
        self._fork_step_cache: Dict[str, Optional[int]] = {}  # guarded-by: _store_lock
        if config.resume:
            self._restore_previous_run()
        if self._prefetch_enabled:
            # Started after the restore: the suggester must never sample
            # from a controller whose state is still being rebuilt.
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
        # A fixed combinatorial schedule (PBT: population x generations).
        size = getattr(self.controller, "schedule_size", None)
        if size is not None:
            return size()
        return config.num_trials

    @staticmethod
    def _init_earlystop(config):
        pol = config.es_policy
        if isinstance(pol, str):
            if pol.lower() not in ES_REGISTRY:
                raise ValueError("Unknown es_policy '{}'".format(pol))
            return ES_REGISTRY[pol.lower()]
        return pol

    def _validate_resume(self) -> None:
        from maggy_tpu_torch.optimizers.bayes.base import BaseAsyncBO

        if isinstance(self.controller, (RandomSearch, BaseAsyncBO)) \
                and self.controller.seed is None:
            raise ValueError(
                "resume=True with {} requires a fixed seed: an unseeded rerun presamples a "
                "different schedule and would re-run everything on top of the restored "
                "trials.".format(type(self.controller).__name__))

    def _restore_previous_run(self) -> None:
        """Experiment resume: reload every finalized trial.json of the run
        dir, rebuild the in-flight half from the journal, and let the
        controller and the pruner drop what already ran (JAX `:387-470`)."""
        swept = self.env.sweep_tmp_files(self.exp_dir)
        if swept:
            self._log("resume: swept {} orphaned tmp file(s)".format(swept))
        restored: List[Trial] = []
        for name in sorted(self.env.ls(self.exp_dir)):
            path = "{}/{}/trial.json".format(self.exp_dir, name)
            if not self.env.exists(path):
                continue
            try:
                trial = Trial.from_json(self.env.load(path))
            except (ValueError, KeyError):
                # A torn artifact: the trial was in flight, so it re-runs.
                self._log("resume: skipping unreadable {} (trial will re-run)".format(path))
                continue
            if trial.status == Trial.FINALIZED and trial.final_metric is not None:
                restored.append(trial)
        with self._store_lock:
            self._final_store.extend(restored)
        for trial in restored:
            self._update_result(trial)
        # The resumed result.json covers every trial it claims.
        self.result["early_stopped"] += sum(1 for t in restored if t.early_stop)
        # The in-flight half comes back before the controller's restore, so
        # buffer-backed samplers drop those configs too: they are minted
        # already, and a second suggestion would collide in the store.
        recovered_stats = recovery.recover_optimization_driver(self)
        with self._store_lock:
            inflight = list(self._trial_store.values())
        self.controller.restore_from_finals(restored, inflight=inflight)
        if self.controller.pruner is not None:
            path = self.exp_dir + "/" + constants.PRUNER_STATE_FILE
            if not self.env.exists(path):
                if restored:
                    raise ValueError(
                        "resume=True with a pruner needs the bracket-state checkpoint {}; "
                        "this experiment predates pruner checkpointing.".format(path))
            else:
                self.controller.pruner.load_state_dict(json.loads(self.env.load(path)))
                self.controller.pruner.restore({t.trial_id for t in restored})
        if recovered_stats is not None:
            self.telemetry.event("experiment", phase="recovered", finalized=len(restored),
                                 **recovered_stats)
        self._log("resume: restored {} finalized trials from {}{}".format(
            len(restored), self.exp_dir,
            "; recovered {} in-flight trial(s) across {} partition(s) from the "
            "journal".format(recovered_stats["inflight"],
                             recovered_stats["recovered_partitions"])
            if recovered_stats is not None else ""))

    def _checkpoint_pruner(self) -> None:
        """Persist the multi-fidelity bracket state (a few KB of JSON) so an
        interrupted Hyperband schedule resumes without re-running finalized
        rungs (JAX `:1597-1609`)."""
        pruner = self.controller.pruner
        if pruner is None or not hasattr(pruner, "state_dict"):
            return
        try:
            self.env.dump(json.dumps(pruner.state_dict()),
                          self.exp_dir + "/" + constants.PRUNER_STATE_FILE)
        except Exception:  # noqa: BLE001 - checkpointing must not kill a run
            pass

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
            optimization_key=self.optimization_key, train_fn=train_fn,
            warm_start=self.config.warm_start)

    def _register_msg_callbacks(self) -> None:
        self.message_callbacks.update(
            METRIC=self._metric_msg_callback,
            BLACK=self._blacklist_msg_callback,
            FINAL=self._final_msg_callback,
            IDLE=self._idle_msg_callback,
            REG=self._register_msg_callback,
            LOST=self._lost_msg_callback,
        )

    def get_trial(self, trial_id):
        with self._store_lock:
            return self._trial_store.get(trial_id)

    def block_leader(self, trial_id) -> Optional[str]:
        """The leader of the in-flight block ``trial_id`` rides in, or None."""
        with self._store_lock:
            return self._lane_leader.get(trial_id)

    def vmap_block_lanes(self, leader_id: str) -> List[str]:
        """Lane trial ids of an in-flight block (empty when ``leader_id``
        leads none)."""
        with self._store_lock:
            block = self._vmap_blocks.get(leader_id)
            return list(block["lanes"]) if block else []

    # ------------------------------------------------------------ callbacks

    def _metric_msg_callback(self, msg) -> None:
        """Append a heartbeat metric; early-stop check every es_interval
        steps once es_min trials finalized (reference :331-361). A block's
        beat carries ``lanes``, each entry applied as its own trial's metric,
        so the early-stop rule sees K streams."""
        self.add_executor_logs(msg.get("logs"))
        if msg.get("lanes"):
            for beat in msg["lanes"]:
                self._apply_metric_beat(beat.get("trial_id"), beat.get("value"),
                                        beat.get("step"), msg.get("partition_id"),
                                        lane=beat.get("lane"))
            return
        self._apply_metric_beat(msg.get("trial_id"), msg.get("value"), msg.get("step"),
                                msg.get("partition_id"))

    def _apply_metric_beat(self, trial_id, value, step, partition_id, lane=None) -> None:
        trial = self.get_trial(trial_id)
        if trial is None or value is None:
            return
        if not trial.append_metric(value, step):
            return
        with trial.lock:
            n_steps = len(trial.step_history)
        if n_steps == 1:
            # Time to first signal: running -> first_metric is the trial's
            # start-up cost as the control plane sees it. The lane tag rides
            # only on a block's beats.
            extra = {} if lane is None else {"lane": lane}
            self.telemetry.trial_event(trial.trial_id, "first_metric",
                                       partition=partition_id, **extra)
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
        if msg.get("preempted"):
            # A preemption ack is no finalize: the trial goes back into the
            # schedule and the controller sees no report for it.
            self._preempted_final(msg, trial)
            return
        if trial is None:
            # Duplicate FINAL (a retried send whose reply was lost, or a
            # block's release-shaped FINAL after every lane retired): the
            # result is recorded; the runner still needs work unless it
            # already holds an undelivered assignment.
            if msg.get("block") is not None and msg.get("last"):
                self._drop_block(msg["block"])
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
        # closing edge, journaled before the next assignment. A lane's FINAL
        # is tagged with its lane and block (goodput splits a block by lane).
        extra = {} if msg.get("block") is None else {"lane": msg.get("lane"),
                                                     "block": msg.get("block")}
        self.telemetry.trial_event(trial.trial_id, "finalized", partition=msg.get("partition_id"),
                                   early_stop=was_early_stop, error=was_error, **extra)
        with self._store_lock:
            self._trial_store.pop(trial.trial_id, None)
            self._final_store.append(trial)
        if trial.status == Trial.ERROR and self.controller.pruner is not None:
            # Free the failed run's bracket slot, or its rung never fills.
            self.controller.pruner.report_failure(trial.trial_id)
            self._checkpoint_pruner()
        self._update_result(trial)
        # Persist BEFORE the hand-off: assigning the last trial flips
        # experiment_done and releases the pool.
        self.env.dump(trial.to_json(), "{}/{}/trial.json".format(self.exp_dir, trial.trial_id))
        if msg.get("block") is not None:
            if not msg.get("last"):
                # A lane before the block's last: the partition still holds
                # the block, so nothing is handed off, but the controller
                # sees the result now (and stale prefetches drop).
                with self._store_lock:
                    self._lane_leader.pop(trial.trial_id, None)
                self.controller.report(trial)
                if self._prefetch_enabled:
                    self._invalidate_stale_prefetch()
                self._sweep_fork_gc()
                return
            self._drop_block(msg["block"])
        self._assign_next(msg["partition_id"], trial)
        # After the hand-off (the freed runner never waits on disk): retire
        # the parent checkpoints this FINAL made unforkable.
        self._sweep_fork_gc()

    def _drop_block(self, leader_id: str) -> Optional[Dict[str, Any]]:
        """Forget an in-flight block: its entry (returned) and its lanes'
        leader."""
        with self._store_lock:
            block = self._vmap_blocks.pop(leader_id, None)
            for tid in (block or {}).get("lanes", ()):
                self._lane_leader.pop(tid, None)
        return block

    def _requeue_vmap_block(self, leader_id: str, partition_id, reason: str) -> bool:
        """Tear down a dead block (JAX `:596-635`): every unfinished lane but
        the leader requeues once as a scalar trial (the leader takes the
        caller's own requeue path); finalized lanes stay finalized, and the
        block stamps go. False when ``leader_id`` leads no block."""
        block = self._drop_block(leader_id)
        if block is None:
            return False
        for tid in block["lanes"]:
            trial = self.get_trial(tid)
            if trial is None:
                continue
            with trial.lock:
                trial.info_dict.pop("vmap", None)
                trial.info_dict.pop("vmap_block", None)
                done = trial.final_metric is not None or trial.status == Trial.ERROR
            if done or tid == leader_id:
                continue
            trial.reset_run_state()
            with self._store_lock:
                if tid not in self._requeue:
                    self._requeue.append(tid)
            # Literal reasons, so the journal vocabulary scan sees them.
            if reason == "preempted":
                self.telemetry.trial_event(tid, "requeued", partition=partition_id,
                                           reason="preempted")
            else:
                self.telemetry.trial_event(tid, "requeued", partition=partition_id,
                                           reason="vmap_block_lost")
        return True

    # locked-by: _sched_lock
    def _preempted_final(self, msg, trial: Optional[Trial]) -> None:
        """Requeue a preempted trial (JAX `:1481-1557`). Only a trial whose
        preempt flag is still armed is processed: a retried ack (a lost
        reply) arrives after reset_run_state cleared it and is dropped —
        without fleet eviction (ROADMAP queue 1 item 9) nothing else clears
        the flag. ``step`` is the runner's last checkpoint step: the
        re-dispatch ships it as ``resume_step``; a fork that never
        checkpointed resumes at its fork point; otherwise it re-runs from
        scratch."""
        pid = msg.get("partition_id")
        if trial is None or not trial.get_preempt():
            return
        step = msg.get("step")
        # A preempted block's leader takes its lanes with it: they requeue
        # as scalar trials; the leader follows the path below.
        self._requeue_vmap_block(trial.trial_id, pid, "preempted")
        trial.reset_run_state()
        with trial.lock:
            if step is not None:
                trial.info_dict["resume_step"] = int(step)
            else:
                fork = trial.info_dict.get("forked_from")
                if fork and fork.get("step") is not None:
                    trial.info_dict["resume_step"] = int(fork["step"])
                else:
                    trial.info_dict.pop("resume_step", None)
        with self._store_lock:
            if trial.trial_id not in self._requeue:
                self._requeue.append(trial.trial_id)
        self.result["preemptions"] = self.result.get("preemptions", 0) + 1
        self.telemetry.trial_event(trial.trial_id, "preempted", partition=pid, step=step,
                                   checkpointed=step is not None)
        self.telemetry.trial_event(trial.trial_id, "requeued", partition=pid,
                                   reason="preempted")
        self._log("trial {} preempted on runner {} ({}); requeued".format(
            trial.trial_id, pid,
            "checkpoint step {}".format(step) if step is not None else "no checkpoint"))
        # The runner stays with this experiment: hand it work now, possibly
        # the preempted trial itself, which is the resume path.
        self._assign_next_locked(pid, None)

    def preempt_partition(self, partition_id: int, evict: bool = False) -> Optional[str]:
        """Gracefully preempt whatever ``partition_id`` runs (JAX
        `:1559-1580`): arm the trial's preempt and early-stop flags, so the
        next heartbeat draws STOP(preempt) and the runner acks with a
        preempted FINAL carrying its checkpoint step. Returns the preempted
        trial id, or None when the partition held nothing. Callable from any
        thread: touches only trial and reservation locks."""
        if evict:
            raise NotImplementedError(
                "preempt_partition(evict=True) releases a fleet runner, which is not "
                "ported yet (ROADMAP queue 1 item 9)")
        trial_id = self.server.reservations.get_assigned_trial(partition_id)
        trial = self.get_trial(trial_id) if trial_id else None
        if trial is None:
            return None
        trial.set_preempt()
        trial.set_early_stop()
        self.telemetry.trial_event(trial.trial_id, "preempt_requested",
                                   partition=partition_id, evict=evict)
        return trial.trial_id

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
            # A lost block leader takes its lanes with it, also when its own
            # lane finalized early.
            block = self._requeue_vmap_block(msg["trial_id"], pid, "vmap_block_lost")
            if trial is None and not block:
                return
            if trial is not None:
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
            pid, msg["trial_id"]))
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

    def _blacklist_msg_callback(self, msg) -> None:
        """A runner registered on a partition that holds a trial: its
        predecessor died (or belonged to a crashed driver incarnation). The
        trial is requeued and handed back to this slot at once, resuming as
        the backlog path would: its fork source is verified and a fork or
        preempted trial journals ``resumed`` at its step (JAX `:544-594`,
        without the gang branch)."""
        pid = msg["partition_id"]
        # The partition names a new runner: the dead one's live gauges go.
        self.telemetry.prune_partition(pid)
        with self._sched_lock:
            trial = self.get_trial(msg["trial_id"])
            # A re-registered block leader: the other lanes requeue as
            # scalar trials, the leader (block stamps stripped) comes back
            # to this slot.
            self._requeue_vmap_block(msg["trial_id"], pid, "vmap_block_lost")
            if trial is None:
                # Finalized meanwhile: the slot needs work, not a dead id.
                self.server.reservations.clear_trial_if(pid, msg["trial_id"])
                self._assign_next(pid, None)
                return
            trial.reset_run_state()
            # The requeue edge before the reassignment: recovery latency is
            # read from the journal.
            self.telemetry.trial_event(trial.trial_id, "requeued", partition=pid,
                                       reason="blacklist")
            self._verify_fork_source(trial, pid)
            self.server.reservations.assign_trial(pid, trial.trial_id)
            self.telemetry.trial_event(trial.trial_id, "assigned", partition=pid,
                                       requeue="blacklist")
            self._journal_fork_edge(trial, pid)
            with trial.lock:
                resume_step = trial.info_dict.get("resume_step")
            if resume_step is not None:
                self.telemetry.trial_event(trial.trial_id, "resumed", partition=pid,
                                           from_step=int(resume_step))
        self._log("executor {} restarted; trial {} requeued".format(pid, msg["trial_id"]))

    def _idle_msg_callback(self, msg) -> None:
        """Re-poll the controller after a short tick (reference :419-439),
        unless the partition holds an assignment by now: a recovery nudge
        drained after the slot's REG was served, or an idle tick that
        outlived a re-registration, would otherwise assign over that trial
        and leave it in the store with no runner (the JAX driver does, ROADMAP
        queue 3 item 9)."""
        if self.server.reservations.get_assigned_trial(msg["partition_id"]) is not None:
            return
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
        # A suggestion held for its fork parent's runner leaves this runner
        # free: it pulls again.
        while self._assign_next_once_locked(partition_id, last_trial):
            last_trial = None

    # locked-by: _sched_lock
    def _assign_next_once_locked(self, partition_id: int, last_trial: Optional[Trial]) -> bool:
        """One assignment attempt; True = pull again."""
        # Held forks and requeued trials take priority over fresh
        # suggestions, but never swallow a FINAL report: the controller sees
        # ``last_trial`` first.
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
            held = self._pop_fork_hold(partition_id)
            if held is not None:
                # A fork held for this runner (it ran the parent), or an
                # expired hold any runner may take.
                held.set_status(Trial.SCHEDULED)
                self.server.reservations.assign_trial(partition_id, held.trial_id)
                self.telemetry.trial_event(held.trial_id, "assigned", partition=partition_id,
                                           fork_affinity=True)
                self._journal_fork_edge(held, partition_id)
                return False
            requeued = self._pop_requeue()
            if requeued is not None:
                # A requeued fork must still have its resume point.
                self._verify_fork_source(requeued, partition_id)
                self.server.reservations.assign_trial(partition_id, requeued.trial_id)
                self.telemetry.trial_event(requeued.trial_id, "assigned",
                                           partition=partition_id, requeue="backlog")
                self._journal_fork_edge(requeued, partition_id)
                with requeued.lock:
                    resume_step = requeued.info_dict.get("resume_step")
                if resume_step is not None:
                    # The closing edge of a preemption (or a fork's re-run).
                    self.telemetry.trial_event(requeued.trial_id, "resumed",
                                               partition=partition_id, from_step=int(resume_step))
                return False
            if last_trial is None:
                suggestion = self._next_suggestion() if self._prefetch_enabled else \
                    self._timed("inline", lambda: self.controller.get_suggestion(None))
        if suggestion is None:
            # Over only once nothing is in flight.
            with self._store_lock:
                in_flight = bool(self._trial_store)
            if not in_flight:
                self.experiment_done = True
                return False
            suggestion = "IDLE"
        if suggestion == "IDLE":
            self._rearm_idle(partition_id)
            return False
        self._mint_span(suggestion)
        with self._store_lock:
            # Prefetched suggestions entered the store at admission and come
            # back here at dispatch: only another object, or a finalized
            # trial with this id, is a collision.
            existing = self._trial_store.get(suggestion.trial_id)
            duplicate = (existing is not None and existing is not suggestion) or any(
                t.trial_id == suggestion.trial_id and t.final_metric is not None
                for t in self._final_store)
            self._trial_store[suggestion.trial_id] = suggestion
        if duplicate:
            self._log("WARNING: controller re-issued trial id {} (params hash-collide with "
                      "an in-flight or finalized trial); the schedule may lose an "
                      "entry".format(suggestion.trial_id))
        # The controller just moved its schedule (Hyperband bound the trial
        # to a bracket slot): persist it, so a resume picks the bracket up.
        self._checkpoint_pruner()
        if self._maybe_hold_for_parent(suggestion, partition_id):
            self._log("trial {} held for runner {} (fork parent affinity)".format(
                suggestion.trial_id, self._parent_partition(
                    suggestion.info_dict.get("forked_from", {}).get("trial"))))
            return True
        suggestion.set_status(Trial.SCHEDULED)
        if self._vmap_lanes > 1 and self._assemble_vmap_block_locked(suggestion, partition_id):
            return False
        self.server.reservations.assign_trial(partition_id, suggestion.trial_id)
        self.telemetry.trial_event(suggestion.trial_id, "assigned", partition=partition_id)
        self._journal_fork_edge(suggestion, partition_id)
        return False

    # ------------------------------------------------------ vectorized lanes

    def _vmap_blockable_locked(self, trial: Trial) -> bool:
        """Can the trial ride a block (JAX `:1900-1921`, no gangs here)? Not
        with unhashable params (no program key), nor as a resume or a
        checkpoint fork (a lane restores no state); a BO near-duplicate
        keeps its parent tag and rides as a fork lane, trained from scratch."""
        try:
            hash(tuple(sorted(trial.params.items())))
        except TypeError:
            return False
        with trial.lock:
            info = dict(trial.info_dict)
        if info.get("resume_step") is not None or info.get("forked_from"):
            return False
        if info.get("parent") and not info.get("near_duplicate"):
            return False
        return True

    @staticmethod
    def _vmap_compatible(a: Trial, b: Trial) -> bool:
        """One vmapped program? The driver's proxy for the runner's warm
        key (JAX `:1923-1939`): the same trial type and param names and
        equal non-float values; floats are the stacked axis."""
        if a.trial_type != b.trial_type or set(a.params) != set(b.params):
            return False
        for key, va in a.params.items():
            vb = b.params[key]
            if isinstance(va, float) and isinstance(vb, float):
                continue
            if va != vb:
                return False
        return True

    # locked-by: _sched_lock
    def _assemble_vmap_block_locked(self, leader: Trial, partition_id: int) -> bool:
        """Up to K compatible suggestions, the leader and prefetched ones,
        as one block delivered to ``partition_id`` (JAX `:1941-2007`). True
        = assigned (at least 2 lanes); False = the caller dispatches the
        leader as a scalar trial."""
        if not self._vmap_blockable_locked(leader):
            return False
        lanes = [leader]
        for cand in list(self._prefetched):
            if len(lanes) >= self._vmap_lanes:
                break
            if not self._vmap_blockable_locked(cand) or not self._vmap_compatible(leader, cand):
                continue
            self._prefetched.remove(cand)
            self._prefetch_versions.pop(cand.trial_id, None)
            lanes.append(cand)
        if len(lanes) < 2:
            return False
        self._suggest_wake.set()
        lane_descs = []
        for i, t in enumerate(lanes):
            if i > 0:
                # Admitted but never dispatched: their queued edges now.
                self._mint_span(t)
                t.set_status(Trial.SCHEDULED)
            with t.lock:
                if t.info_dict.get("near_duplicate") and t.info_dict.get("parent"):
                    # A BO near-duplicate rides as a fork lane: a fresh init
                    # beside its parent's family, not a checkpoint restore.
                    t.info_dict.pop("forked_from", None)
                    t.info_dict.pop("resume_step", None)
                    t.info_dict["fork_lane"] = {"parent": t.info_dict["parent"]}
                t.info_dict["vmap"] = {"lane": i, "block": leader.trial_id}
                t.info_dict["epoch"] = t.run_epoch
                lane_descs.append({"trial_id": t.trial_id, "lane": i, "params": dict(t.params),
                                   "span": t.info_dict.get("span"), "epoch": t.run_epoch,
                                   "fork_lane": t.info_dict.get("fork_lane")})
        with leader.lock:
            leader.info_dict["vmap_block"] = {"lanes": lane_descs}
        with self._store_lock:
            self._vmap_blocks[leader.trial_id] = {"lanes": [t.trial_id for t in lanes],
                                                  "partition": partition_id}
            for t in lanes:
                self._lane_leader[t.trial_id] = leader.trial_id
        self.server.reservations.assign_trial(partition_id, leader.trial_id)
        for i, t in enumerate(lanes):
            self.telemetry.trial_event(t.trial_id, "assigned", partition=partition_id, lane=i,
                                       block=leader.trial_id)
        self._log("vmap block {}: {} lanes assigned to runner {}".format(
            leader.trial_id, len(lanes), partition_id))
        return True

    def _mint_span(self, trial: Trial) -> None:
        """Mint the trial's span when the driver commits to it ("queued")
        and plant the span id in its info_dict: the TRIAL reply ships info,
        so the span travels to the runner and back on its METRICs. The
        queued edge carries the trial's params and scheduler info; the fork
        stamp is applied first, so ``forked_from`` and ``resume_step`` land
        on it."""
        self._stamp_fork(trial)
        with trial.lock:
            sched_info = {k: v for k, v in trial.info_dict.items()
                          if k not in ("span", "partition", "epoch")}
        span = self.telemetry.trial_event(trial.trial_id, "queued", params=trial.params,
                                          trial_type=trial.trial_type, info=sched_info)
        if span is not None:
            with trial.lock:
                trial.info_dict["span"] = span

    # -------------------------------------------- checkpoint-forking search

    def _stamp_fork(self, trial: Trial) -> None:
        """Turn a parent-carrying suggestion into a checkpoint fork: when the
        parent left a checkpoint, stamp ``forked_from`` = (parent, step) and
        ``resume_step`` into the trial's info (shipped with the TRIAL), so
        the runner stages the parent's checkpoint and a ctx-aware train
        function resumes at ``step + 1``. A parent without one leaves the
        trial a from-scratch run; config.fork=False stamps nothing."""
        if not self._fork_enabled:
            return
        with trial.lock:
            parent = trial.info_dict.get("parent")
            already = trial.info_dict.get("forked_from")
        if parent is None or already is not None:
            return
        with self._store_lock:
            step = self._fork_step_cache.get(parent, _UNRESOLVED)
        if step is _UNRESOLVED:
            try:
                step = latest_checkpoint_step_env(self.env, "{}/{}".format(self.exp_dir, parent))
            except Exception:  # noqa: BLE001 - an unreadable dir = no fork
                step = None
            with self._store_lock:
                self._fork_step_cache[parent] = step
        if step is None:
            return
        with trial.lock:
            trial.info_dict["forked_from"] = {"trial": parent, "step": int(step)}
            trial.info_dict["resume_step"] = int(step)

    def _journal_fork_edge(self, trial: Trial, partition_id: int) -> None:
        """The lineage edge parent -> child with the forked step, once per
        span (a requeued fork's re-dispatch does not repeat it); ``derive``
        counts it and the trace draws it as a flow arrow."""
        with trial.lock:
            fork = trial.info_dict.get("forked_from")
        if fork:
            self.telemetry.trial_event(trial.trial_id, "forked_from", once=True,
                                       partition=partition_id, parent=fork.get("trial"),
                                       step=fork.get("step"))

    def _verify_fork_source(self, trial: Trial, partition_id: int) -> None:
        """Before re-dispatching a requeued fork: its resume point must still
        exist, as the child's staged copy or the parent's original. A
        vanished source downgrades the trial to from-scratch loudly
        (``requeued``, reason ``fork_source_lost``, fork keys stripped)."""
        with trial.lock:
            fork = trial.info_dict.get("forked_from")
        if not fork:
            return
        step = fork.get("step")
        child = "{}/{}/checkpoints/{}".format(self.exp_dir, trial.trial_id, step)
        parent = "{}/{}/checkpoints/{}".format(self.exp_dir, fork.get("trial"), step)
        try:
            ok = self.env.isdir(child) or self.env.isdir(parent)
        except Exception:  # noqa: BLE001 - unreadable = assume gone
            ok = False
        if ok:
            return
        with trial.lock:
            trial.info_dict.pop("forked_from", None)
            trial.info_dict.pop("resume_step", None)
        self.telemetry.trial_event(trial.trial_id, "requeued", partition=partition_id,
                                   reason="fork_source_lost", parent=fork.get("trial"), step=step)
        self._log("fork source for trial {} (parent {} step {}) vanished; re-running from "
                  "scratch".format(trial.trial_id, fork.get("trial"), step))

    def _parent_partition(self, parent_id: Optional[str]) -> Optional[int]:
        """The partition that last ran (and checkpointed) the parent."""
        return self.telemetry.spans.partition_of(parent_id)

    def _partition_state(self, partition_id: int) -> str:
        """'live', 'silent' (quiet past the loss timeout) or 'released'
        (told GSTOP)."""
        rec = self.server.reservations.get(partition_id)
        if rec is None:
            return "live"  # its REG is still in flight
        if rec.get("released"):
            return "released"
        bound = self.server.hb_loss_timeout
        if bound is not None and self.server.reservations.is_silent(partition_id, bound):
            return "silent"
        return "live"

    # locked-by: _sched_lock
    def _maybe_hold_for_parent(self, trial: Trial, partition_id: int) -> bool:
        """Parent affinity: a fork dispatched while the runner that ran its
        parent is alive is held for that runner, at most once per trial and
        at most FORK_AFFINITY_HOLD_S (then any idle runner takes it). True
        when held: the asking runner pulls its next suggestion."""
        if not self._fork_enabled:
            return False
        with trial.lock:
            fork = trial.info_dict.get("forked_from")
        if not fork:
            return False
        preferred = self._parent_partition(fork.get("trial"))
        if preferred is None or int(preferred) == int(partition_id):
            return False
        with self._store_lock:
            if trial.trial_id in self._fork_held:
                return False
        if self._partition_state(int(preferred)) != "live":
            return False
        with self._store_lock:
            self._fork_held.add(trial.trial_id)
            self._fork_hold.append((time.monotonic() + constants.FORK_AFFINITY_HOLD_S,
                                    int(preferred), trial.trial_id))
        return True

    def _pop_fork_hold(self, partition_id: int) -> Optional[Trial]:
        """A fork held for this partition, or any expired hold."""
        now = time.monotonic()
        with self._store_lock:
            for i, (deadline, preferred, tid) in enumerate(self._fork_hold):
                if preferred != int(partition_id) and now < deadline:
                    continue
                del self._fork_hold[i]
                trial = self._trial_store.get(tid)
                if trial is not None:
                    return trial
        return None

    # locked-by: _sched_lock
    def _sweep_fork_gc(self) -> None:
        """Checkpoint GC: retire a parent's ``checkpoints/`` dir once the
        controller says no live or schedulable child can fork from it any
        more (``fork_gc_eligible``). A trial still in the store or the
        requeue is never touched, and each retirement journals a
        ``ckpt_gc`` event. Only the decision runs here, under the schedule
        lock (on the FINAL fast path that is the RPC thread); the deletions
        run on a short-lived thread."""
        if not self._fork_enabled:
            return
        try:
            candidates = list(self.controller.fork_gc_eligible())
        except Exception:  # noqa: BLE001 - GC is an optimization, never fatal
            return
        todo = []
        with self._store_lock:
            for tid in candidates:
                if tid in self._ckpt_gced or tid in self._trial_store or tid in self._requeue:
                    continue
                # Claimed now, so a racing sweep cannot retire it twice; a
                # failed delete un-claims it for the next sweep.
                self._ckpt_gced.add(tid)
                todo.append(tid)
        if todo:
            threading.Thread(target=self._fork_gc_worker, args=(todo,), daemon=True,
                             name="fork-gc").start()

    def _fork_gc_worker(self, todo: List[str]) -> None:
        """The deletions of a GC sweep, off the hot path and without driver
        locks: a claimed trial is finalized and in no backlog."""
        for tid in todo:
            path = "{}/{}/checkpoints".format(self.exp_dir, tid)
            try:
                had = self.env.isdir(path)
                if had:
                    self.env.delete(path, recursive=True)
            except Exception:  # noqa: BLE001 - a failed delete retries next sweep
                with self._store_lock:
                    self._ckpt_gced.discard(tid)
                continue
            if had:
                with self._store_lock:
                    # A later stamp against this parent must see no checkpoint.
                    self._fork_step_cache[tid] = None
                try:
                    self.telemetry.event("ckpt_gc", trial=tid, why="no_schedulable_child")
                    self._log("ckpt_gc: retired checkpoints of {}".format(tid))
                except Exception:  # noqa: BLE001 - the last sweep may outlive teardown
                    pass

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
        more than the executor clamp; K a runner under vectorized lanes, or
        a one-deep queue would starve block assembly (JAX `:1190-1197`)."""
        return min(self.num_executors, self.server.reservations.live_count()) * self._vmap_lanes

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
        suggest calls per thread from its registry; prefetch hits, misses,
        invalidations and lock fallbacks, suggest latencies by source and
        hand-off gaps by runner from its events, which a resumed experiment
        holds for every incarnation."""
        counters = self.telemetry.metrics.snapshot()["counters"]
        suggest_ms = {"prefetch": [], "inline": []}
        handoff_ms: Dict[str, List[float]] = {}
        hits = misses = invalidated = lock_fallbacks = 0
        for ev in self.telemetry.events():
            if ev.get("ev") == "suggest":
                suggest_ms[ev["source"]].append(ev["ms"])
            elif ev.get("ev") == "prefetch_invalidated":
                invalidated += ev["n"]
            elif ev.get("ev") != "trial":
                continue
            elif ev["phase"] == "prefetch_hit":
                hits += 1
            elif ev["phase"] == "prefetch_miss":
                misses += 1
                lock_fallbacks += bool(ev.get("lock_fallback"))
            elif ev["phase"] == "running" and "handoff_ms" in ev:
                handoff_ms.setdefault(str(ev["partition"]), []).append(ev["handoff_ms"])
        return {"prefetch": self._prefetch_enabled, "suggest_ms": suggest_ms,
                "suggest_threads": {k[len(_SUGGEST_CALLS):]: n for k, n in counters.items()
                                    if k.startswith(_SUGGEST_CALLS)},
                "prefetch_hits": hits, "prefetch_misses": misses,
                "invalidated": invalidated, "lock_fallbacks": lock_fallbacks,
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
