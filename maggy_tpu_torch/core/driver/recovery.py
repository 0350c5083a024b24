"""Crash-only driver recovery: rebuild control-plane state from the journal.

Copy of ``maggy_tpu/core/driver/recovery.py:1-222``. The telemetry journal
is the experiment's replayable source of truth (durable up to the FINAL
path's barrier, tolerant of a torn tail line), and the split report/suggest
optimizer contract makes controller state reconstructible from the FINAL
stream. So a driver that dies mid-sweep restarts with ``resume=True``,
replays its own journal and continues instead of losing the run.

What is replayed, re-adopted and requeued:

- **Replayed** (``replay_recovery_state``, pure over journal events): the
  committed but unfinalized trials, each with its params (journaled on the
  ``queued`` edge), its last run epoch (the ``running`` edge), its last
  holding partition and any preemption checkpoint step; and every
  partition the dead incarnation had registered, with its capacity. Span
  state and the finalized half (trial.json artifacts and
  ``restore_from_finals``) are restored by the driver around this.
- **Re-adopted**: runners that are still alive. The server comes back on
  the same secret and address (``driver_state.json``), and a surviving
  runner's next heartbeat, retried FINAL or GET re-binds it (journaled
  ``adopted``). A retried FINAL of the pre-crash incarnation is accepted
  exactly once: the rebuilt trial carries its pre-crash run epoch, so the
  stale-epoch check passes until a requeue bumps it.
- **Requeued**: trials whose runners died with the driver. Recovery seeds
  the reservation table with the pre-crash assignments and a fresh
  liveness window; a runner that registers again on that partition takes
  the BLACK path, and a silent one is reclaimed by the ordinary loss scan.
  Recovery adds no requeue path of its own.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class TrialFacts:
    """Recovery facts about one trial, accumulated over its journal events
    (oldest first)."""

    __slots__ = ("trial_id", "params", "trial_type", "info", "queued_t",
                 "finalized", "epoch", "partition", "resume_step")

    def __init__(self, trial_id: str):
        self.trial_id = trial_id
        self.params: Optional[Dict[str, Any]] = None
        self.trial_type: str = "optimization"
        self.info: Dict[str, Any] = {}
        self.queued_t: Optional[float] = None
        self.finalized = False
        self.epoch = 0
        #: Partition holding the trial at the journal's end (None: the
        #: attempt ended, requeued, lost or preempted, and was not
        #: re-dispatched).
        self.partition: Optional[int] = None
        self.resume_step: Optional[int] = None


class ReplayedState:
    """The journal's recovery-relevant content: per-trial facts plus the
    dead incarnation's registered partitions (pid -> capacity)."""

    def __init__(self):
        self.trials: Dict[str, TrialFacts] = {}
        self.partitions: Dict[int, Optional[int]] = {}

    def inflight(self) -> List[TrialFacts]:
        """Committed (``queued``) but never finalized, params known: the
        trials recovery must put back into the schedule."""
        return [f for f in self.trials.values()
                if f.queued_t is not None and not f.finalized and f.params is not None]


def replay_recovery_state(events: List[Dict[str, Any]]) -> ReplayedState:
    """Fold a journal of one or more incarnations into ReplayedState. Pure:
    the same events always give the same reconstruction."""
    state = ReplayedState()
    for ev in events:
        kind = ev.get("ev")
        if kind == "runner":
            pid = ev.get("partition")
            if pid is not None:
                if ev.get("phase") == "registered":
                    # Capacity rides only the registered edge; a previous
                    # recovery's ``adopted`` edge carries none and must not
                    # clobber it.
                    state.partitions[int(pid)] = ev.get("capacity")
                else:
                    state.partitions.setdefault(int(pid), None)
            continue
        if kind != "trial":
            continue
        tid = ev.get("trial")
        if not tid:
            continue
        facts = state.trials.get(tid)
        if facts is None:
            facts = state.trials[tid] = TrialFacts(tid)
        phase = ev.get("phase")
        if phase == "queued":
            facts.queued_t = ev.get("t")
            if ev.get("params") is not None:
                facts.params = ev["params"]
                facts.trial_type = ev.get("trial_type", "optimization")
                facts.info = dict(ev.get("info") or {})
        elif phase == "assigned":
            if ev.get("partition") is not None:
                facts.partition = int(ev["partition"])
        elif phase == "running":
            if ev.get("partition") is not None:
                facts.partition = int(ev["partition"])
            if ev.get("epoch") is not None:
                facts.epoch = int(ev["epoch"])
        elif phase in ("requeued", "lost"):
            # The attempt ended; a later ``assigned`` sets the holder again.
            facts.partition = None
        elif phase == "preempted":
            facts.partition = None
            if ev.get("step") is not None:
                facts.resume_step = int(ev["step"])
        elif phase == "finalized":
            facts.finalized = True
    return state


def recover_optimization_driver(driver) -> Optional[Dict[str, Any]]:
    """Apply the journal's replayed state to a freshly constructed, resuming
    OptimizationDriver: rebuild the in-flight half of the trial store,
    re-seed the reservation table with the pre-crash partitions, and queue an
    IDLE nudge for each recovered partition that holds nothing, so an
    adopted idle runner gets work without a REG. Returns the counts for the
    ``recovered`` journal event, or None when there is no journal to
    replay (telemetry off: a resume from the trial.json artifacts alone)."""
    from maggy_tpu_torch.trial import Trial

    if driver.telemetry.journal is None:
        return None
    state = replay_recovery_state(driver.telemetry.events())
    if not state.trials and not state.partitions:
        return None
    with driver._store_lock:
        already_final = {t.trial_id for t in driver._final_store}
    restored_inflight = 0
    requeued = 0
    restored_forks = 0
    held: Dict[int, str] = {}
    for facts in state.inflight():
        if facts.trial_id in already_final:
            # The FINAL's trial.json landed but its journal edge was lost to
            # the crash window: the artifact says the trial is done.
            continue
        trial = Trial(facts.params, trial_type=facts.trial_type)
        if trial.trial_id != facts.trial_id:
            # Params that do not round-trip through JSON would mint another
            # schedule entry: leave it to the controller to derive again.
            driver._log("recovery: journaled params for trial {} do not reproduce its id "
                        "(got {}); leaving it to the controller to re-derive".format(
                            facts.trial_id, trial.trial_id))
            continue
        with trial.lock:
            trial.status = Trial.SCHEDULED
            trial.run_epoch = facts.epoch
            trial.info_dict.update(facts.info)
            if facts.resume_step is not None:
                trial.info_dict["resume_step"] = facts.resume_step
            span = driver.telemetry.spans.span_id(trial.trial_id)
            if span is not None:
                trial.info_dict["span"] = span
        with driver._store_lock:
            driver._trial_store[trial.trial_id] = trial
        restored_inflight += 1
        if facts.info.get("forked_from") is not None:
            # The lineage rode the queued edge (forked_from and resume_step
            # in the journaled info): the rebuilt fork resumes from the same
            # fork point.
            restored_forks += 1
        if facts.partition is not None:
            # The pre-crash holder: a live runner's retried FINAL matches,
            # a re-registered slot takes the BLACK path, a dead one's
            # silence requeues through the loss scan.
            held[facts.partition] = trial.trial_id
        else:
            with driver._store_lock:
                if trial.trial_id not in driver._requeue:
                    driver._requeue.append(trial.trial_id)
            requeued += 1
    res = driver.server.reservations
    for pid, cap in sorted(state.partitions.items()):
        res.restore(pid, trial_id=held.get(pid), capacity=cap)
    for pid in sorted(set(held) - set(state.partitions)):
        res.restore(pid, trial_id=held[pid])
    # An adopted idle runner never registers again, it only GET-polls: one
    # IDLE per recovered partition that holds nothing (drained once the
    # worker starts) routes it through the ordinary assignment path.
    recovered_pids = sorted(set(state.partitions) | set(held))
    for pid in recovered_pids:
        if held.get(pid) is None:
            driver.enqueue({"type": "IDLE", "partition_id": pid, "last_trial": None})
    return {"inflight": restored_inflight, "held_partitions": len(held),
            "backlogged": requeued, "recovered_partitions": len(recovered_pids),
            "forks": restored_forks}
