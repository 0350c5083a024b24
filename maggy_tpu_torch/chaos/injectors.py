"""Chaos engine: runtime fault injection behind no-op-by-default hooks.

The port's copy of ``maggy_tpu/chaos/injectors.py:114-441``. Gangs are not
``kill_gang_member`` kills one non-leader member of an assembled gang.
The hook points live in the port's control-plane seams:

- ``Server._dispatch`` (core/rpc.py) consults ``on_server_message`` for
  drop_msg / delay_msg / sever_conn before (or instead of) handling;
- ``Client._request`` (core/rpc.py) consults ``on_client_request`` — a
  condemned runner dies there (``ChaosKilled``), a cooperatively stalled
  one sleeps;
- ``Server._loop`` calls ``tick()`` between selects for elapsed-time
  triggers;
- ``Telemetry.trial_event`` forwards phase transitions to
  ``on_trial_phase`` for on-state-transition triggers;
- ``LocalEnv.dump`` / ``exclusive_create`` consult
  ``on_env_write`` for transient storage failures;
- runner pools expose ``kill_worker`` / ``stall_worker`` for the
  process-level faults.

Every hook first calls ``active_engine()`` — None (the default, and the
only state outside a chaos soak) short-circuits to a no-op, so the hot
path pays one global read. The engine is armed by the driver when
``config.chaos`` or ``MAGGY_TPU_CHAOS=<plan.json>`` is set, and every
injection it performs is journaled as a telemetry ``chaos`` event so the
soak harness (and offline replay) can line faults up against the trial
spans they disturbed.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from maggy_tpu_torch.chaos.plan import RUNNER_KINDS, FaultPlan, FaultSpec


class ChaosKilled(ConnectionError):
    """Cooperative runner death (thread pools, where nothing can SIGKILL a
    runner). Subclasses ConnectionError ON PURPOSE: the heartbeat loop
    swallows ConnectionError, so a condemned runner's beats go silent —
    exactly the signature of a dead runner — while the executor's
    request-path calls (get_suggestion / finalize_metric) propagate it and
    kill the runner thread for real. ``Client._request`` re-raises it
    immediately instead of burning reconnect retries on a runner that is
    supposed to be dead."""


# ---------------------------------------------------------------- global arm

_ENGINE: Optional["ChaosEngine"] = None


def active_engine() -> Optional["ChaosEngine"]:
    """The armed engine, or None (the no-op default). Read on every hook —
    keep it a bare global load."""
    return _ENGINE


def arm(engine: "ChaosEngine") -> None:
    global _ENGINE
    _ENGINE = engine


def disarm(engine: Optional["ChaosEngine"] = None) -> None:
    """Disarm fault injection. With ``engine`` given, only if it is the
    one armed (a finished soak must not disarm a newer experiment's)."""
    global _ENGINE
    if engine is None or _ENGINE is engine:
        _ENGINE = None


# -------------------------------------------------------------------- engine


class _SpecState:
    """Mutable trigger bookkeeping for one spec."""

    __slots__ = ("spec", "index", "rng", "fired", "matches", "next_after")

    def __init__(self, spec: FaultSpec, index: int, rng):
        self.spec = spec
        self.index = index
        self.rng = rng
        self.fired = 0      # injections performed
        self.matches = 0    # matching occurrences seen (nth/every_nth basis)
        self.next_after = None  # next after_s deadline (periodic re-arm)

    def exhausted(self) -> bool:
        return self.spec.count > 0 and self.fired >= self.spec.count

    def should_fire_on_match(self) -> bool:
        """Advance the occurrence counter and decide. The decision order is
        a pure function of (plan seed, matching-occurrence ordinal), which
        is what makes two runs of the same plan comparable."""
        if self.exhausted():
            return False
        self.matches += 1
        trig = self.spec.trigger
        if "nth" in trig and "on_phase" not in trig:
            return self.matches == int(trig["nth"])
        if "every_nth" in trig:
            return self.matches % int(trig["every_nth"]) == 0
        if "probability" in trig:
            return self.rng.random() < float(trig["probability"])
        if "on_phase" in trig:
            return self.matches == int(trig.get("nth", 1))
        return False


class ChaosEngine:
    """Executes a FaultPlan against a live experiment. Thread-safe: hooks
    run on the RPC event loop, the driver worker, and runner threads."""

    def __init__(self, plan: FaultPlan, telemetry=None):
        self.plan = plan
        self.telemetry = telemetry
        self._lock = threading.RLock()
        self._t0 = time.monotonic()
        self._states = [_SpecState(s, i, plan.rng_for(i))
                        for i, s in enumerate(plan.specs)]
        self.pool = None
        self.reservations = None
        self.driver = None  # preempt_trial acts through the driver
        # Cooperative (thread-pool) fault state, consulted by the client
        # hook: condemned partitions die on their next request; stalled
        # ones sleep until the deadline.
        self._condemned: set = set()  # guarded-by: _lock
        self._stalled_until: Dict[int, float] = {}  # guarded-by: _lock
        # Partitions under an ACTIVE fake preemption (pid -> mute
        # deadline): the driver's loss-reap must not SIGKILL them — the
        # whole point of the fault is a HEALTHY runner declared lost
        # (the duplicate-FINAL race), and reaping would degrade it into
        # a plain kill on process pools.
        self._preempted: Dict[int, float] = {}  # guarded-by: _lock
        #: Injection log: [{"kind", "t", ...}] — the in-memory mirror of
        #: the journaled chaos events (tests assert on it without a
        #: journal round-trip).
        self.injected: List[Dict[str, Any]] = []

    def attach(self, pool=None, reservations=None, driver=None) -> None:
        """Late-bind the fault surfaces: the pool exists only once
        ``run_experiment`` builds it, the reservations once the server
        does; the driver carries the graceful-preemption entry point."""
        with self._lock:
            if pool is not None:
                self.pool = pool
            if reservations is not None:
                self.reservations = reservations
            if driver is not None:
                self.driver = driver

    # ------------------------------------------------------------- hook API

    def on_server_message(self, msg: Dict[str, Any]):
        """Message-level faults, evaluated where a total message order
        exists (the single server event loop — client-side evaluation
        would be per-process and unordered). Returns None, ("drop",),
        ("delay", seconds) or ("sever",)."""
        verb = msg.get("type")
        pid = msg.get("partition_id")
        fired = None
        action = None
        with self._lock:
            for st in self._states:
                spec = st.spec
                if spec.kind not in ("drop_msg", "delay_msg", "sever_conn"):
                    continue
                if not self._match_target(spec, partition=pid, verb=verb):
                    continue
                if st.should_fire_on_match():
                    st.fired += 1
                    # Decision under the lock; the journal write happens
                    # AFTER release — telemetry takes its own locks, and
                    # holding the engine lock across them is an
                    # acquisition edge the canonical order need not
                    # admit.
                    fired = (spec, st.matches)
                    if spec.kind == "drop_msg":
                        action = ("drop",)
                    elif spec.kind == "delay_msg":
                        action = ("delay", spec.delay_s)
                    else:
                        action = ("sever",)
                    break
        if fired is not None:
            spec, occurrence = fired
            self._journal(spec, partition=pid, verb=verb,
                          occurrence=occurrence)
        return action

    def on_client_request(self, msg: Dict[str, Any]) -> None:
        """Runner-side cooperation: a condemned partition dies here, a
        stalled one freezes (both its request thread and its heartbeat
        thread block on their next call — the SIGSTOP analogue threads
        allow). No fault *decisions* are made here."""
        pid = msg.get("partition_id")
        if pid is None:
            return
        with self._lock:
            condemned = pid in self._condemned
            stall_deadline = self._stalled_until.get(pid)
        if stall_deadline is not None:
            remaining = stall_deadline - time.monotonic()
            if remaining > 0:
                time.sleep(remaining)
            else:
                with self._lock:
                    self._stalled_until.pop(pid, None)
        if condemned:
            raise ChaosKilled(
                "chaos: runner {} killed by fault injection".format(pid))

    def on_env_write(self, path: str) -> None:
        """Raises OSError when an env_write_fail fault fires for ``path``.

        The telemetry journal itself is exempt unconditionally: failing
        its flushes would destroy the very artifact the soak invariants
        are checked against (and a match-anything spec would otherwise
        hit it on every flush)."""
        journal = getattr(self.telemetry, "journal", None)
        if journal is not None and path == getattr(journal, "path", None):
            return
        fired = None
        with self._lock:
            for st in self._states:
                spec = st.spec
                if spec.kind != "env_write_fail":
                    continue
                substr = spec.target.get("path")
                if substr and substr not in path:
                    continue
                if st.should_fire_on_match():
                    st.fired += 1
                    fired = (spec, st.matches)
                    break
        if fired is not None:
            # Journal outside the engine lock (telemetry takes its own
            # locks), then raise the injected failure.
            spec, occurrence = fired
            self._journal(spec, path=path, occurrence=occurrence)
            raise OSError(
                "chaos: injected transient write failure for "
                "{}".format(path))

    def on_trial_phase(self, trial_id: str, phase: str,
                       partition: Optional[int]) -> None:
        """On-state-transition triggers (Telemetry.trial_event forwards
        every journaled phase occurrence here)."""
        fire: List[tuple] = []
        with self._lock:
            for st in self._states:
                spec = st.spec
                if spec.kind not in RUNNER_KINDS:
                    continue
                if spec.trigger.get("on_phase") != phase:
                    continue
                if not self._match_target(spec, partition=partition):
                    continue
                # A runner fault needs a runner: phase events journaled
                # without a partition (queued, stop_flagged) cannot
                # target one — skip WITHOUT consuming the occurrence, so
                # "nth" counts only targetable transitions and the fault
                # never lands on an arbitrary wrong runner.
                tpid = spec.target.get("partition", partition)
                if tpid is None:
                    continue
                if st.should_fire_on_match():
                    st.fired += 1
                    fire.append((st, tpid))
        for st, tpid in fire:
            self._fire_runner_fault(st.spec, tpid, trial=trial_id, phase=phase)

    def tick(self) -> None:
        """Elapsed-time triggers; called between server event-loop selects.
        ``after_s`` is periodic under ``count`` > 1: each firing re-arms
        the deadline one interval later (count=3, after_s=10 means three
        fault episodes ~10 s apart, not a 3-shot burst on consecutive
        ticks)."""
        elapsed = time.monotonic() - self._t0
        fire: List[_SpecState] = []
        with self._lock:
            for st in self._states:
                spec = st.spec
                if spec.kind not in RUNNER_KINDS:
                    continue
                after = spec.trigger.get("after_s")
                if after is None or st.exhausted():
                    continue
                if st.next_after is None:
                    st.next_after = float(after)
                if elapsed >= st.next_after:
                    st.fired += 1
                    st.next_after += float(after)
                    fire.append(st)
        for st in fire:
            # target.partition is validated present for after_s runner
            # faults at plan build (a timed fault has no phase event to
            # name its victim).
            self._fire_runner_fault(st.spec, st.spec.target["partition"])

    # ------------------------------------------------------------- internals

    @staticmethod
    def _match_target(spec: FaultSpec, partition=None, verb=None) -> bool:
        want_pid = spec.target.get("partition")
        if want_pid is not None and (partition is None
                                     or int(partition) != int(want_pid)):
            return False
        want_verb = spec.target.get("verb")
        if want_verb is not None and verb != want_verb:
            return False
        return True

    def _fire_runner_fault(self, spec: FaultSpec, partition,
                           trial: Optional[str] = None,
                           phase: Optional[str] = None) -> None:
        pid = int(partition) if partition is not None else 0
        if trial is None and self.reservations is not None:
            # Timed (after_s) faults have no phase event naming a victim:
            # resolve the trial the partition holds NOW, so the journal
            # event carries it and the harness's fault->requeue invariant
            # covers timed kills too.
            try:
                trial = self.reservations.get_assigned_trial(pid)
            except Exception:  # noqa: BLE001 - journaling must never fail a fault
                trial = None
        detail: Dict[str, Any] = {}
        if spec.kind in ("kill_runner", "kill_fork"):
            # Real kill when the pool can (process pools); cooperative
            # connection-death otherwise. Condemn EITHER WAY: a SIGKILLed
            # process cannot race it, and on thread pools it is the kill.
            # kill_fork is the same mechanism with a FORKED victim: the
            # on_phase=forked_from trigger names the runner the forked
            # trial was just dispatched to, so invariant 14 can assert
            # the exactly-once requeue resumes from the same fork point.
            with self._lock:
                self._condemned.add(pid)
            killed = bool(self.pool is not None
                          and self.pool.kill_worker(pid))
            detail["mechanism"] = "sigkill" if killed else "cooperative"
        elif spec.kind == "stall_runner":
            stalled = bool(self.pool is not None and
                           getattr(self.pool, "stall_worker", None) is not None
                           and self.pool.stall_worker(pid, spec.duration_s))
            if not stalled:
                with self._lock:
                    self._stalled_until[pid] = (time.monotonic()
                                                + spec.duration_s)
            detail["mechanism"] = "sigstop" if stalled else "cooperative"
            detail["duration_s"] = spec.duration_s
        elif spec.kind == "preempt_trial":
            # GRACEFUL preemption through the driver: the trial's
            # early-stop machinery carries a preempt-flagged STOP, the
            # runner acks with its last checkpoint step, and the driver
            # requeues the trial to resume there (invariant 7 checks the
            # preempted -> resumed -> single-FINAL chain).
            drv = self.driver
            preempted = None
            if drv is not None \
                    and hasattr(drv, "preempt_partition"):
                try:
                    preempted = drv.preempt_partition(pid, evict=False)
                except Exception:  # noqa: BLE001 - injection must never crash the hook
                    preempted = None
            if preempted is not None:
                trial = preempted
            detail["mechanism"] = "graceful" if preempted is not None \
                else "noop"
        elif spec.kind == "kill_gang_member":
            # Kill one non-leader member of the trial's assembled gang (the
            # on_phase=gang_assembled event's partition is the leader;
            # killing the leader is kill_runner's LOST path): the lowest
            # member id that is not the triggering partition, or the
            # triggering partition when the gang is gone by now, so the
            # injection is journaled either way.
            members: List[int] = []
            if self.driver is not None and trial is not None:
                try:
                    members = [int(m) for m in self.driver.gang_members(trial)
                               if int(m) != pid]
                except Exception:  # noqa: BLE001 - injection must never crash the hook
                    members = []
            victim = min(members) if members else pid
            with self._lock:
                self._condemned.add(victim)
            killed = bool(self.pool is not None and self.pool.kill_worker(victim))
            detail["mechanism"] = "sigkill" if killed else "cooperative"
            detail["leader"] = pid
            pid = victim
        elif spec.kind == "fake_preemption":
            # The runner stays alive; only the driver's view of its
            # heartbeats is aged — the falsely-declared-lost race. The
            # mute window (duration_s, set >= hb_loss_timeout in plans)
            # keeps the runner's ongoing beats from refreshing last_beat
            # before the loss scan looks.
            if self.reservations is not None:
                self.reservations.age_beat(pid, 3600.0,
                                           mute_s=spec.duration_s)
            with self._lock:
                self._preempted[pid] = time.monotonic() + spec.duration_s
            detail["mechanism"] = "aged_heartbeat"
            detail["mute_s"] = spec.duration_s
        self._journal(spec, partition=pid, trial=trial, phase=phase, **detail)

    def _journal(self, spec: FaultSpec, **fields: Any) -> None:
        record = {"kind": spec.kind, "t": time.time(),
                  **{k: v for k, v in fields.items() if v is not None}}
        with self._lock:
            self.injected.append(record)
        telem = self.telemetry
        if telem is not None:
            telem.event("chaos", **{k: v for k, v in record.items()
                                    if k != "t"})

    def suppress_reap(self, partition) -> bool:
        """True while ``partition`` is under an active fake preemption:
        the driver's heartbeat-loss reap must leave the (healthy) runner
        alive so it can deliver the duplicate FINAL the fault exists to
        provoke."""
        if partition is None:
            return False
        with self._lock:
            deadline = self._preempted.get(int(partition))
            if deadline is None:
                return False
            if time.monotonic() > deadline:
                del self._preempted[int(partition)]
                return False
            return True

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            by_kind: Dict[str, int] = {}
            for rec in self.injected:
                by_kind[rec["kind"]] = by_kind.get(rec["kind"], 0) + 1
            return {"injected": len(self.injected), "by_kind": by_kind}
