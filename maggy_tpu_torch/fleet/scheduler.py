"""Shared-fleet scheduler: multiplex concurrent experiments over one
persistent runner fleet.

The port's copy of ``maggy_tpu/fleet/scheduler.py``: ``FleetSaturated``,
``priority_rank``, ``FleetPolicy``, ``ExperimentEntry``, ``FleetScheduler``
(targets, admission, shedding, ``next_binding``, preemption),
``FleetSubmission``, ``FleetBinding``, ``FleetLeasedPool``, ``Fleet`` and
``replay_fleet_journal``, with the same decisions and the same journal
vocabulary, so either package replays the other's ``fleet.jsonl``. Its
runners are thread runners of this process; on the card they share its
CUDA context, and a runner re-bound to another tenant keeps the process's
warm cache (``train/warm.py``), whose slots key by program. With
``max_agents > 0`` agent processes (``fleet/agent.py``) join as runners in
agent slots, each with its own CUDA context; the journal sink
(``telemetry/sink.py``) is on whenever the fleet's telemetry is, and a
tenant with ``config.sink`` ships its journal to it. Gang blocks (JAX
`scheduler.py:272-280, 449-456, 601-690`): ``request_gang`` reserves an
aligned, sticky, disjoint block of fleet runners for a tenant's gangs (an
oversized gang is refused); a runner inside a block binds only to its
owner and is never carved out of it by a preemption; a failed tenant's
block is parked for ``tenant_grace_s`` so its restarted driver reclaims
it, and expires to fair share after; ``FleetBinding.request_gang`` /
``release_gang`` and ``FleetLeasedPool.chip_of`` give the driver its
block and each partition's fleet runner.

The classic ``lagom()`` path owns its runner pool for the lifetime of one
experiment and tears it down afterwards — a host serving many users sits
idle between sweeps. Fleet mode inverts the ownership (the Podracer
shape, arXiv:2104.06272): a ``Fleet`` holds a long-lived pool of runner
loops, and a ``FleetScheduler`` leases them to whichever submitted
experiments deserve them under

- **priority classes** (``high``/``normal``/``low`` or any int; lower rank
  wins) — capacity is granted strictly by class when computing targets;
- **weighted fair share** — within the capacity a class receives, runners
  are split proportionally to each experiment's ``weight`` (largest
  remainder), and lease-time accounting (virtual time = runner-seconds /
  weight) breaks ties so long-run shares track the weights even when
  allocation is lumpy;
- **per-experiment quotas** — ``min_runners`` is satisfied first (in
  priority order), ``max_runners`` caps what fair share may grant;
- an **admission queue** — at most ``max_active`` experiments compete at
  once; the rest wait in (priority, submit-order) line;
- **preemption** — an experiment below its guaranteed allocation for
  longer than ``preempt_grace_s`` triggers a *graceful* preemption of the
  most-over-share victim: the victim driver flags the trial through the
  existing early-stop machinery (the STOP reply carries ``preempt``), the
  runner acks with a preempted FINAL carrying its last checkpoint step
  (``train/checkpoint.py`` layout), the driver requeues the trial so it
  *resumes from that step* on its next runner (requeue-from-scratch when
  it never checkpointed), and the freed runner re-binds to the starving
  experiment.

Runners are re-bindable: one fleet runner executes experiment A's trial
executor until released (GSTOP or eviction), then asks the scheduler for
its next binding and re-registers against experiment B's server with B's
secret and executor config. Per-experiment control-plane traffic shares
ONE listening socket (``core.rpc.SharedServer``), routed by which
experiment's HMAC secret authenticates the frame.

Everything the scheduler decides is journaled to ``fleet.jsonl``
(``lease`` start/end, ``preempt``, admission, lifecycle), so shares,
queue waits, and preemption counts are replayable offline
(``replay_fleet_journal``) and renderable as per-experiment lanes on each
runner track (``python -m maggy_tpu_torch.telemetry trace <fleet_home>``).
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from maggy_tpu_torch.core.runner_pool import RunnerPool, ThreadRunnerPool

#: Fleet journal filename inside the fleet home dir.
FLEET_JOURNAL_NAME = "fleet.jsonl"

#: Named priority classes (lower rank = served first). Ints pass through.
PRIORITY_CLASSES = {"high": 0, "normal": 1, "low": 2}

#: How long a computed fair-share target table may be reused before the
#: next binding/preemption decision recomputes it. Structural changes
#: (admit/finish/activate) invalidate it immediately; the TTL only covers
#: live-read drift (a driver flipping experiment_done between ticks),
#: and matches the scheduler's own 0.1-0.2 s decision cadence.
TARGETS_TTL_S = 0.05


class FleetSaturated(RuntimeError):
    """Admission shedding: the fleet's submission queue is at its
    ``max_queued`` bound — the submission was refused (and journaled as
    a ``shed`` event) instead of queued unboundedly. Callers back off
    and resubmit; the spool feeder simply leaves specs unclaimed until
    the queue drains."""


def _base_name(name: str) -> str:
    """A resubmitted tenant's scheduler name carries a ``-<seq>`` dedup
    suffix (Fleet.submit); failover matching (parked gang blocks) keys on
    the base name, so the restarted submission finds its block."""
    stem, sep, tail = name.rpartition("-")
    if sep and tail.isdigit():
        return stem
    return name


def priority_rank(priority) -> int:
    if isinstance(priority, str):
        try:
            return PRIORITY_CLASSES[priority.lower()]
        except KeyError:
            raise ValueError(
                "Unknown priority {!r}; use one of {} or an int".format(
                    priority, sorted(PRIORITY_CLASSES)))
    if isinstance(priority, bool) or not isinstance(priority, int):
        raise ValueError("priority must be a class name or int, got "
                         "{!r}".format(priority))
    return priority


class FleetPolicy:
    """Scheduling policy of one submission: priority class, fair-share
    weight, and the min/max runner quota."""

    __slots__ = ("priority", "weight", "min_runners", "max_runners")

    def __init__(self, priority="normal", weight: float = 1.0,
                 min_runners: int = 0, max_runners: Optional[int] = None):
        priority_rank(priority)  # validate early
        self.priority = priority
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError("weight must be > 0, got {}".format(weight))
        self.min_runners = int(min_runners)
        if self.min_runners < 0:
            raise ValueError("min_runners must be >= 0")
        self.max_runners = None if max_runners is None else int(max_runners)
        if self.max_runners is not None and self.max_runners < 1:
            raise ValueError("max_runners must be >= 1 (or None)")
        if self.max_runners is not None \
                and self.min_runners > self.max_runners:
            raise ValueError("min_runners {} exceeds max_runners {}".format(
                self.min_runners, self.max_runners))

    @property
    def rank(self) -> int:
        return priority_rank(self.priority)

    def to_dict(self) -> Dict[str, Any]:
        return {"priority": self.priority, "weight": self.weight,
                "min_runners": self.min_runners,
                "max_runners": self.max_runners}


class ExperimentEntry:  # guarded-by: FleetScheduler._lock
    """One submitted experiment's scheduling state. All mutable fields are
    guarded by the scheduler's lock (class-line annotation: the guards
    checker treats the whole class as externally synchronized)."""

    def __init__(self, name: str, policy: FleetPolicy, seq: int):
        self.name = name
        self.policy = policy
        self.seq = seq
        self.state = "queued"  # queued -> active -> done | failed
        self.submitted_t = time.time()
        self.admitted_t: Optional[float] = None
        self.first_lease_t: Optional[float] = None
        # Dotted module:function path of the submission's train fn (set
        # at submit when derivable) — what an ABIND lease ships to a
        # REMOTE agent. None = agent-ineligible (closure/lambda/__main__
        # train fns can't be named on the wire): only thread runners
        # serve this experiment.
        self.train_fn_path: Optional[str] = None
        # Built at activate(): the executor config an agent lease
        # carries (secret, hb_interval, exp_dir, ..., train_fn). None =
        # agent-ineligible.
        self.agent_info: Optional[Dict[str, Any]] = None
        # Bound at activate() (the driver exists by then):
        self.driver = None
        self.executor_fn: Optional[Callable[[int], None]] = None
        self.slots = 0
        self.free_pids: set = set()
        self.exp_dir: Optional[str] = None
        # Lease accounting.
        self.open_leases: Dict[int, Tuple[int, float]] = {}  # runner -> (pid, t0)
        self.service_s = 0.0
        self.lease_count = 0
        self.preemptions = 0          # suffered
        self.preempting_pids: set = set()
        self.failures: List[BaseException] = []
        self.deficit_since: Optional[float] = None

    # -- read helpers (scheduler lock held) --------------------------------

    def allocated(self) -> int:
        return len(self.open_leases)

    def effective_max(self, fleet_size: int) -> int:
        cap = fleet_size
        if self.policy.max_runners is not None:
            cap = min(cap, self.policy.max_runners)
        if self.slots:
            cap = min(cap, self.slots)
        return cap

    def chip_seconds(self, now: float) -> float:
        """Total chip-time this tenant has held: closed leases
        (``service_s``) plus the live time of every still-open lease.
        Fleet runners lease one chip each, so lease-seconds ==
        chip-seconds; the goodput ledger divides this same number into
        train vs badput buckets from the tenant's own journal."""
        live = sum(now - t0 for _, t0 in self.open_leases.values())
        return self.service_s + live

    def vtime(self, now: float) -> float:
        return self.chip_seconds(now) / self.policy.weight

    def ready(self) -> bool:
        return self.state == "active" and self.executor_fn is not None

    def wants_runners(self) -> bool:
        if not self.ready() or not self.free_pids:
            return False
        drv = self.driver
        return not (drv is not None and drv.experiment_done)

    def snapshot(self) -> Dict[str, Any]:
        qw = None
        if self.first_lease_t is not None:
            qw = round(self.first_lease_t - self.submitted_t, 3)
        return {"name": self.name, "state": self.state,
                **self.policy.to_dict(),
                "allocated": self.allocated(), "leases": self.lease_count,
                "service_s": round(self.service_s, 3),
                "chip_seconds": round(self.chip_seconds(time.monotonic()),
                                      3),
                "preemptions": self.preemptions,
                "queue_wait_s": qw, "failures": len(self.failures),
                "exp_dir": self.exp_dir}


class FleetScheduler:
    """Decides which experiment each free fleet runner serves next, and
    when a running one must give a runner up. Pure in-process state; every
    decision is journaled through the fleet's telemetry."""

    def __init__(self, fleet_size: int, telemetry=None,
                 max_active: Optional[int] = None,
                 preempt_grace_s: float = 1.0,
                 max_queued: Optional[int] = None,
                 max_size: Optional[int] = None,
                 tenant_grace_s: float = 10.0):
        self.fleet_size = int(fleet_size)
        # The size the fleet can grow to as agents join (thread runners and
        # agent slots): a gang that fits once the agents arrive must park,
        # not fail.
        self.max_size = int(max_size) if max_size is not None else self.fleet_size
        self.telemetry = telemetry
        self.max_active = max_active
        self.max_queued = max_queued
        self.preempt_grace_s = float(preempt_grace_s)
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._entries: Dict[str, ExperimentEntry] = {}  # guarded-by: _lock
        # Indexes keeping every per-decision sweep O(active), not
        # O(submitted): the ADMITTED set (binding, targets, preemption
        # all iterate only this — at most max_active entries no matter
        # how many hundreds sit queued behind it) and the admission
        # queue as a (rank, seq) heap popped lazily, so admitting one
        # experiment is O(log queued) instead of re-sorting every
        # queued entry per submit/finish.
        self._active: Dict[str, ExperimentEntry] = {}  # guarded-by: _lock
        self._queued_heap: List[Tuple[int, int, str]] = []  # guarded-by: _lock
        self._queued_count = 0  # guarded-by: _lock
        # Cached fair-share target table (the waterfill is O(active *
        # rounds)): invalidated on structural change, TTL-bounded
        # otherwise, so a burst of next_binding calls between changes
        # shares one computation.
        self._targets_cache: Optional[Dict[str, int]] = None  # guarded-by: _lock
        self._targets_stamp = 0.0  # guarded-by: _lock
        self.shed_count = 0  # guarded-by: _lock
        # Final snapshots of completed experiments (bounded): finished
        # entries leave _entries so scheduling decisions stay O(live)
        # and a long-lived fleet host doesn't grow without bound.
        self._finished: List[Dict[str, Any]] = []  # guarded-by: _lock
        # Gang blocks: experiment name -> the contiguous fleet runners
        # reserved for its gang trials. A runner inside a block binds only
        # to its owner (and is shielded from preemption), so the owner's
        # driver can assemble an N-chip block without fair share starving
        # the gang at N-1 members.
        self._gang_blocks: Dict[str, List[int]] = {}  # guarded-by: _lock
        # A failed tenant's block, parked for tenant_grace_s so a restarted
        # driver (matched by base name) reclaims it: base name -> (block,
        # monotonic expiry).
        self.tenant_grace_s = float(tenant_grace_s)
        self._parked_blocks: Dict[str, Tuple[List[int], float]] = {}  # guarded-by: _lock
        # Warm prewarming hints: agent slot -> the program-family key
        # (the submission's dotted train-fn path) it last served — the
        # binding pick prefers handing an agent a same-family experiment
        # so its per-process warm slots (train/warm.py) stay hot.
        self._slot_family: Dict[int, str] = {}  # guarded-by: _lock
        # Parent affinity (checkpoint-forking search): agent slot -> the
        # EXPERIMENT it last served. A re-lease to the same experiment
        # is strictly warmer than same-family: the agent holds that
        # experiment's warm slots AND its parents' trial checkpoints on
        # local disk, so a forked promotion staged there loads without a
        # cross-process copy. Ranked above family, below fair share.
        self._slot_exp: Dict[int, str] = {}  # guarded-by: _lock
        # Remote-agent runner slots (maggy_tpu.fleet.agent): indexes at
        # and above the thread-fleet size, allocated as agents join.
        # Vacant slots (their agent left/died) stay allocated — indexes
        # are identities in the journal — but stop counting toward
        # fair-share capacity until the next joiner reuses them.
        self._agent_slots: set = set()  # guarded-by: _lock
        self._vacant_agent_slots: set = set()  # guarded-by: _lock
        self._seq = itertools.count()
        self.stopped = False

    # ------------------------------------------------------------ lifecycle

    def submit(self, name: str, policy: FleetPolicy) -> ExperimentEntry:
        with self._lock:
            if name in self._entries:
                raise ValueError(
                    "experiment {!r} is already submitted to this "
                    "fleet".format(name))
            if self.max_queued is not None \
                    and self._queued_count >= self.max_queued:
                # Admission shedding: refuse instead of queueing without
                # bound — a saturated control plane must say so, not
                # absorb submissions into an ever-slower backlog.
                self.shed_count += 1
                self._event("shed", exp=name, scope="admission",
                            queued=self._queued_count)
                telem = self.telemetry
                if telem is not None:
                    telem.metrics.counter("fleet.shed_total").inc()
                raise FleetSaturated(
                    "fleet admission queue is full ({} queued, bound {}); "
                    "submission {!r} shed — resubmit after the queue "
                    "drains".format(self._queued_count, self.max_queued,
                                    name))
            entry = ExperimentEntry(name, policy, next(self._seq))
            self._entries[name] = entry
            self._queued_count += 1
            heapq.heappush(self._queued_heap,
                           (policy.rank, entry.seq, name))
            self._event("fleet_submit", exp=name, **policy.to_dict())
            self._admit_locked()
            self._wake.notify_all()
        return entry

    # locked-by: _lock
    def _admit_locked(self) -> None:
        """Admit from the (rank, seq) heap up to ``max_active``. Heap
        entries are popped lazily: an entry that finished (or was never
        created) while queued is skipped, so admission stays O(log
        queued) per admit with no rebuild on finish."""
        while self._queued_heap:
            if self.max_active is not None \
                    and len(self._active) >= self.max_active:
                break
            _rank, _seq, name = heapq.heappop(self._queued_heap)
            entry = self._entries.get(name)
            if entry is None or entry.state != "queued":
                continue  # finished/failed while queued: lazy deletion
            entry.state = "active"
            entry.admitted_t = time.time()
            self._active[name] = entry
            self._queued_count -= 1
            self._targets_cache = None
            self._event("fleet_admit", exp=entry.name,
                        queued_s=round(entry.admitted_t
                                       - entry.submitted_t, 3))

    def activate(self, entry: ExperimentEntry, driver,
                 executor_fn: Callable[[int], None], slots: int) -> None:
        """The experiment's driver is up: bind it so leasing can begin.
        ``slots`` is the driver's partition-id range (its server's
        num_executors)."""
        agent_info = self._build_agent_info(entry, driver)
        with self._lock:
            entry.driver = driver
            entry.executor_fn = executor_fn
            entry.agent_info = agent_info
            entry.slots = int(slots)
            entry.free_pids = set(range(int(slots)))
            entry.exp_dir = getattr(driver, "exp_dir", None)
            self._targets_cache = None
            self._event("fleet_experiment", exp=entry.name, phase="start",
                        slots=entry.slots, exp_dir=entry.exp_dir)
            self._wake.notify_all()

    @staticmethod
    def _build_agent_info(entry: ExperimentEntry,
                          driver) -> Optional[Dict[str, Any]]:
        """The executor config an ABIND lease ships to a remote agent —
        the fleet generalization of the per-experiment JOIN reply. None
        when the experiment can't be served remotely: no wire-nameable
        train fn, or a driver without the trial-executor loop shape
        (only HPO/ablation drivers lease agents today)."""
        if entry.train_fn_path is None:
            return None
        okey = getattr(driver, "optimization_key", None)
        if okey is None:
            return None
        return {
            "secret": driver.secret_for_clients(),
            "hb_interval": driver.hb_interval,
            "exp_dir": driver.exp_dir,
            "optimization_key": okey,
            "trial_type": "optimization",
            # Warm slots are per process: the flag keeps them across
            # same-family re-leases within one agent process.
            "warm_start": bool(getattr(driver.config, "warm_start", True)),
            "train_fn": entry.train_fn_path,
            # The experiment's program-family key (prewarming hints):
            # the scheduler prefers re-leasing an agent to the family it
            # last served, and the agent journals the key so warm-hint
            # accuracy is auditable end to end.
            "family": entry.train_fn_path,
        }

    def wait_admitted(self, entry: ExperimentEntry,
                      timeout: Optional[float] = None) -> bool:
        """Block until ``entry`` is admitted past the queue (True) or the
        fleet stops / the entry finishes first (False). The deferred-
        activation hook: a submission thread builds its driver only after
        this returns True, so a thousand queued tenants cost a thousand
        heap entries — not a thousand live drivers."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if entry.state == "active":
                    return True
                if self.stopped or entry.state in ("done", "failed"):
                    return False
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                    self._wake.wait(timeout=min(left, 0.2))
                else:
                    self._wake.wait(timeout=0.2)

    def finish(self, entry: ExperimentEntry, state: str = "done") -> None:
        with self._lock:
            if entry.state in ("done", "failed"):
                return
            was_queued = entry.state == "queued"
            entry.state = state
            if was_queued:
                self._queued_count -= 1  # heap entry reaped lazily
            else:
                self._active.pop(entry.name, None)
            self._targets_cache = None
            self._event("fleet_experiment", exp=entry.name, phase=state)
            # A finished tenant's block must not hold runners forever; a
            # failed one's is parked for its restart's grace.
            block = self._gang_blocks.pop(entry.name, None)
            if block is not None:
                if state == "failed" and self.tenant_grace_s > 0:
                    self._parked_blocks[_base_name(entry.name)] = (
                        block, time.monotonic() + self.tenant_grace_s)
                    self._event("pack", op="fleet_park", exp=entry.name, block=block,
                                grace_s=self.tenant_grace_s)
                else:
                    self._event("pack", op="fleet_release", exp=entry.name)
            # Retire the entry: late release_binding calls still work on
            # the object itself; only the scheduling/status sets forget
            # it. Keep a bounded tail of final snapshots for status.json.
            self._entries.pop(entry.name, None)
            self._finished.append(entry.snapshot())
            del self._finished[:-100]
            self._admit_locked()
            self._wake.notify_all()

    def stop(self) -> None:
        with self._lock:
            self.stopped = True
            self._wake.notify_all()

    # ---------------------------------------------------------- agent slots

    def agent_slot_attach(self) -> int:
        """Allocate a runner index for a joining remote agent: reuse the
        lowest vacant agent slot, else grow the fleet by one. The index
        behaves exactly like a thread runner's in every lease path."""
        with self._lock:
            if self._vacant_agent_slots:
                idx = min(self._vacant_agent_slots)
                self._vacant_agent_slots.discard(idx)
            else:
                idx = self.fleet_size
                self.fleet_size += 1
                self._agent_slots.add(idx)
            self._targets_cache = None
            self._wake.notify_all()
            return idx

    def agent_slot_detach(self, runner_idx: int) -> None:
        """The slot's agent left or was lost: the index stops counting
        toward fair-share capacity until the next joiner reuses it. Its
        warm-family hint dies with the process — the NEXT joiner reusing
        this index is a fresh interpreter with cold slots, and a stale
        hint would fake warmth."""
        with self._lock:
            if runner_idx in self._agent_slots:
                self._vacant_agent_slots.add(runner_idx)
                self._slot_family.pop(runner_idx, None)
                self._slot_exp.pop(runner_idx, None)
                self._targets_cache = None
                self._wake.notify_all()

    def is_agent_slot(self, runner_idx: int) -> bool:
        with self._lock:
            return runner_idx in self._agent_slots

    def live_agent_slots(self) -> int:
        with self._lock:
            return len(self._agent_slots) - len(self._vacant_agent_slots)

    # -------------------------------------------------------------- targets

    # locked-by: _lock
    def _targets_locked(self) -> Dict[str, int]:
        """Cached wrapper around the fair-share waterfill: structural
        changes (admit/finish/activate) clear the cache; otherwise a
        short TTL bounds staleness to the scheduler's own decision
        cadence. Keeps a burst of binding decisions from recomputing an
        identical table per free runner."""
        now = time.monotonic()
        cached = self._targets_cache
        if cached is not None and now - self._targets_stamp < TARGETS_TTL_S:
            return cached
        targets = self._compute_targets_locked()
        self._targets_cache = targets
        self._targets_stamp = now
        return targets

    # locked-by: _lock
    def _compute_targets_locked(self) -> Dict[str, int]:
        """Per-experiment runner target: min_runners first in priority
        order, then leftover capacity waterfilled class by class with a
        weighted largest-remainder split, clamped to each experiment's
        effective max. This is the allocation both binding and preemption
        steer toward. Iterates the ADMITTED index only — queued tenants
        cannot deserve runners, so they must not cost sweep time."""
        active = [e for e in self._active.values()
                  if e.ready() and not (e.driver is not None
                                        and e.driver.experiment_done)]
        targets = {e.name: 0 for e in active}
        # Vacant agent slots hold no runner: capacity they'd promise can
        # never be leased, so the waterfill excludes them.
        remaining = self.fleet_size - len(self._vacant_agent_slots)
        # Guaranteed minimums, strictly by priority then submit order.
        for e in sorted(active, key=lambda e: (e.policy.rank, e.seq)):
            give = min(e.policy.min_runners, e.effective_max(self.fleet_size),
                       remaining)
            targets[e.name] = give
            remaining -= give
        # Leftovers: class by class, weighted largest remainder.
        by_rank: Dict[int, List[ExperimentEntry]] = {}
        for e in active:
            by_rank.setdefault(e.policy.rank, []).append(e)
        for rank in sorted(by_rank):
            if remaining <= 0:
                break
            members = by_rank[rank]
            while remaining > 0:
                head = [e for e in members
                        if targets[e.name] < e.effective_max(self.fleet_size)]
                if not head:
                    break
                wsum = sum(e.policy.weight for e in head)
                grant = {}
                for e in head:
                    grant[e.name] = remaining * e.policy.weight / wsum
                floors = {n: int(g) for n, g in grant.items()}
                used = 0
                for e in head:
                    room = e.effective_max(self.fleet_size) - targets[e.name]
                    add = min(floors[e.name], room)
                    targets[e.name] += add
                    used += add
                if used == 0:
                    # All floors were zero: hand single runners out by
                    # largest fractional remainder until spent.
                    order = sorted(
                        head, key=lambda e: (-(grant[e.name]
                                               - floors[e.name]), e.seq))
                    for e in order:
                        if remaining - used <= 0:
                            break
                        if targets[e.name] < e.effective_max(self.fleet_size):
                            targets[e.name] += 1
                            used += 1
                if used == 0:
                    break
                remaining -= used
        return targets

    # ---------------------------------------------------------- gang blocks

    def request_gang(self, entry: ExperimentEntry,
                     size: int) -> Optional[List[int]]:
        """Reserve a contiguous block of ``size`` fleet runners for
        ``entry``'s gang trials: among windows disjoint from other tenants'
        blocks (and parked ones), size-aligned first, the one with the
        fewest runners bound elsewhere, lowest start. Sticky until
        ``release_gang``; None while no window exists. A gang larger than
        the fleet can grow to is refused."""
        from maggy_tpu_torch.gang import aligned_windows

        size = int(size)
        if size > self.max_size:
            raise ValueError("a gang of {} runners can never assemble on a {}-runner "
                             "fleet".format(size, self.max_size))
        with self._lock:
            existing = self._gang_blocks.get(entry.name)
            if existing is not None:
                return list(existing)
            self._expire_parked_locked()
            parked = self._parked_blocks.pop(_base_name(entry.name), None)
            if parked is not None:
                block = parked[0]
                self._gang_blocks[entry.name] = block
                self._event("pack", op="fleet_reclaim", exp=entry.name, block=block)
                self._wake.notify_all()
                return list(block)
            taken = {r for b in self._gang_blocks.values() for r in b}
            taken |= {r for b, _exp in self._parked_blocks.values() for r in b}
            bound_elsewhere = set()
            for e in self._entries.values():
                if e is not entry:
                    bound_elsewhere |= set(e.open_leases.keys())
            aligned = aligned_windows(self.fleet_size, size, taken)
            if not aligned:
                return None
            block = min(aligned, key=lambda w: (sum(1 for r in w if r in bound_elsewhere), w[0]))
            self._gang_blocks[entry.name] = block
            self._event("pack", op="fleet_reserve", exp=entry.name, block=block)
            self._wake.notify_all()
            return list(block)

    def release_gang(self, entry: ExperimentEntry) -> None:
        with self._lock:
            block = self._gang_blocks.pop(entry.name, None)
            if block is not None:
                self._event("pack", op="fleet_release", exp=entry.name, block=block)
                self._wake.notify_all()

    # locked-by: _lock
    def _expire_parked_locked(self) -> None:
        """Release parked blocks whose restart grace ran out."""
        now = time.monotonic()
        for base, (block, expiry) in list(self._parked_blocks.items()):
            if now >= expiry:
                del self._parked_blocks[base]
                self._event("pack", op="fleet_release", exp=base, block=block, expired=True)
                self._wake.notify_all()

    # locked-by: _lock
    def _gang_owner_locked(self, runner_idx: int) -> Optional[ExperimentEntry]:
        for name, block in self._gang_blocks.items():
            if runner_idx in block:
                return self._entries.get(name)
        return None

    # -------------------------------------------------------------- binding

    def next_binding(self, runner_idx: int,
                     timeout: Optional[float] = None
                     ) -> Optional[Tuple[ExperimentEntry, int]]:
        """Block until an experiment deserves this runner; returns
        ``(entry, partition_id)`` or None when the fleet is shutting down
        (or ``timeout`` elapsed)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self.stopped:
                    return None
                picked = self._pick_locked(runner_idx)
                if picked is not None:
                    return self._lease_locked(runner_idx, picked)
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                self._wake.wait(timeout=0.2)

    # locked-by: _lock
    def _pick_locked(self, runner_idx: int) -> Optional[ExperimentEntry]:
        is_agent = runner_idx in self._agent_slots
        # A runner inside a gang block binds only to its owner, past the
        # fair-share target (a gang needs its whole block at once); when
        # the owner cannot take it now, it waits.
        owner = self._gang_owner_locked(runner_idx)
        if owner is not None:
            if is_agent and owner.agent_info is None:
                return None
            if owner.wants_runners() and \
                    owner.allocated() < owner.effective_max(self.fleet_size):
                return owner
            return None
        targets = self._targets_locked()
        now = time.monotonic()
        slot_family = self._slot_family.get(runner_idx) if is_agent \
            else None
        slot_exp = self._slot_exp.get(runner_idx) if is_agent else None
        best = None
        best_key = None
        for e in self._active.values():
            if not e.wants_runners():
                continue
            if is_agent and e.agent_info is None:
                # A remote agent can only serve experiments whose train
                # fn is wire-nameable (ABIND ships a dotted path).
                continue
            if e.allocated() >= e.effective_max(self.fleet_size):
                continue
            # Warm prewarming hint: among equally-deserving (same
            # deficit, same class) candidates, prefer (0) the SAME
            # experiment this agent last served — parent affinity: its
            # warm slots AND its trials' checkpoints (fork sources) live
            # in that agent's process/disk — then (1) the same program
            # family (compiled step reuse, train/warm.py), then (2)
            # cold. Ranked below deficit and class so warmth can never
            # override fair share or priority.
            if slot_exp is not None and e.name == slot_exp:
                cold = 0
            elif slot_family is not None \
                    and e.train_fn_path == slot_family:
                cold = 1
            else:
                cold = 2
            key = (e.allocated() - targets.get(e.name, 0),
                   e.policy.rank, cold, e.vtime(now), e.seq)
            if best_key is None or key < best_key:
                best, best_key = e, key
        return best

    # locked-by: _lock
    def _lease_locked(self, runner_idx: int,
                      entry: ExperimentEntry) -> Tuple[ExperimentEntry, int]:
        pid = min(entry.free_pids)
        entry.free_pids.discard(pid)
        entry.open_leases[runner_idx] = (pid, time.monotonic())
        entry.lease_count += 1
        entry.deficit_since = None
        if entry.first_lease_t is None:
            entry.first_lease_t = time.time()
        # Warm prewarming hint bookkeeping (agent slots only: warm slots
        # are per-process, and only agents persist across leases):
        # warm_hint=True means this lease lands on an agent that already
        # holds the experiment's program family warm; warm_affinity
        # grades it — "experiment" (parent affinity: same experiment,
        # checkpoints on local disk) beats "family" (compiled step only).
        warm_hint = None
        warm_affinity = None
        if runner_idx in self._agent_slots \
                and entry.train_fn_path is not None:
            warm_hint = self._slot_family.get(runner_idx) \
                == entry.train_fn_path
            if self._slot_exp.get(runner_idx) == entry.name:
                warm_affinity = "experiment"
            elif warm_hint:
                warm_affinity = "family"
            self._slot_family[runner_idx] = entry.train_fn_path
            self._slot_exp[runner_idx] = entry.name
        self._event("lease", exp=entry.name, runner=runner_idx, pid=pid,
                    phase="start", exp_dir=entry.exp_dir,
                    warm_hint=warm_hint, warm_affinity=warm_affinity)
        self._chip_gauge(entry)
        return entry, pid

    def release_binding(self, runner_idx: int, entry: ExperimentEntry,
                        pid: int, error: Optional[BaseException] = None,
                        reason: Optional[str] = None) -> None:
        """``reason`` overrides the journaled lease-end reason (vocab
        LEASE_END_REASONS) — the agent plane passes ``agent_lost`` when
        it revokes a lease whose agent went silent mid-lease."""
        with self._lock:
            held = entry.open_leases.pop(runner_idx, None)
            if held is not None:
                entry.service_s += time.monotonic() - held[1]
            entry.free_pids.add(pid)
            entry.preempting_pids.discard(pid)
            if error is not None:
                entry.failures.append(error)
            self._event("lease", exp=entry.name, runner=runner_idx, pid=pid,
                        phase="end",
                        reason=reason or (
                            "error" if error is not None else "released"),
                        duration_s=round(time.monotonic() - held[1], 3)
                        if held is not None else None)
            self._chip_gauge(entry)
            self._wake.notify_all()

    def runner_for(self, entry: ExperimentEntry,
                   pid: int) -> Optional[int]:
        with self._lock:
            for runner, (p, _t0) in entry.open_leases.items():
                if p == pid:
                    return runner
        return None

    # ----------------------------------------------------------- preemption

    def maybe_preempt(self) -> int:
        """One preemption sweep: every experiment below its guaranteed
        allocation (``max(1, min_runners)`` capped by its target/max) for
        longer than ``preempt_grace_s`` gets ONE runner carved out of the
        most-over-share victim. Returns the number of preemptions
        initiated. Driver calls happen outside the scheduler lock."""
        actions: List[Tuple[ExperimentEntry, ExperimentEntry, int]] = []
        now = time.monotonic()
        with self._lock:
            if self.stopped:
                return 0
            self._expire_parked_locked()
            targets = self._targets_locked()
            for e in self._active.values():
                if not e.wants_runners():
                    e.deficit_since = None
                    continue
                want = max(1, min(e.policy.min_runners,
                                  e.effective_max(self.fleet_size)),
                           targets.get(e.name, 0))
                want = min(want, e.effective_max(self.fleet_size))
                if e.allocated() >= want:
                    e.deficit_since = None
                    continue
                if e.deficit_since is None:
                    e.deficit_since = now
                    continue
                if now - e.deficit_since < self.preempt_grace_s:
                    continue
                victim = self._victim_locked(e, targets)
                if victim is None:
                    continue
                # Never carve a runner out of the victim's own gang block:
                # that would revoke its whole N-chip lease.
                protected = set(self._gang_blocks.get(victim.name) or ())
                leases = [(r, v) for r, v in victim.open_leases.items() if r not in protected]
                if not leases:
                    continue
                runner, (pid, _t0) = max(leases, key=lambda kv: kv[1][1])
                if pid in victim.preempting_pids:
                    continue
                victim.preempting_pids.add(pid)
                e.deficit_since = now  # re-arm: one preemption per grace
                actions.append((victim, e, pid))
        fired = 0
        for victim, starving, pid in actions:
            trial = None
            ok = True
            try:
                trial = victim.driver.preempt_partition(pid, evict=True)
            except Exception:  # noqa: BLE001 - a failed preempt must not kill the tick
                ok = False
            with self._lock:
                if not ok:
                    # Nothing was delivered: un-throttle the pid so a
                    # later sweep can retry, and don't count/journal a
                    # preemption that never happened.
                    victim.preempting_pids.discard(pid)
                    continue
                victim.preemptions += 1
            fired += 1
            # trial=None marks an idle eviction (the runner was between
            # trials — released without any work lost).
            self._event("preempt", exp=victim.name, pid=pid,
                        runner=self.runner_for(victim, pid),
                        trial=trial, for_exp=starving.name)
        return fired

    # locked-by: _lock
    def _victim_locked(self, starving: ExperimentEntry,
                       targets: Dict[str, int]
                       ) -> Optional[ExperimentEntry]:
        now = time.monotonic()
        candidates = []
        for v in self._active.values():
            if v is starving or v.state != "active" or not v.open_leases:
                continue
            if v.allocated() - 1 < min(v.policy.min_runners,
                                       v.effective_max(self.fleet_size)):
                continue
            over_share = v.allocated() > targets.get(v.name, 0)
            lower_class = v.policy.rank > starving.policy.rank
            # Rotation: with more same-class experiments than runners,
            # everyone sits exactly AT target (ties broken by submit
            # order) and leases last whole experiments — without this, a
            # runner-less peer would starve until someone finished.
            # Preempting the peer with the most weighted service hands
            # the fleet around in virtual-time order, so the starvation
            # bound is the grace period plus one service-differential.
            rotation = (starving.allocated() == 0
                        and v.policy.rank == starving.policy.rank
                        and v.vtime(now) > starving.vtime(now))
            if not (over_share or lower_class or rotation):
                continue
            candidates.append(v)
        if not candidates:
            return None
        return max(candidates,
                   key=lambda v: (v.policy.rank,
                                  v.allocated() - targets.get(v.name, 0),
                                  v.vtime(now)))

    # ------------------------------------------------------------- querying

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            entries = sorted(self._entries.values(), key=lambda e: e.seq)
            experiments = list(self._finished) \
                + [e.snapshot() for e in entries]
            return {
                "fleet_size": self.fleet_size,
                "agent_slots": len(self._agent_slots)
                - len(self._vacant_agent_slots),
                "queue_depth": self._queued_count,
                "active": len(self._active),
                "shed": self.shed_count,
                "max_queued": self.max_queued,
                # Fleet-wide chip-time granted so far (finished +
                # resident tenants, live leases included) — the
                # denominator the goodput ledger accounts against.
                "chip_seconds": round(
                    sum(e.get("chip_seconds") or e.get("service_s") or 0.0
                        for e in experiments), 3),
                "experiments": experiments,
            }

    def saturated(self) -> bool:
        """True while new submissions would be shed (``max_queued``
        reached) — the spool feeder's stop-claiming signal."""
        with self._lock:
            return self.max_queued is not None \
                and self._queued_count >= self.max_queued

    def _event(self, ev: str, **fields: Any) -> None:
        telem = self.telemetry
        if telem is not None:
            telem.event(ev, **fields)

    def _chip_gauge(self, entry: ExperimentEntry) -> None:
        """Refresh the per-tenant ``tenant.chip_seconds.<exp>`` gauge on
        a lease transition so the fleet's /metrics exposition carries
        each tenant's granted chip-time (obs labels it
        ``tenant_chip_seconds{tenant=...}``). Best-effort: gauges are a
        read-side convenience, the journal stays the source of truth."""
        telem = self.telemetry
        if telem is None or not getattr(telem, "enabled", False):
            return
        try:
            telem.metrics.gauge(
                "tenant.chip_seconds.{}".format(entry.name)).set(
                round(entry.chip_seconds(time.monotonic()), 3))
        except Exception:  # noqa: BLE001 - accounting must not break leasing
            pass


class FleetSubmission:
    """Handle for one ``Fleet.submit``: blocks on ``result()``."""

    def __init__(self, name: str, entry: ExperimentEntry):
        self.name = name
        self.entry = entry
        self._done = threading.Event()
        self._result: Any = None
        self._exc: Optional[BaseException] = None

    def _set_result(self, result: Any) -> None:
        self._result = result
        self._done.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                "experiment {!r} did not finish within {}s".format(
                    self.name, timeout))
        if self._exc is not None:
            raise self._exc
        return self._result


class FleetBinding:
    """What ``config.fleet`` carries for a fleet-attached experiment: the
    fleet handle plus this experiment's scheduler entry. The driver uses
    it to (a) publish its RPC server on the fleet's shared listener and
    (b) lease runners instead of owning a pool."""

    def __init__(self, fleet: "Fleet", entry: ExperimentEntry):
        self.fleet = fleet
        self.entry = entry

    def attach_server(self, server) -> Tuple[str, int]:
        return self.fleet.shared_server.attach(server, host=self.fleet.bind_host)

    def lease_pool(self, driver) -> "FleetLeasedPool":
        return FleetLeasedPool(self, driver)

    def request_gang(self, size: int) -> Optional[List[int]]:
        """Reserve a contiguous fleet-runner block for this experiment's
        gang trials (``FleetScheduler.request_gang``)."""
        return self.fleet.scheduler.request_gang(self.entry, size)

    def release_gang(self) -> None:
        self.fleet.scheduler.release_gang(self.entry)


class FleetLeasedPool(RunnerPool):
    """The driver-facing pool adapter in fleet mode: ``run`` registers the
    experiment's executor with the scheduler and waits for completion —
    the fleet's runner loops are the actual substrate (the same shape as
    ``RemoteRunnerPool``, with the scheduler standing in for the join
    ticket)."""

    #: A fleet runner that keeps dying inside this experiment's executor
    #: is quarantined after this many failures per slot — without a cap a
    #: pathological executor would rebind-and-crash forever.
    MAX_FAILURES_PER_SLOT = 3

    def __init__(self, binding: FleetBinding, driver):
        super().__init__(driver.num_executors)
        self.binding = binding
        self.driver = driver

    def run(self, worker_fn: Callable[[int], None]) -> List[BaseException]:
        fleet = self.binding.fleet
        entry = self.binding.entry
        scheduler = fleet.scheduler
        scheduler.activate(entry, self.driver, worker_fn,
                           slots=self.num_workers)
        cap = self.MAX_FAILURES_PER_SLOT * max(1, self.num_workers)
        while not self.driver.experiment_done:
            if scheduler.stopped:
                return [RuntimeError(
                    "fleet shut down while experiment {!r} was "
                    "running".format(entry.name))]
            with scheduler._lock:
                n_failures = len(entry.failures)
            if n_failures > cap:
                return list(entry.failures)
            time.sleep(0.05)
        # Let leased runners observe their GSTOP before the driver tears
        # the server down (mirrors RemoteRunnerPool's release-ack grace).
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with scheduler._lock:
                if not entry.open_leases:
                    break
            time.sleep(0.05)
        return list(entry.failures)

    def kill_worker(self, partition_id: int) -> bool:
        fleet = self.binding.fleet
        runner = fleet.scheduler.runner_for(self.binding.entry,
                                            partition_id)
        if runner is None:
            return False
        if fleet.scheduler.is_agent_slot(runner):
            # An agent process holds the lease: the plane SIGKILLs it (a
            # same-host kill; the chaos and soak path).
            plane = fleet.agent_plane
            return plane is not None and plane.kill_agent_by_runner(runner)
        return fleet.pool.kill_worker(runner)

    def chip_of(self, partition_id: int) -> Optional[int]:
        """The fleet runner this partition is leased to (runner = chip):
        the gang placer's coordinate in fleet mode, so contiguous chips are
        contiguous fleet runners. None while unbound."""
        return self.binding.fleet.scheduler.runner_for(self.binding.entry, partition_id)

    def terminate(self) -> None:
        # The fleet owns its runners; a doomed experiment must not take
        # the shared substrate down with it.
        pass


class Fleet:
    """A persistent, shared runner fleet plus its scheduler, shared RPC
    listener, and journal. In-process: submissions are train-fn callables,
    so the fleet and its experiments live in one Python process (threads);
    the ``python -m maggy_tpu_torch.fleet`` CLI hosts one for spool-file
    submissions from other processes."""

    def __init__(self, runners: int = 2, *, pool: str = "thread",
                 name: str = "fleet", home_dir: Optional[str] = None,
                 env=None, max_active: Optional[int] = None,
                 max_queued: Optional[int] = None,
                 preempt_grace_s: float = 1.0, telemetry: bool = True,
                 obs_port: Optional[int] = None,
                 obs_host: str = "127.0.0.1",
                 max_agents: int = 0,
                 sink: Optional[bool] = None,
                 bind_host: str = "127.0.0.1",
                 agent_liveness_s: Optional[float] = None):
        if pool != "thread":
            raise ValueError(
                "fleet pools are in-process ('thread'): experiments are "
                "submitted as live callables and scheduler bindings cross "
                "no process boundary (got pool={!r}). Cross-process "
                "capacity comes from agents instead: pass max_agents=N and "
                "start agents with `python -m maggy_tpu_torch.fleet agent "
                "--ticket <home>/agent_ticket.json`".format(pool))
        from maggy_tpu_torch.core.environment import EnvSing
        from maggy_tpu_torch.core.rpc import SharedServer
        from maggy_tpu_torch.telemetry import Telemetry

        self.name = name
        self.env = env or EnvSing.get_instance()
        self.num_runners = int(runners)
        self.pool = ThreadRunnerPool(self.num_runners)
        self.home_dir = home_dir or os.path.join(
            self.env.experiment_base_dir(), "fleets", name)
        self.telemetry = Telemetry(
            env=self.env,
            journal_path=self.home_dir + "/" + FLEET_JOURNAL_NAME,
            enabled=telemetry)
        self.scheduler = FleetScheduler(
            self.num_runners, telemetry=self.telemetry,
            max_active=max_active, max_queued=max_queued,
            preempt_grace_s=preempt_grace_s,
            max_size=self.num_runners + int(max_agents))
        self.shared_server = SharedServer()
        # Agents (fleet/agent.py): max_agents > 0 opens the agent plane at
        # start(), a FleetAgentServer on the shared listener and the fleet
        # ticket in home_dir; its proxies declare an agent lost after
        # agent_liveness_s of silence. The listener binds bind_host, and
        # the ticket advertises this host's address when that is a
        # wildcard.
        self.max_agents = int(max_agents)
        self.bind_host = bind_host
        self._agent_liveness_s = agent_liveness_s
        self.agent_plane = None
        # The journal sink (telemetry/sink.py): per-source journals under
        # <home>/journal/, fed by a SinkServer tenant on the shared
        # listener. Default: on whenever the fleet's telemetry is (tenants
        # still opt in with config.sink).
        self.sink_enabled = bool(telemetry) if sink is None else bool(sink)
        self.sink = None
        self.sink_server = None
        self._pool_thread: Optional[threading.Thread] = None
        self._tick_thread: Optional[threading.Thread] = None
        self._started = False
        self._stopped = False
        self._lock = threading.Lock()
        self._submissions: Dict[str, FleetSubmission] = {}  # guarded-by: _lock
        self._sub_threads: List[threading.Thread] = []  # guarded-by: _lock
        self._sub_seq = itertools.count()
        #: Live observability plane for the fleet HOST process: the fleet
        #: registers its scheduler status with the process obs server, so
        #: /status shows share allocation and queue depth even between
        #: experiments (each attached driver additionally registers its
        #: own experiment). None (+ no MAGGY_TPU_OBS_PORT) = off.
        from maggy_tpu_torch.config import resolved_env_obs_port

        self._obs_port = obs_port if obs_port is not None \
            else resolved_env_obs_port()
        self._obs_host = obs_host
        self._obs_registration = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Fleet":
        with self._lock:
            if self._started:
                return self
            self._started = True
        self.telemetry.event("fleet", phase="start", name=self.name,
                             runners=self.num_runners, pool="thread")
        if self.sink_enabled:
            from maggy_tpu_torch.core.rpc import SinkServer
            from maggy_tpu_torch.telemetry.sink import SINK_DIR_NAME, JournalSink

            self.sink = JournalSink(self.env, self.home_dir + "/" + SINK_DIR_NAME,
                                    telemetry=self.telemetry)
            self.sink_server = SinkServer()
            self.sink_server.telemetry = self.telemetry
            self.sink_server.attach_sink(self.sink)
            self.shared_server.attach(self.sink_server, host=self.bind_host)
        if self._obs_port is not None and self.telemetry.enabled:
            from maggy_tpu_torch.telemetry import obs as obs_mod

            self._obs_registration = obs_mod.ObsRegistration(
                key="fleet:{}".format(self.name),
                labels={"experiment": self.name, "run": "fleet"},
                telemetry=self.telemetry, status_fn=self.status,
                snapshots_fn=self._federated_metrics)
            server = obs_mod.register(self._obs_registration,
                                      port=self._obs_port,
                                      host=self._obs_host)
            self.telemetry.event("obs_started", host=server.address[0],
                                 port=server.address[1],
                                 experiment=self.name)
        self._pool_thread = threading.Thread(
            target=self.pool.run, args=(self._runner_loop,),
            daemon=True, name="fleet-pool")
        self._pool_thread.start()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, daemon=True, name="fleet-tick")
        self._tick_thread.start()
        if self.max_agents > 0:
            from maggy_tpu_torch.fleet.agent import DEFAULT_LIVENESS_S, AgentPlane

            self.agent_plane = AgentPlane(
                self, max_agents=self.max_agents,
                liveness_s=self._agent_liveness_s if self._agent_liveness_s is not None
                else DEFAULT_LIVENESS_S).start()
        self._dump_status()
        return self

    def _runner_loop(self, runner_idx: int) -> None:
        """One persistent fleet runner: bind -> run the experiment's
        executor until released -> re-bind. An executor exception (e.g. a
        dead control plane) is a lease failure, not a fleet failure — the
        runner survives and re-binds."""
        while True:
            binding = self.scheduler.next_binding(runner_idx)
            if binding is None:
                return
            entry, pid = binding
            err: Optional[BaseException] = None
            try:
                entry.executor_fn(pid)
            except BaseException as e:  # noqa: BLE001 - lease failure, runner survives
                err = RuntimeError(
                    "fleet runner {} failed in experiment {!r} (partition "
                    "{}): {!r}".format(runner_idx, entry.name, pid, e))
            finally:
                self.scheduler.release_binding(runner_idx, entry, pid,
                                               error=err)

    def _tick_loop(self) -> None:
        last_status = 0.0
        while not self.scheduler.stopped:
            self.scheduler.maybe_preempt()
            now = time.monotonic()
            if now - last_status >= 0.5:
                last_status = now
                self._dump_status()
            time.sleep(0.1)

    def shutdown(self, wait: bool = True, timeout: float = 30.0) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            subs = list(self._sub_threads)
        if wait:
            deadline = time.monotonic() + timeout
            for t in subs:
                t.join(timeout=max(0.1, deadline - time.monotonic()))
        self.scheduler.stop()
        if self.agent_plane is not None:
            # After the scheduler's stop: the proxies wake from
            # next_binding, and the agents' next polls read AGSTOP.
            self.agent_plane.stop()
        for t in (self._pool_thread, self._tick_thread):
            if t is not None:
                t.join(timeout=5)
        self.shared_server.stop()
        if self.sink is not None:
            # After the listener: no JSINK frame can land any more, so the
            # sink seals every per-source journal.
            self.sink.stop()
        if self._obs_registration is not None:
            from maggy_tpu_torch.telemetry import obs as obs_mod

            obs_mod.deregister(self._obs_registration)
            self._obs_registration = None
        self.telemetry.event("fleet", phase="stop")
        self._dump_status()
        self.telemetry.close()

    # ------------------------------------------------------------ sink plane

    def sink_binding(self):
        """Where this fleet's journal shippers dial (a
        ``telemetry.sink.SinkBinding``), or None while the sink is off or
        not started."""
        if self.sink_server is None or self.shared_server.addr is None:
            return None
        from maggy_tpu_torch.telemetry.sink import SinkBinding

        return SinkBinding(self.shared_server.addr, self.sink_server.secret_hex)

    def kill_sink(self) -> bool:
        """Chaos and test hook (invariant 12): detach the sink tenant from
        the shared listener, so JSINK frames fail authentication and the
        shippers degrade to their local journals. The sink service (its
        writers and dedup state) stays for ``restart_sink``."""
        if self.sink_server is None:
            return False
        self.shared_server.detach(self.sink_server)
        return True

    def restart_sink(self) -> bool:
        """Re-attach the sink tenant under the same secret: degraded
        shippers reconnect on their next cycle and re-ship their unacked
        suffix (the sink's sid dedup absorbs any overlap)."""
        if self.sink_server is None:
            return False
        self.shared_server.attach(self.sink_server, host=self.bind_host)
        return True

    def _federated_metrics(self):
        """Each source's shipped counters for the fleet's /metrics."""
        return self.sink.federated_snapshots() if self.sink is not None else []

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------ submission

    def submit(self, train_fn: Callable, config, *, priority="normal",
               weight: float = 1.0, min_runners: int = 0,
               max_runners: Optional[int] = None,
               name: Optional[str] = None) -> FleetSubmission:
        """Queue one experiment onto the fleet; returns a handle whose
        ``result()`` blocks for the experiment's result (the same value
        ``lagom`` would return)."""
        self.start()
        policy = FleetPolicy(priority=priority, weight=weight,
                             min_runners=min_runners,
                             max_runners=max_runners)
        base = name or getattr(config, "name", "experiment")
        from maggy_tpu_torch.fleet.agent import train_fn_path

        fn_path = train_fn_path(train_fn)
        with self._lock:
            if self._stopped:
                raise RuntimeError("fleet {!r} is shut down".format(self.name))
            sub_name = base
            while sub_name in self._submissions:
                sub_name = "{}-{}".format(base, next(self._sub_seq))
            entry = self.scheduler.submit(sub_name, policy)
            # Wire-nameable train fns make the experiment leasable to
            # REMOTE agents (ABIND ships the dotted path); closures and
            # lambdas keep it on thread runners only.
            entry.train_fn_path = fn_path
            handle = FleetSubmission(sub_name, entry)
            self._submissions[sub_name] = handle
            # Prune finished submission threads so a long-lived host
            # doesn't accumulate one dead Thread per spool submission.
            self._sub_threads = [t for t in self._sub_threads
                                 if t.is_alive()]
            thread = threading.Thread(
                target=self._run_submission,
                args=(handle, train_fn, config),
                daemon=True, name="fleet-exp-{}".format(sub_name))
            self._sub_threads.append(thread)
        thread.start()
        return handle

    def _run_submission(self, handle: FleetSubmission, train_fn: Callable,
                        config) -> None:
        """Submission thread: claim a run id, build the driver with the
        fleet binding in its config, and run the experiment — the driver's
        pool is a ``FleetLeasedPool``, so all its runners come from the
        shared fleet."""
        import dataclasses

        from maggy_tpu_torch import experiment as exp_mod

        entry = handle.entry
        sub = None
        driver = None
        try:
            # Deferred activation: build the driver (run-dir claim, RPC
            # server, telemetry, threads) only once the scheduler admits
            # this tenant past the queue. A churn of hundreds of queued
            # submissions costs hundreds of heap entries and parked
            # threads — not hundreds of live control planes.
            if not self.scheduler.wait_admitted(entry):
                raise RuntimeError(
                    "fleet {!r} stopped before experiment {!r} was "
                    "admitted".format(self.name, entry.name))
            sub = exp_mod._begin_run(config, self.env, exclusive=False)
            # Partition-id range: thread runners PLUS agent slots — an
            # agent-backed fleet must be able to lease more runners to
            # one experiment than the host process has threads.
            slots = entry.effective_max(self.num_runners + self.max_agents)
            replacements = dict(fleet=FleetBinding(self, entry),
                                num_workers=max(1, slots))
            if self._obs_port is not None \
                    and getattr(config, "obs_port", None) is None:
                # The fleet host's obs plane covers its tenants: an
                # attached experiment registers onto the SAME process
                # server (one per process), so /status shows every
                # live experiment next to the fleet's share state. An
                # experiment's own obs_port still wins when set.
                replacements["obs_port"] = self._obs_port
            cfg = dataclasses.replace(config, **replacements)
            driver = exp_mod.lagom_driver(cfg, sub.app_id, sub.run_id)
            result = driver.run_experiment(train_fn)
            self.scheduler.finish(entry, "done")
            handle._set_result(result)
        except BaseException as exc:  # noqa: BLE001 - surface via the handle
            self.scheduler.finish(entry, "failed")
            handle._set_exception(exc)
        finally:
            if sub is not None:
                exp_mod._end_run(sub)
            self._dump_status()

    # ------------------------------------------------------------- querying

    def status(self) -> Dict[str, Any]:
        snap = self.scheduler.snapshot()
        return {"t": time.time(), "name": self.name,
                "runners": self.num_runners, "pool": "thread",
                "stopped": self._stopped,
                "max_agents": self.max_agents,
                "agents": self.agent_plane.snapshot() if self.agent_plane is not None else [],
                "sink": self.sink.snapshot() if self.sink is not None else {},
                **snap}

    def _dump_status(self) -> None:
        try:
            self.env.dump(json.dumps(self.status(), indent=2, default=str),
                          self.home_dir + "/status.json")
        except Exception:  # noqa: BLE001 - status mirror is best-effort
            pass


# ----------------------------------------------------------------- replay


def replay_fleet_journal(path: str, env=None,
                         share_names=None) -> Dict[str, Any]:
    """Offline replay of a fleet journal: per-experiment queue waits,
    lease-derived runner-seconds, share fractions over the window where
    experiments overlapped (vs the weight-expected split), preemption
    counts, admission latency (submit -> admit), shed counts, and
    scheduler decision throughput. Pure — the same journal always
    reproduces the same numbers (bench.py's ``detail.fleet`` /
    ``detail.scale`` blocks are exactly this call).

    ``share_names``: restrict the fair-share computation to this subset
    of experiments. Under churn the overlap window of ALL experiments is
    empty (cohorts start and finish at different times), so the share
    check runs over the long-lived resident cohort instead."""
    from maggy_tpu_torch.telemetry import read_events
    from maggy_tpu_torch.telemetry.spans import _dist_stats

    if os.path.isdir(path):  # a fleet home dir stands in for its journal
        path = os.path.join(path, "fleet.jsonl")
    events = read_events(path, env=env)
    exps: Dict[str, Dict[str, Any]] = {}
    preempts = 0
    sheds = 0
    admission_ms: List[float] = []
    decisions = 0
    first_t: Optional[float] = None
    last_t = 0.0
    # Remote-agent lanes: per-agent lifecycle counts plus the ABIND
    # delivery latency (lease set -> ALEASE poll pickup) distribution —
    # the "lease round-trip" number bench.py --scale --remote reports.
    agent_joins = 0
    agent_losses = 0
    agent_leases: Dict[str, int] = {}
    abind_ms: List[float] = []
    agent_lost_leases = 0
    # Warm prewarming hints: how many agent-slot leases landed on an
    # agent already holding the experiment's program family warm
    # (lease-event warm_hint field; None = thread runner / family-less).
    # warm_affinity grades the hits: "experiment" = parent affinity
    # (same experiment re-lease — fork checkpoints on local disk),
    # "family" = compiled-step reuse only.
    warm_hint_hits = 0
    warm_hint_misses = 0
    warm_affinity_exp = 0
    # Journal-sink ingest records (jsink) + per-agent clock offsets —
    # the telemetry fan-in plane's replayable numbers.
    sink_batches = 0
    sink_events = 0
    sink_dup = 0
    sink_lag_ms: List[float] = []
    sink_sources_seen: set = set()
    clock_offsets: Dict[str, Dict[str, Any]] = {}

    def exp(name: str) -> Dict[str, Any]:
        return exps.setdefault(name, {
            "submitted_t": None, "first_lease_t": None, "leases": [],
            "open": {}, "preemptions": 0, "weight": 1.0, "priority": None,
            "exp_dir": None})

    for ev in events:
        t = ev.get("t")
        if isinstance(t, (int, float)):
            last_t = max(last_t, t)
        kind = ev.get("ev")
        if kind in ("fleet_admit", "lease", "preempt", "shed"):
            # Scheduler decisions: admissions, lease grants/releases,
            # preemptions, sheds — the control plane's output rate.
            decisions += 1
            if isinstance(t, (int, float)):
                first_t = t if first_t is None else min(first_t, t)
        if kind == "shed":
            sheds += 1
        elif kind == "fleet_admit":
            if ev.get("queued_s") is not None:
                admission_ms.append(float(ev["queued_s"]) * 1e3)
        elif kind == "fleet_submit":
            e = exp(ev["exp"])
            e["submitted_t"] = t
            e["weight"] = float(ev.get("weight", 1.0))
            e["priority"] = ev.get("priority")
        elif kind == "lease":
            e = exp(ev["exp"])
            if ev.get("exp_dir"):
                e["exp_dir"] = ev["exp_dir"]
            key = (ev.get("runner"), ev.get("pid"))
            if ev.get("phase") == "start":
                e["open"][key] = t
                if e["first_lease_t"] is None:
                    e["first_lease_t"] = t
                if ev.get("warm_hint") is True:
                    warm_hint_hits += 1
                elif ev.get("warm_hint") is False:
                    warm_hint_misses += 1
                if ev.get("warm_affinity") == "experiment":
                    warm_affinity_exp += 1
            elif ev.get("phase") == "end":
                t0 = e["open"].pop(key, None)
                if t0 is not None and t is not None:
                    e["leases"].append((t0, t))
                if ev.get("reason") == "agent_lost":
                    agent_lost_leases += 1
        elif kind == "agent":
            phase = ev.get("phase")
            if phase == "join":
                agent_joins += 1
            elif phase == "lost":
                agent_losses += 1
            elif phase == "lease":
                aid = str(ev.get("agent"))
                agent_leases[aid] = agent_leases.get(aid, 0) + 1
                if ev.get("abind_ms") is not None:
                    abind_ms.append(float(ev["abind_ms"]))
        elif kind == "jsink":
            sink_batches += 1
            sink_events += int(ev.get("n") or 0)
            sink_dup += int(ev.get("dup") or 0)
            if ev.get("source"):
                sink_sources_seen.add(str(ev["source"]))
            if ev.get("lag_ms") is not None:
                sink_lag_ms.append(float(ev["lag_ms"]))
        elif kind == "clock_offset":
            if ev.get("agent"):
                clock_offsets[str(ev["agent"])] = {
                    "offset_s": ev.get("offset_s"),
                    "rtt_s": ev.get("rtt_s"), "t": t,
                    "reports": clock_offsets.get(
                        str(ev["agent"]), {}).get("reports", 0) + 1}
        elif kind == "preempt":
            preempts += 1
            exp(ev["exp"])["preemptions"] += 1
        elif kind == "fleet_experiment":
            e = exp(ev["exp"])
            if ev.get("exp_dir"):
                e["exp_dir"] = ev["exp_dir"]

    queue_waits_ms: List[float] = []
    out_exps: Dict[str, Dict[str, Any]] = {}
    for name, e in exps.items():
        for key, t0 in e["open"].items():  # journal ended mid-lease
            e["leases"].append((t0, last_t))
        e["open"] = {}
        runner_s = sum(t1 - t0 for t0, t1 in e["leases"])
        qw = None
        if e["submitted_t"] is not None and e["first_lease_t"] is not None:
            qw = e["first_lease_t"] - e["submitted_t"]
            queue_waits_ms.append(qw * 1e3)
        out_exps[name] = {
            "runner_seconds": round(runner_s, 3),
            "leases": len(e["leases"]),
            "queue_wait_s": round(qw, 3) if qw is not None else None,
            "preemptions": e["preemptions"],
            "weight": e["weight"], "priority": e["priority"],
            "exp_dir": e["exp_dir"],
        }

    # Per-tenant chip-time ledger: lease-derived chip-seconds (the
    # denominator the scheduler granted) plus each tenant's OWN journal
    # folded through the goodput accountant — local journal merged
    # exactly-once with any sink-shipped segment, so a tenant that ran
    # on a remote agent (no surviving local journal) still folds. A
    # tenant's journal is written by one driver process, so the fold is
    # single-clock; cross-process merges go through
    # ``goodput.merge_corrected`` with the replay's ``clock_offsets``.
    from maggy_tpu_torch.telemetry import JOURNAL_NAME
    from maggy_tpu_torch.telemetry.goodput import compute_goodput

    home = os.path.dirname(os.path.abspath(path))
    shipped_by_source: Dict[str, Any] = {}
    try:
        from maggy_tpu_torch.telemetry.sink import SINK_DIR_NAME, read_sink_dir

        sink_dir = os.path.join(home, SINK_DIR_NAME)
        if os.path.isdir(sink_dir):
            shipped_by_source = read_sink_dir(sink_dir)
    except Exception:  # noqa: BLE001 - a torn sink dir must not kill replay
        shipped_by_source = {}

    tenants: Dict[str, Dict[str, Any]] = {}
    fleet_held = 0.0
    fleet_train = 0.0
    for name, oe in sorted(out_exps.items()):
        local = None
        exp_dir = oe.get("exp_dir")
        if exp_dir:
            jp = os.path.join(exp_dir, JOURNAL_NAME)
            if os.path.exists(jp):
                local = read_events(jp, env=env)
        shipped = None
        if shipped_by_source:
            from maggy_tpu_torch.telemetry.sink import sanitize_source

            shipped = shipped_by_source.get(sanitize_source(name))
        gp: Dict[str, Any] = {}
        if shipped is not None and local is not None:
            from maggy_tpu_torch.telemetry.sink import merge_source_events

            gp = compute_goodput(merge_source_events(shipped, local))
        elif local is not None or shipped is not None:
            gp = compute_goodput(local if local is not None else shipped)
        tenants[name] = {"chip_seconds": oe["runner_seconds"],
                         "goodput": gp}
        held = gp.get("held_chip_s") or 0.0
        frac = gp.get("goodput_fraction")
        if held > 0 and frac is not None:
            fleet_held += held
            fleet_train += held * frac
    goodput_block: Dict[str, Any] = {
        "tenants": tenants,
        "chip_seconds": round(
            sum(t["chip_seconds"] or 0.0 for t in tenants.values()), 3),
        # Held-time-weighted fleet goodput across every tenant that had
        # a foldable journal (None when none did).
        "goodput_fraction": round(fleet_train / fleet_held, 4)
        if fleet_held > 0 else None,
    }

    # Fair-share check over the overlap window: the span in which EVERY
    # leased experiment had started leasing and none had fully finished —
    # outside it, a lone experiment legitimately takes the whole fleet.
    share: Dict[str, float] = {}
    expected: Dict[str, float] = {}
    share_error = None
    leased = {n: e for n, e in exps.items() if e["leases"]
              and (share_names is None or n in share_names)}
    if len(leased) >= 2:
        w0 = max(min(t0 for t0, _ in e["leases"]) for e in leased.values())
        w1 = min(max(t1 for _, t1 in e["leases"]) for e in leased.values())
        if w1 > w0:
            clipped = {
                n: sum(max(0.0, min(t1, w1) - max(t0, w0))
                       for t0, t1 in e["leases"])
                for n, e in leased.items()}
            total = sum(clipped.values())
            wsum = sum(e["weight"] for e in leased.values())
            if total > 0 and wsum > 0:
                share = {n: round(s / total, 3) for n, s in clipped.items()}
                expected = {n: round(e["weight"] / wsum, 3)
                            for n, e in leased.items()}
                share_error = round(
                    max(abs(share[n] - expected[n]) for n in share), 3)

    window_s = None
    if first_t is not None and last_t > first_t:
        window_s = last_t - first_t
    admission_sorted = sorted(admission_ms)
    admission_p99 = None
    if admission_sorted:
        admission_p99 = round(
            admission_sorted[min(len(admission_sorted) - 1,
                                 int(0.99 * len(admission_sorted)))], 3)
    return {
        "experiments": out_exps,
        "preemptions": preempts,
        "sheds": sheds,
        # Remote-agent plane (empty/zero for purely in-process fleets).
        "agents": {
            "joins": agent_joins,
            "losses": agent_losses,
            "lost_leases": agent_lost_leases,
            "leases": sum(agent_leases.values()),
            "per_agent_leases": dict(sorted(agent_leases.items())),
            "abind_ms": _dist_stats(abind_ms),
            # Prewarming-hint accuracy: agent leases that landed on an
            # already-warm family vs cold re-binds; warm_affinity_exp =
            # the subset that re-leased the SAME experiment (parent
            # affinity: fork checkpoints on the agent's local disk).
            "warm_hint_hits": warm_hint_hits,
            "warm_hint_misses": warm_hint_misses,
            "warm_affinity_exp": warm_affinity_exp,
        },
        # Journal-sink ingest (empty/zero when no tenant/agent shipped).
        "sink": {
            "batches": sink_batches,
            "events": sink_events,
            "dup": sink_dup,
            "sources": len(sink_sources_seen),
            "lag_ms": _dist_stats(sink_lag_ms),
        },
        # Last reported clock offset per agent — the unified trace's
        # cross-process time base.
        "clock_offsets": clock_offsets,
        # Per-tenant chip-time ledger: lease-granted chip-seconds plus
        # each tenant's own journal fold (``python -m
        # maggy_tpu_torch.telemetry goodput <fleet home>`` prints this).
        "goodput": goodput_block,
        "share": share,
        "expected_share": expected,
        "share_error": share_error,
        "queue_wait_ms": _dist_stats(queue_waits_ms),
        "max_queue_wait_s": round(max(queue_waits_ms) / 1e3, 3)
        if queue_waits_ms else None,
        # Admission latency: fleet_submit -> fleet_admit, per admitted
        # experiment (the scheduler's own queued_s measurement).
        "admission_ms": _dist_stats(admission_ms),
        "admission_p99_ms": admission_p99,
        # Scheduler decision throughput over the decision window:
        # admits + lease starts/ends + preempts + sheds per second.
        "decisions": decisions,
        "decision_window_s": round(window_s, 3) if window_s else None,
        "decisions_per_s": round(decisions / window_s, 2)
        if window_s else None,
        "torn_lines": getattr(events, "torn_lines", 0),
    }
