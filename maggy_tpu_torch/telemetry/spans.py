"""Trial-span tracing: per-trial phase timestamps and derived scheduling
metrics.

A span is minted when the driver creates a trial and its id travels inside
the existing RPC payloads (TRIAL info, METRIC, FINAL, the STOP reply), so
every control-plane hop about a trial can be attributed to one span without
a new wire protocol. Phases:

    queued -> assigned -> running -> first_metric
                                  -> stop_flagged -> finalized

``derive()`` is the single source of truth for the numbers the paper's
scheduling claim rests on — hand-off gap, early-stop reaction latency — and
is a PURE function over journal events: the same event list always yields
the same numbers, whether computed live by the driver, over the TELEM RPC,
or replayed offline from a journal file (bench.py does exactly that).
"""

from __future__ import annotations

import secrets as pysecrets
import threading
import time
from typing import Any, Dict, List, Optional

from maggy_tpu_torch.telemetry.vocab import SPAN_PHASES

#: Trial phases in nominal order (a requeued trial may revisit phases; the
#: journal records every occurrence, derivation picks the appropriate one).
#: ``requeued`` marks a trial re-entering the schedule after runner loss /
#: blacklist — the explicit edge recovery latency derives from (the span's
#: first-occurrence timestamps alone cannot carry it).
#: ``profile_skipped`` is an annotation, not a lifecycle edge: the runner
#: reported the trial ran untraced (profiler lock contended).
#: ``suggested`` marks the controller materializing the trial (possibly
#: well before ``queued`` — the prefetch pipeline runs suggest() ahead of
#: dispatch); ``prefetch_hit`` marks a hand-off served inline on the FINAL
#: reply (journaled on the dispatched trial), ``prefetch_miss`` a FINAL
#: whose freed runner had to fall back to GET polling (journaled on the
#: finalized trial). hit/(hit+miss) is the pipeline's hit rate.
#: ``preempt_requested`` -> ``preempted`` -> ``resumed`` are the
#: checkpoint-assisted preemption edges (fleet scheduling / chaos
#: preempt_trial): requested when the driver arms the preempt flag,
#: preempted when the runner's ack lands (carrying the checkpoint step),
#: resumed when the trial is re-dispatched with a ``resume_step``.
#: ``compiled`` is an annotation carrying the runner-measured ttfm
#: breakdown (warm flag + init_ms/trace_ms/compile_ms/first_step_ms/
#: ttfm_ms — see telemetry/runnerstats.py): warm trials reuse the runner's
#: resident program (train/warm.py), cold trials paid the XLA compile.
#: One home: telemetry/vocab.py — the shared emitter/consumer vocabulary
#: the journalvocab checker (maggy_tpu.analysis) verifies both sides
#: against. Re-exported here for compatibility.
PHASES = SPAN_PHASES

#: Gaps at or above this bound are scheduling (a runner idling on purpose at
#: a rung barrier), not hand-off overhead — excluded from the gap stats.
#: Matches the historical bench.py cap so numbers stay comparable.
HANDOFF_CAP_S = 2.0


class TrialSpan:
    """One trial's phase timeline. ``phases`` keeps the FIRST time each
    phase was observed; the journal keeps every occurrence."""

    __slots__ = ("span_id", "trial_id", "phases", "partition")

    def __init__(self, span_id: str, trial_id: str):
        self.span_id = span_id
        self.trial_id = trial_id
        self.phases: Dict[str, float] = {}
        self.partition: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"span": self.span_id, "trial": self.trial_id,
                "partition": self.partition,
                "phases": {k: round(v, 6) for k, v in self.phases.items()}}


class SpanTracker:
    """Thread-safe span registry keyed by trial id."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: Dict[str, TrialSpan] = {}  # guarded-by: _lock

    def mint(self, trial_id: str) -> str:
        """Create (or return) the span for ``trial_id``."""
        with self._lock:
            span = self._spans.get(trial_id)
            if span is None:
                span = TrialSpan(pysecrets.token_hex(6), trial_id)
                self._spans[trial_id] = span
            return span.span_id

    def span_id(self, trial_id: str) -> Optional[str]:
        with self._lock:
            span = self._spans.get(trial_id)
            return span.span_id if span else None

    def partition_of(self, trial_id: str) -> Optional[int]:
        """The trial's LAST observed partition (the fork-affinity hint:
        where the parent's warm slot and checkpoint live), or None."""
        with self._lock:
            span = self._spans.get(trial_id)
            return span.partition if span else None

    def mark(self, trial_id: str, phase: str, t: Optional[float] = None,
             partition: Optional[int] = None) -> tuple:
        """Record ``phase`` on the trial's span (minting it if the caller
        skipped mint — robustness for resumed/requeued trials). Returns
        ``(span_id, first)`` where ``first`` says whether this was the
        phase's first occurrence on the span. Only the first occurrence
        lands in the span's timeline; the caller decides what to journal
        (every occurrence by default, first-only for phases a heartbeat
        loop would otherwise repeat)."""
        t = time.time() if t is None else t
        with self._lock:
            span = self._spans.get(trial_id)
            if span is None:
                span = TrialSpan(pysecrets.token_hex(6), trial_id)
                self._spans[trial_id] = span
            first = phase not in span.phases
            span.phases.setdefault(phase, t)
            if partition is not None:
                span.partition = int(partition)
            return span.span_id, first

    def restore(self, trial_id: str, span_id: Optional[str], phase: str,
                t: Optional[float], partition: Optional[int] = None) -> None:
        """Rebuild one journaled phase occurrence into the tracker
        (crash-only recovery / resume): the span keeps its ORIGINAL
        journaled id — a recovered trial's later phases must land on the
        same span the pre-crash events named, or the journal would carry
        two spans for one trial — and first-occurrence timestamps are
        preserved (setdefault, like mark). ``once=True`` emit dedup then
        works across incarnations for free: a phase the dead incarnation
        already journaled is not first on the restored span."""
        if t is None:
            return
        with self._lock:
            span = self._spans.get(trial_id)
            if span is None:
                span = TrialSpan(span_id or pysecrets.token_hex(6), trial_id)
                self._spans[trial_id] = span
            span.phases.setdefault(phase, t)
            if partition is not None:
                span.partition = int(partition)

    def all(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [s.to_dict() for s in self._spans.values()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def _dist_stats(values_ms: List[float]) -> Dict[str, Any]:
    """median/p95/n over a list of millisecond values — the exact shape
    bench.py's historical ``handoff_gaps`` emitted, so BENCH_*.json stays
    comparable across rounds."""
    if not values_ms:
        return {}
    ordered = sorted(values_ms)
    return {"median_ms": round(ordered[len(ordered) // 2], 1),
            "p95_ms": round(ordered[int(len(ordered) * 0.95)], 1),
            "n": len(ordered)}


def derive(events: List[Dict[str, Any]],
           handoff_cap_s: float = HANDOFF_CAP_S) -> Dict[str, Any]:
    """Derived scheduling metrics from journal events (pure function).

    - ``handoff``: per-partition gap from one trial's ``finalized`` to the
      SAME runner's next trial ``running`` — the control plane's per-trial
      overhead. Gaps >= ``handoff_cap_s`` (rung-barrier idling) and negative
      gaps (requeue overlap) are excluded.
    - ``early_stop_reaction``: ``stop_flagged`` (driver armed the flag) to
      that trial's ``finalized`` (runner confirmed the stop) — how fast an
      early-stop frees its runner.
    - ``requeue_recovery``: each ``requeued`` occurrence to the SAME
      trial's next ``assigned`` — how fast a lost trial re-enters a
      runner (the recovery-latency edge chaos soaks assert on).
    - ``suggest``: the hand-off pipeline's health — prefetch hit/miss
      counts + hit rate (``prefetch_hit``/``prefetch_miss`` phase events)
      and controller suggest() latency (``ev: "suggest"`` events with an
      ``ms`` field, recorded by the driver's suggester thread and inline
      fallback). Empty when the experiment ran without prefetch.
    - ``compile``: the compile-once hot path's health — warm-slot hit
      counts/rate from ``compiled`` phase events, ttfm distributions split
      by cold/warm, the attributed phase distributions (init/trace/
      compile/first_step), and the persistent XLA compilation cache's
      cumulative hit/miss counts summed over runners (from the
      ``runner_stats`` events' counter fields). Empty for pre-warm
      journals.
    - ``fork``: checkpoint-forking genealogy — forked vs from-scratch
      promotion counts, the parent steps the forks did NOT re-train
      (``steps_saved``), fork-load (checkpoint staging) latency p50/p95,
      downgrades (``fork_source_lost``) and ``ckpt_gc`` retirements.
      Empty for non-forking journals.
    - ``goodput``: the chip-time ledger (telemetry/goodput.py) — every
      held runner-second classified into the closed GOODPUT_BUCKETS
      taxonomy (train vs init/trace/compile/ckpt/fork_stage/rework/
      handoff/queue_wait/idle/unaccounted), per-partition and per-trial,
      gang-aware. Empty for journals with no runner activity.
    - ``trials``: lifecycle counts.
    """
    # Lazy import: goodput.py imports HANDOFF_CAP_S from this module at
    # top level, so the cycle is broken here, not there.
    from maggy_tpu_torch.telemetry.goodput import compute_goodput
    by_partition: Dict[int, List[tuple]] = {}
    stop_flagged: Dict[str, float] = {}
    finalized_at: Dict[str, float] = {}
    requeued_at: Dict[str, List[float]] = {}
    assigned_at: Dict[str, List[float]] = {}
    finalized = errors = lost = requeues = 0
    # Distinct trials, not 'queued' events: a resumed experiment's
    # continuous journal re-queues in-flight trials, and double-counting
    # them would overstate the schedule.
    created: set = set()
    early: set = set()
    hits = misses = 0
    suggest_ms: List[float] = []
    preempted_at: Dict[str, List[float]] = {}
    resumed_at: Dict[str, List[float]] = {}
    preempt_resumed = 0
    compiled_recs: Dict[str, Dict[str, Any]] = {}
    cache_cum: Dict[Any, Dict[str, int]] = {}
    cache_banked: Dict[Any, Dict[str, int]] = {}
    forked: Dict[str, Dict[str, Any]] = {}
    parented: set = set()
    fork_downgrades = 0
    ckpt_gcs = 0
    for ev in events:
        if ev.get("ev") == "suggest":
            if ev.get("ms") is not None:
                suggest_ms.append(float(ev["ms"]))
            continue
        if ev.get("ev") == "runner_stats":
            # Cumulative per-runner counters: monotone within ONE runner
            # process, but a replaced runner (chaos kill, pool respawn)
            # restarts at zero — a value going backwards marks the new
            # attempt, so bank the dead attempt's total instead of letting
            # the overwrite erase it from the sums.
            cum = cache_cum.setdefault(ev.get("partition"), {})
            bank = cache_banked.setdefault(ev.get("partition"), {})
            for key in ("xla_cache_hits", "xla_cache_misses",
                        "warm_hits", "warm_misses"):
                if ev.get(key) is not None:
                    v = int(ev[key])
                    if v < cum.get(key, 0):
                        bank[key] = bank.get(key, 0) + cum[key]
                    cum[key] = v
            continue
        if ev.get("ev") == "ckpt_gc":
            ckpt_gcs += 1
            continue
        if ev.get("ev") != "trial":
            continue
        phase, t, trial = ev.get("phase"), ev.get("t"), ev.get("trial")
        if t is None or trial is None:
            continue
        if phase == "queued":
            created.add(trial)
            if (ev.get("info") or {}).get("parent") is not None:
                # Fork-eligible: a parent-carrying schedule entry (ASHA
                # promotion, PBT segment, BO near-duplicate). Whether it
                # actually forked is decided by its forked_from edge.
                parented.add(trial)
        elif phase == "running":
            pid = ev.get("partition")
            if pid is not None:
                by_partition.setdefault(int(pid), []).append(("run", t, trial))
        elif phase == "assigned":
            assigned_at.setdefault(trial, []).append(t)
        elif phase == "stop_flagged":
            stop_flagged.setdefault(trial, t)
        elif phase == "prefetch_hit":
            hits += 1
        elif phase == "prefetch_miss":
            misses += 1
        elif phase == "compiled":
            compiled_recs.setdefault(trial, ev)
        elif phase == "forked_from":
            forked.setdefault(trial, ev)
        elif phase == "preempted":
            preempted_at.setdefault(trial, []).append(t)
        elif phase == "resumed":
            preempt_resumed += 1
            resumed_at.setdefault(trial, []).append(t)
        elif phase == "lost":
            lost += 1
        elif phase == "requeued":
            requeues += 1
            requeued_at.setdefault(trial, []).append(t)
            if ev.get("reason") == "fork_source_lost":
                fork_downgrades += 1
        elif phase == "finalized":
            finalized += 1
            if ev.get("error"):
                errors += 1
            if ev.get("early_stop"):
                early.add(trial)
            finalized_at[trial] = t
            pid = ev.get("partition")
            if pid is not None:
                by_partition.setdefault(int(pid), []).append(("fin", t, trial))
    gaps: List[float] = []
    for seq in by_partition.values():
        seq.sort(key=lambda e: e[1])
        last_fin = None
        for kind, t, _trial in seq:
            if kind == "fin":
                last_fin = t
            elif last_fin is not None:  # "run" after a finalize
                gap = t - last_fin
                if 0 <= gap < handoff_cap_s:
                    gaps.append(gap * 1e3)
                last_fin = None
    reactions = [(finalized_at[tid] - t0) * 1e3
                 for tid, t0 in stop_flagged.items()
                 if tid in finalized_at and finalized_at[tid] >= t0]
    recoveries: List[float] = []
    for tid, times in requeued_at.items():
        marks = sorted(assigned_at.get(tid, []))
        for t0 in times:
            nxt = next((t for t in marks if t >= t0), None)
            if nxt is not None:
                recoveries.append((nxt - t0) * 1e3)
    suggest: Dict[str, Any] = {}
    if hits or misses or suggest_ms:
        suggest = {"prefetch_hits": hits, "prefetch_misses": misses,
                   "hit_rate": round(hits / (hits + misses), 3)
                   if (hits + misses) else None,
                   "latency": _dist_stats(suggest_ms)}
    # Preemption -> resume latency: each preempted occurrence to the SAME
    # trial's next resumed (checkpoint-assisted) re-dispatch.
    preempt: Dict[str, Any] = {}
    if preempted_at:
        resume_lat = []
        for tid, times in preempted_at.items():
            marks = sorted(resumed_at.get(tid, []))
            for t0 in times:
                nxt = next((t for t in marks if t >= t0), None)
                if nxt is not None:
                    resume_lat.append((nxt - t0) * 1e3)
        preempt = {"n": sum(len(v) for v in preempted_at.values()),
                   "resumed": preempt_resumed,
                   "resume_latency": _dist_stats(resume_lat)}
    # Compile-once hot path: warm hit rate + ttfm split cold/warm + the
    # attributed phase distributions + persistent-cache counters.
    compile_block: Dict[str, Any] = {}
    if compiled_recs or any(cache_cum.values()):
        def _counter_total(key):
            return (sum(c.get(key, 0) for c in cache_cum.values())
                    + sum(b.get(key, 0) for b in cache_banked.values()))

        warm_recs = [r for r in compiled_recs.values() if r.get("warm")]
        cold_recs = [r for r in compiled_recs.values() if not r.get("warm")]
        hits_n, misses_n = len(warm_recs), len(cold_recs)
        if not compiled_recs:
            # No per-trial compiled records survived (runner died before
            # its flush) but the heartbeat-shipped cumulative counters
            # did — report THOSE instead of a contradictory zero.
            hits_n = _counter_total("warm_hits")
            misses_n = _counter_total("warm_misses")

        def ms_dist(recs, key):
            return _dist_stats([float(r[key]) for r in recs
                                if r.get(key) is not None])

        all_recs = list(compiled_recs.values())
        compile_block = {
            "warm_hits": hits_n, "warm_misses": misses_n,
            "warm_hit_rate": round(hits_n / (hits_n + misses_n), 3)
            if (hits_n + misses_n) else None,
            "ttfm_cold": ms_dist(cold_recs, "ttfm_ms"),
            "ttfm_warm": ms_dist(warm_recs, "ttfm_ms"),
            "init_ms": ms_dist(all_recs, "init_ms"),
            "trace_ms": ms_dist(all_recs, "trace_ms"),
            "compile_ms": ms_dist(all_recs, "compile_ms"),
            "first_step_ms": ms_dist(all_recs, "first_step_ms"),
        }
        cache_hits = _counter_total("xla_cache_hits")
        cache_misses = _counter_total("xla_cache_misses")
        if cache_hits or cache_misses:
            compile_block["cache"] = {
                "hits": cache_hits, "misses": cache_misses,
                "hit_rate": round(cache_hits / (cache_hits + cache_misses),
                                  3)}
    # Checkpoint-forking search: genealogy + the compute the forks saved.
    # forked = trials dispatched with a forked_from edge; from_scratch =
    # parent-carrying schedule entries (promotions/exploits) that ran
    # without one (fork off, parent never checkpointed, or downgraded);
    # steps_saved = parent steps NOT re-trained (the fork points summed);
    # fork_load_ms = the runner-measured checkpoint staging cost (from
    # the compiled records).
    fork_block: Dict[str, Any] = {}
    if forked or parented or ckpt_gcs:
        load_ms = [float(r["fork_load_ms"])
                   for r in compiled_recs.values()
                   if r.get("fork_load_ms") is not None]
        fork_block = {
            "forked": len(forked),
            "from_scratch": len(parented - set(forked)),
            # A fork at step S skips re-training steps 0..S: S+1 saved.
            "steps_saved": sum(int(e["step"]) + 1
                               for e in forked.values()
                               if e.get("step") is not None),
            "fork_load_ms": _dist_stats(load_ms),
            "downgrades": fork_downgrades,
            "ckpt_gc": ckpt_gcs,
        }
    return {
        "trials": {"created": len(created), "finalized": finalized,
                   "early_stopped": len(early), "errors": errors,
                   "lost": lost, "requeued": requeues},
        "handoff": _dist_stats(gaps),
        "early_stop_reaction": _dist_stats(reactions),
        "requeue_recovery": _dist_stats(recoveries),
        "suggest": suggest,
        "preempt": preempt,
        "compile": compile_block,
        "fork": fork_block,
        "goodput": compute_goodput(events, handoff_cap_s=handoff_cap_s),
    }
