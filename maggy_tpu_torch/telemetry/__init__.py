"""Unified telemetry: metrics registry, trial-span tracing, event journal.

The port's copy of ``maggy_tpu/telemetry/`` for one experiment: the
scheduling-efficiency claim (early-stop a trial, hand the freed runner new
work with near-zero gap) is a queryable artifact instead of ad-hoc timers.
Three pieces:

- ``MetricsRegistry`` (metrics.py): counters / gauges / fixed-bound
  histograms, thread-safe, snapshot-able to plain dicts.
- ``SpanTracker`` + ``derive`` (spans.py): per-trial phase timestamps
  (queued -> assigned -> running -> first_metric -> stop_flagged ->
  finalized) and the PURE derivation of hand-off gap and early-stop
  reaction latency from them.
- ``TelemetryJournal`` (journal.py): batched JSONL persistence through the
  environment abstraction, with zero blocking I/O on the RPC hot path.

``Telemetry`` is the facade the driver owns; the RPC server exposes its
snapshot via the TELEM verb, and ``replay_journal`` replays a journal
offline to reproduce the driver's numbers exactly. The journal's strings
are the JAX package's (vocab.py), so either package replays the other's
journal. A resumed experiment reloads the journal of its interrupted
incarnations (``TelemetryJournal.load_existing``) and rebuilds its spans
from it (``Telemetry.restore_spans``). The fleet journal sink, the health
engine and the observability server are not ported yet (ROADMAP queue 1
items 9 and 11).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from maggy_tpu_torch.telemetry.journal import TelemetryJournal, read_events
from maggy_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                               MetricsRegistry)
from maggy_tpu_torch.telemetry.spans import (HANDOFF_CAP_S, PHASES, SpanTracker,
                                             TrialSpan, derive)

#: Journal filename inside an experiment directory.
JOURNAL_NAME = "telemetry.jsonl"


class Telemetry:
    """Facade tying registry + spans + journal to one experiment.

    All record paths are buffer-only (thread-safe, no I/O); persistence
    happens on the journal's flusher thread. ``enabled=False`` turns every
    method into a cheap no-op so experiments can opt out wholesale.
    """

    def __init__(self, env=None, journal_path: Optional[str] = None,
                 enabled: bool = True, flush_interval_s: float = 1.0,
                 sink=None, fsync: Optional[bool] = None):
        if sink is not None:
            raise NotImplementedError(
                "the fleet journal sink is not ported yet (ROADMAP queue 1 item 9)")
        self.enabled = enabled
        self.metrics = MetricsRegistry()
        self.spans = SpanTracker()
        self.journal: Optional[TelemetryJournal] = None
        if enabled and env is not None and journal_path:
            self.journal = TelemetryJournal(
                env, journal_path, flush_interval_s=flush_interval_s, fsync=fsync)
        # Journal-less fallback buffer (no env/path given): spans still
        # derive for the TELEM verb, just without persistence.
        self._local_lock = threading.Lock()
        self._local_events: List[Dict[str, Any]] = []  # guarded-by: _local_lock
        # snapshot() runs on the RPC event loop; derive() is O(events), so
        # cache it: (monotonic t, event count, derived). Recomputed only
        # when events arrived AND the cache is older than a second.
        self._derive_cache = (0.0, -1, {})
        # Runner-side stats (runnerstats.RunnerStats deltas shipped on
        # heartbeat METRIC payloads), merged per partition.
        self._runner_lock = threading.Lock()
        self._runner_state: Dict[int, Dict[str, Any]] = {}  # guarded-by: _runner_lock
        # Trials whose compiled record already bumped the live registry
        # counters (the journal itself is deduped by once=True).
        self._compiled_seen: set = set()  # guarded-by: _runner_lock

    # ------------------------------------------------------------ recording

    def trial_event(self, trial_id: Optional[str], phase: str,
                    once: bool = False, t: Optional[float] = None,
                    **fields: Any) -> Optional[str]:
        """Mark ``phase`` on the trial's span (minting it on first sight)
        and journal the occurrence, stamped now or at ``t`` (an edge that
        recovery journals late, at the time it happened). ``once=True``
        journals/counts only the phase's FIRST occurrence — for phases a
        heartbeat loop would otherwise repeat until the runner reacts (e.g.
        stop_sent). Returns the span id."""
        if not self.enabled or not trial_id:
            return None
        t = time.time() if t is None else t
        span_id, first = self.spans.mark(trial_id, phase, t=t,
                                         partition=fields.get("partition"))
        if once and not first:
            return span_id
        self._record({"t": t, "ev": "trial", "trial": trial_id,
                      "span": span_id, "phase": phase, **fields})
        self.metrics.counter("trial.phase.{}".format(phase)).inc()
        return span_id

    def event(self, ev: str, **fields: Any) -> None:
        """Journal a non-trial event (runner/experiment lifecycle)."""
        if not self.enabled:
            return
        self._record({"t": time.time(), "ev": ev, **fields})

    def _record(self, event: Dict[str, Any]) -> None:
        if self.journal is not None:
            self.journal.record(event)
        else:
            with self._local_lock:
                self._local_events.append(event)

    def record_runner_stats(self, partition, stats: Dict[str, Any]) -> None:
        """Merge one runner's shipped stats delta (the ``rstats`` field a
        heartbeat METRIC piggybacked): update the live per-partition state
        + registry gauges, journal the delta with partition attribution,
        and journal a ``profile_skipped`` trial event for any trial the
        runner reported running untraced. Buffer-only, like every record
        path — this runs on the RPC event loop."""
        if not self.enabled or partition is None or not stats:
            return
        pid = int(partition)
        stats = dict(stats)
        skipped = stats.pop("profile_skipped", None) or []
        compile_events = stats.pop("compile_events", None) or []
        ckpt_events = stats.pop("ckpt_events", None) or []
        if stats:
            with self._runner_lock:
                merged = self._runner_state.setdefault(pid, {})
                merged.update(stats)
                merged["updated_t"] = time.time()
            for key in ("hb_rtt_ms", "rss_mb", "dev_mem_mb", "cadence_ms",
                        "ttfm_ms", "warm_hits", "warm_misses",
                        "xla_cache_hits", "xla_cache_misses"):
                if stats.get(key) is not None:
                    self.metrics.gauge(
                        "runner.{}.p{}".format(key, pid)).set(stats[key])
            self._record({"t": time.time(), "ev": "runner_stats",
                          "partition": pid, **stats})
        for trial_id in skipped:
            self.trial_event(trial_id, "profile_skipped", partition=pid)
        for record in compile_events:
            # The runner's ttfm breakdown (warm/init_ms/first_step_ms)
            # journaled as the trial's ``compiled`` span phase — once per
            # span, so a re-delivered delta cannot double-count.
            record = dict(record)
            trial_id = record.pop("trial", None)
            if not trial_id:
                continue
            self.trial_event(trial_id, "compiled", partition=pid,
                             once=True, **record)
            with self._runner_lock:
                first = trial_id not in self._compiled_seen
                self._compiled_seen.add(trial_id)
            if first:
                self.metrics.counter(
                    "compile.warm_hits" if record.get("warm")
                    else "compile.warm_misses").inc()
        for record in ckpt_events:
            # Checkpoint I/O totals journaled as the trial's ``ckpt_saved``
            # span phase — once per span, same re-delivery dedup.
            record = dict(record)
            trial_id = record.pop("trial", None)
            if not trial_id:
                continue
            self.trial_event(trial_id, "ckpt_saved", partition=pid,
                             once=True, **record)

    def prune_partition(self, partition) -> None:
        """Forget a dead/replaced partition's live state: its
        ``runner.<field>.p<pid>`` gauges and merged runner-stats entry.
        Called by the driver on the LOST path and when a
        runner is released — a reaped runner's last RSS/cadence must not
        sit in the registry forever. The journal keeps the history; this
        only clears the LIVE view. A re-registered partition repopulates
        on its next heartbeat."""
        if not self.enabled or partition is None:
            return
        pid = int(partition)
        suffix = ".p{}".format(pid)
        self.metrics.prune(
            lambda name: name.startswith("runner.")
            and name.endswith(suffix))
        with self._runner_lock:
            self._runner_state.pop(pid, None)

    def runner_state(self) -> Dict[int, Dict[str, Any]]:
        """Per-partition merged runner stats (copies)."""
        with self._runner_lock:
            return {pid: dict(s) for pid, s in self._runner_state.items()}

    def observe_ms(self, name: str, ms: float) -> None:
        if self.enabled:
            self.metrics.histogram(name).observe(ms)

    # ------------------------------------------------------------- querying

    def events(self) -> List[Dict[str, Any]]:
        if self.journal is not None:
            return self.journal.events()
        with self._local_lock:
            return list(self._local_events)

    def _num_events(self) -> int:
        if self.journal is not None:
            return len(self.journal)
        with self._local_lock:
            return len(self._local_events)

    def _derived_spans(self, max_age_s: float = 1.0) -> Dict[str, Any]:
        t0, n0, cached = self._derive_cache
        now = time.monotonic()
        n = self._num_events()
        if n == n0 or (now - t0 < max_age_s and n0 >= 0):
            return cached
        derived = derive(self.events())
        self._derive_cache = (now, n, derived)
        return derived

    def snapshot(self, fresh: bool = False) -> Dict[str, Any]:
        """Plain-dict snapshot: live metrics + span-derived scheduling
        numbers (derivation cached, at most ~1 Hz — pass ``fresh=True``
        for a finalize-time snapshot that must include the last events).
        This is the TELEM RPC reply body."""
        if not self.enabled:
            return {"enabled": False}
        return {"enabled": True,
                "metrics": self.metrics.snapshot(),
                "spans": self._derived_spans(max_age_s=0.0 if fresh else 1.0),
                "num_spans": len(self.spans),
                "runners": self.runner_state(),
                "journal": {"torn_lines": self.journal.torn_lines
                            if self.journal is not None else 0}}

    def restore_spans(self) -> int:
        """Rebuild the span tracker from the journal's restored trial events
        (crash-only recovery, ``maggy_tpu/telemetry/__init__.py:317-338``):
        each trial keeps its pre-crash span id and first-occurrence phase
        times, so the recovered driver's later phase events continue the same
        spans and ``once=True`` dedup (stop_sent, prefetch hit/miss,
        forked_from) holds across incarnations. Returns the number of trial
        events replayed into the tracker."""
        if not self.enabled:
            return 0
        n = 0
        for ev in self.events():
            if ev.get("ev") != "trial" or not ev.get("trial"):
                continue
            self.spans.restore(ev["trial"], ev.get("span"), ev.get("phase"), ev.get("t"),
                               partition=ev.get("partition"))
            n += 1
        return n

    # ------------------------------------------------------------ lifecycle

    def flush(self) -> None:
        if self.journal is not None:
            self.journal.flush()

    def barrier(self) -> None:
        """Terminal-event durability barrier: make the buffered journal
        suffix durable now. The FINAL path runs it before its RPC reply is
        written, so an acknowledged FINAL is never absent from the recovery
        source of truth (``maggy_tpu/telemetry/__init__.py:343-355``)."""
        if self.journal is not None:
            self.journal.barrier()

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()


def replay_journal(path: str, env=None) -> Dict[str, Any]:
    """Offline replay: journal file -> derived scheduling metrics. Pure —
    the same journal always reproduces the same numbers. The output
    additionally carries ``torn_lines``: corrupt journal lines the reader
    skipped, so corruption is visible instead of quietly shrinking the
    dataset."""
    events = read_events(path, env=env)
    out = derive(events)
    out["torn_lines"] = getattr(events, "torn_lines", 0)
    return out


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SpanTracker", "TrialSpan", "PHASES", "HANDOFF_CAP_S", "derive",
    "TelemetryJournal", "read_events", "replay_journal",
    "Telemetry", "JOURNAL_NAME",
]
