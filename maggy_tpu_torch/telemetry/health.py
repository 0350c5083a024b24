"""Live health engine: driver-side straggler / hang / RTT-degradation
detection over trial spans + runner stats.

The port's copy of ``maggy_tpu/telemetry/health.py`` (same checks, same
constants, same journal events). The chaos engine can inject a stalled
runner; ``HealthEngine`` watches a live run for one: a periodic
analyzer (own daemon thread, ``telemetry-health``) over the telemetry
facade's in-memory state — spans, merged runner stats, per-partition
progress stamps — computing three checks:

- **straggler**: median-absolute-deviation outliers across partitions, on
  (a) first-metric latency (running → first_metric per span — the
  compile/startup cost) and (b) runner-reported broadcast cadence. MAD is
  robust to the one runner being slow (the case under test); a zero-MAD
  fleet (all identical) is guarded by an absolute excess floor so healthy
  uniform runs can never divide their way into a flag.
- **hb_rtt**: a partition whose heartbeat round-trip EWMA exceeds
  ``rtt_factor`` x the fleet median (with an absolute floor) — control
  plane degradation localized to one runner's path.
- **hang**: a partition holding a trial whose journal progress (trial
  phase events, runner-reported steps — NOT liveness-only fields like
  RTT) stalled for longer than ``hang_factor`` x the heartbeat interval.
  On raise, the engine journals a faulthandler thread dump alongside the
  flag (in-process pools: the wedged runner thread's stack is IN the
  dump; process pools: the driver side's, still timestamped evidence).
  This catches sub-``hb_loss_timeout`` stalls the loss scan is blind to —
  a runner can stall for 80% of the loss bound forever without ever
  being declared lost.

Findings are journaled as ``health`` events (``status: raised|cleared``),
surfaced in the TELEM snapshot and the obs plane's /healthz, and
asserted by the chaos harness's stall invariant: an injected
``stall_runner`` fault must produce a straggler/hang flag for the stalled
partition within bounded time.

All record paths stay buffer-only: the engine reads in-memory state and
journals through ``Telemetry.event`` — no I/O on any hot path.
"""

from __future__ import annotations

import threading
import time
from statistics import median as _median
from typing import Any, Dict, List, Optional

#: Default number of heartbeat intervals without trial progress before a
#: partition holding a trial is flagged as hung.
DEFAULT_HANG_FACTOR = 25.0

#: Default hang-bound multiplier for trials still pre-first_metric (the
#: silent first step: a Trainer's build and its step's capture). Shared with the chaos harness's
#: invariant-5 bound so the watchdog and its verifier can't diverge.
DEFAULT_STARTUP_FACTOR = 4.0


def default_interval_s(hb_interval: float) -> float:
    """The engine's check cadence when none is configured. One home —
    the chaos harness derives its flag bound from the same rule."""
    return max(0.25, float(hb_interval))

#: Default modified-z-score threshold for MAD straggler flags (3.5 is the
#: textbook Iglewicz-Hoaglin cut).
DEFAULT_MAD_THRESHOLD = 3.5

#: Checks the chaos stall invariant accepts as "the health engine saw the
#: stalled partition".
STALL_CHECKS = ("hang", "straggler")


def thread_dump(max_bytes: int = 8192) -> str:
    """All-threads stack dump via faulthandler (needs a real fd; staged
    through a tempfile), falling back to sys._current_frames. Returns at
    most ``max_bytes`` of the tail — journal events must stay bounded."""
    try:
        import faulthandler
        import tempfile

        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()[-max_bytes:]
    except Exception:  # noqa: BLE001 - restricted environments
        try:
            import sys
            import traceback

            parts = []
            for tid, frame in sys._current_frames().items():
                parts.append("Thread 0x{:x}:\n{}".format(
                    tid, "".join(traceback.format_stack(frame))))
            return "\n".join(parts)[-max_bytes:]
        except Exception:  # noqa: BLE001
            return "<thread dump unavailable>"


class HealthEngine:
    """Periodic analyzer; ``check()`` is also directly callable (tests run
    it deterministically without the thread)."""

    def __init__(self, telemetry, hb_interval: float = 1.0,
                 interval_s: Optional[float] = None,
                 hang_factor: float = DEFAULT_HANG_FACTOR,
                 mad_threshold: float = DEFAULT_MAD_THRESHOLD,
                 min_partitions: int = 3,
                 straggler_min_excess_ms: float = 500.0,
                 rtt_factor: float = 4.0, rtt_floor_ms: float = 50.0,
                 startup_factor: float = DEFAULT_STARTUP_FACTOR,
                 dump_threads_on_hang: bool = True):
        self.telemetry = telemetry
        self.hb_interval = float(hb_interval)
        self.interval_s = float(interval_s) if interval_s is not None \
            else default_interval_s(self.hb_interval)
        self.hang_factor = float(hang_factor)
        self.mad_threshold = float(mad_threshold)
        self.min_partitions = int(min_partitions)
        self.straggler_min_excess_ms = float(straggler_min_excess_ms)
        self.rtt_factor = float(rtt_factor)
        self.rtt_floor_ms = float(rtt_floor_ms)
        #: Hang-bound multiplier while a trial is still PRE-first_metric:
        #: the first step legitimately compiles for a long time with zero
        #: broadcasts, and that silence must not read as a hang at the
        #: steady-state bound (a true startup wedge still flags, just
        #: later).
        self.startup_factor = float(startup_factor)
        self.dump_threads_on_hang = dump_threads_on_hang
        self.reservations = None
        #: Optional telemetry.profiling.ProfileCapturer: the FIRST
        #: straggler/hang raise per partition triggers a device-profile
        #: capture (rate-limited there), so a flagged anomaly yields an
        #: inspectable artifact, not just a journal line. Attached by
        #: the driver when the observability plane is on.
        self.profiler = None
        self._lock = threading.Lock()
        #: (check, metric, partition) -> active flag dict.
        self._active: Dict[tuple, Dict[str, Any]] = {}  # guarded-by: _lock
        self.raised_total = 0  # guarded-by: _lock
        self.checks_run = 0  # guarded-by: _lock
        self._last_check_t: Optional[float] = None  # guarded-by: _lock
        self._check_failed = False  # unguarded-ok: engine-loop-private latch, single writer thread
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach(self, reservations=None, profiler=None) -> None:
        """Late-bind the authoritative partition->trial assignment view
        (the server's Reservations) for the hang watchdog, and/or the
        profile capturer for health-triggered captures."""
        if reservations is not None:
            self.reservations = reservations
        if profiler is not None:
            self.profiler = profiler

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is None:
            # Liveness marker: the journal must SAY the engine ran, so an
            # offline invariant check (chaos harness invariant 5) can tell
            # "stall went unflagged" apart from "nothing was watching"
            # (health=False runs, pre-health journals).
            self.telemetry.event(
                "health", check="engine", status="started",
                interval_s=round(self.interval_s, 3),
                hang_factor=self.hang_factor)
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="telemetry-health")
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception as e:  # noqa: BLE001 - must never kill the engine
                if not self._check_failed:
                    self._check_failed = True
                    try:
                        self.telemetry.event("health", check="engine",
                                             status="error", error=repr(e))
                    except Exception:  # noqa: BLE001
                        pass

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # --------------------------------------------------------------- checks

    def check(self) -> List[Dict[str, Any]]:
        """Run every check once; reconcile with the active-flag set
        (journal newly-raised and newly-cleared findings exactly once).
        Returns the currently-active flags."""
        findings: List[Dict[str, Any]] = []
        findings += self._check_hang()
        findings += self._check_stragglers()
        findings += self._check_rtt()
        desired = {(f["check"], f.get("metric"), f["partition"]): f
                   for f in findings}
        raised: List[Dict[str, Any]] = []
        cleared: List[Dict[str, Any]] = []
        with self._lock:
            self.checks_run += 1
            self._last_check_t = time.time()
            for key, f in desired.items():
                if key not in self._active:
                    f = dict(f, since=time.time())
                    self._active[key] = f
                    self.raised_total += 1
                    raised.append(f)
                else:
                    # Keep the live detail fresh (monitor shows current
                    # values), without re-journaling.
                    self._active[key].update(
                        {k: v for k, v in f.items() if k != "since"})
            for key in list(self._active):
                if key not in desired:
                    cleared.append(self._active.pop(key))
            active = [dict(f) for f in self._active.values()]
        for f in raised:
            fields = {k: v for k, v in f.items() if k != "since"}
            if f["check"] == "hang" and self.dump_threads_on_hang:
                fields["stacks"] = thread_dump()
            self.telemetry.event("health", status="raised", **fields)
            profiler = self.profiler
            if profiler is not None:
                # First straggler/hang raise per partition -> capture a
                # device profile at the moment of the anomaly (rate
                # limiting lives in the capturer; runs on its own
                # thread, so the check cadence is unaffected).
                profiler.auto_capture(check=f["check"],
                                      partition=f.get("partition"),
                                      trial=f.get("trial"))
        for f in cleared:
            self.telemetry.event(
                "health", status="cleared", check=f["check"],
                metric=f.get("metric"), partition=f["partition"])
        return active

    def _check_hang(self) -> List[Dict[str, Any]]:
        base_bound = self.hang_factor * self.hb_interval
        now = time.monotonic()
        # Trials still compiling (no first_metric yet) get startup_factor
        # x the bound: a long first step (build, capture) is silent by nature.
        # A REQUEUED trial stays in the startup window too — its span
        # keeps the dead attempt's first_metric (first-occurrence
        # semantics), but the rescue partition recompiles from scratch
        # and deserves the same leash the first attempt had.
        started = set()
        for span in self.telemetry.spans.all():
            phases = span.get("phases") or {}
            if "first_metric" in phases and "requeued" not in phases:
                started.add(span.get("trial"))
        out: List[Dict[str, Any]] = []
        for pid, trial_id in self._assignments():
            last = self.telemetry.last_progress(pid)
            if last is None:
                continue
            window = "steady" if trial_id in started else "startup"
            bound_s = base_bound if window == "steady" \
                else base_bound * self.startup_factor
            silent = now - last
            if silent > bound_s:
                out.append({"check": "hang", "metric": "progress",
                            "partition": pid, "trial": trial_id,
                            "window": window,
                            "silent_s": round(silent, 2),
                            "bound_s": round(bound_s, 2)})
        return out

    def _assignments(self) -> List[tuple]:
        """(partition, trial) pairs currently holding work. Authoritative
        via the attached Reservations; span-derived fallback otherwise
        (in-flight spans: running seen, finalized not)."""
        res = self.reservations
        if res is not None:
            try:
                return [(pid, rec.get("trial_id"))
                        for pid, rec in res.all().items()
                        if rec.get("trial_id") is not None
                        and not rec.get("released")]
            except Exception:  # noqa: BLE001
                return []
        out = []
        for span in self.telemetry.spans.all():
            phases = span.get("phases") or {}
            if "running" in phases and "finalized" not in phases \
                    and span.get("partition") is not None:
                out.append((int(span["partition"]), span.get("trial")))
        return out

    def _mad_outliers(self, per_partition: Dict[int, float], metric: str,
                      check: str = "straggler") -> List[Dict[str, Any]]:
        """One-sided (slower-than-fleet) modified-z-score outliers with an
        absolute excess floor (a zero-MAD fleet must not flag jitter)."""
        if len(per_partition) < self.min_partitions:
            return []
        values = list(per_partition.values())
        med = _median(values)
        sigma = 1.4826 * _median([abs(v - med) for v in values])
        out = []
        for pid, v in per_partition.items():
            excess = v - med
            if excess <= max(self.mad_threshold * sigma,
                             self.straggler_min_excess_ms):
                continue
            score = excess / sigma if sigma > 0 else float("inf")
            out.append({"check": check, "metric": metric, "partition": pid,
                        "value_ms": round(v, 1),
                        "fleet_median_ms": round(med, 1),
                        "score": round(min(score, 999.0), 2)})
        return out

    def _check_stragglers(self) -> List[Dict[str, Any]]:
        # (a) first-metric latency per partition, from the span timelines.
        # Requeued/lost trials are EXCLUDED: a span keeps its FIRST
        # 'running' timestamp but its LAST partition, so a trial that died
        # on partition A and reached first_metric on its rescue partition
        # B would charge the whole death + loss-timeout + re-dispatch
        # interval to healthy B — a false straggler against the rescuer.
        ttfm: Dict[int, List[float]] = {}
        for span in self.telemetry.spans.all():
            phases = span.get("phases") or {}
            if "requeued" in phases or "lost" in phases:
                continue
            t_run, t_fm = phases.get("running"), phases.get("first_metric")
            pid = span.get("partition")
            if t_run is not None and t_fm is not None and pid is not None \
                    and t_fm >= t_run:
                ttfm.setdefault(int(pid), []).append((t_fm - t_run) * 1e3)
        findings = self._mad_outliers(
            {pid: _median(v) for pid, v in ttfm.items()}, "first_metric_ms")
        # (b) runner-reported broadcast cadence per partition.
        cadence = {pid: float(stats["cadence_ms"])
                   for pid, stats in self._fresh_runner_stats().items()
                   if stats.get("cadence_ms") is not None}
        findings += self._mad_outliers(cadence, "cadence_ms")
        return findings

    def _fresh_runner_stats(self) -> Dict[int, Dict[str, Any]]:
        """Per-partition runner stats EXCLUDING stale entries: a dead or
        released runner's last EWMA values would otherwise sit in
        ``_runner_state`` forever, skewing every fleet median and holding
        an uncloseable flag against a partition that no longer exists. A
        live runner refreshes ``updated_t`` on nearly every beat."""
        stale_s = max(10 * self.hb_interval, 3 * self.interval_s)
        now = time.time()
        return {pid: stats
                for pid, stats in self.telemetry.runner_state().items()
                if now - stats.get("updated_t", 0.0) <= stale_s}

    def _check_rtt(self) -> List[Dict[str, Any]]:
        rtts = {pid: float(stats["hb_rtt_ms"])
                for pid, stats in self._fresh_runner_stats().items()
                if stats.get("hb_rtt_ms") is not None}
        if len(rtts) < self.min_partitions:
            return []
        med = _median(list(rtts.values()))
        out = []
        for pid, v in rtts.items():
            if v > max(self.rtt_factor * med, self.rtt_floor_ms):
                out.append({"check": "hb_rtt", "metric": "hb_rtt_ms",
                            "partition": pid, "value_ms": round(v, 2),
                            "fleet_median_ms": round(med, 2)})
        return out

    # ------------------------------------------------------------- querying

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict state for the TELEM reply: active flags + totals."""
        with self._lock:
            flags = [{k: v for k, v in f.items() if k != "stacks"}
                     for f in self._active.values()]
            return {"flags": flags, "raised_total": self.raised_total,
                    "checks_run": self.checks_run,
                    "last_check_t": self._last_check_t}
