"""Runner-side telemetry: the worker's half of the observability stack.

The driver's spans (spans.py) see every control-plane hop, but until now
the runners themselves were blind — no step cadence, compile-stall signal,
heartbeat round-trip time, or memory attribution ever left the worker.
``RunnerStats`` is the lightweight buffer each trial executor owns:

- **train_fn start/end** (``trial_start``/``trial_end``) — wall attribution
  for the time the runner actually spent inside user code;
- **metric-broadcast cadence** (``on_broadcast``, hooked from
  ``Reporter.broadcast``) — an EWMA of the inter-broadcast gap, the
  runner-observed step rate the health engine's straggler scoring feeds on;
- **time-to-first-metric** — trial start to first broadcast, the
  compile-stall proxy (XLA compiles inside the first step);
- **heartbeat round-trip time** (``observe_hb_rtt``, measured in
  ``Client.start_heartbeat``) — control-plane latency as the runner
  experiences it, retries and backoff included;
- **process RSS / device memory** — sampled at most every
  ``mem_interval_s`` via /proc (no psutil) and, when this process already
  holds a CUDA context, ``torch.cuda.memory_allocated()``;
- **compile attribution** (``note_compile``, fed through the trial scope
  of train/warm.py) — the opaque ttfm split into phases: ``init_ms``
  (``Trainer.init``: weights and optimizer state, built or re-initialized
  in a warm unit), ``compile_ms`` (the step's CUDA-graph captures),
  ``first_step_ms`` (the residual at first broadcast: dispatch, the first
  steps' device execution and input staging), plus the trial's ``warm``
  flag (and ``graph_ok``/``graph_error`` when a capture raised). The port
  has no trace phase, so it notes no ``trace_ms``. Shipped once per trial as a
  ``compile_events`` record (drained like ``profile_skipped``, requeued on
  a failed beat) and journaled by the driver as a ``compiled`` span phase;
- **counters** (``note_counter``) — cumulative runner counters routed
  through the trial scope to the right executor's buffer (thread runners
  share one process).

This is the port's copy of ``maggy_tpu/telemetry/runnerstats.py``; only
the device-memory probe differs.

Shipping is piggybacked on the existing heartbeat METRIC payload
(``rstats`` field) — no new socket, no new verb. ``snapshot_delta()``
returns only the fields that changed since the last successful ship
(delta-encoded, bounded to a handful of scalars), so a steady-state
runner adds a few bytes per beat. Every record path is in-memory
arithmetic under one small lock; the only syscalls are the rate-limited
memory probes on the heartbeat thread.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

#: EWMA smoothing for cadence / RTT (~last 10 observations dominate).
_EWMA_ALPHA = 0.2

#: Keys in a shipped delta that evidence TRIAL progress (new broadcasts /
#: a trial boundary), as opposed to liveness-only fields (hb_rtt_ms, rss)
#: a wedged-but-beating runner keeps updating. The driver's hang watchdog
#: counts only these as progress.
PROGRESS_KEYS = ("trial", "steps", "ttfm_ms", "cadence_ms", "trials_done")

#: Sentinel distinguishing "never shipped" from "shipped as None" in the
#: delta ledger: trial/ttfm_ms legitimately TRANSITION to None, and a
#: plain .get(k) would read a requeued (deleted) key as already-None and
#: silently drop the re-send.
_NEVER_SHIPPED = object()


def _rss_mb() -> Optional[float]:
    """Resident set size in MB, dependency-free (Linux /proc, getrusage
    fallback)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except Exception:  # noqa: BLE001 - non-Linux
        try:
            import resource

            # ru_maxrss: KB on Linux, bytes on macOS — close enough for a
            # fallback gauge (the primary path is /proc).
            ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return ru / 1024.0 if sys.platform != "darwin" else ru / 1e6
        except Exception:  # noqa: BLE001
            return None


def _device_mem_mb() -> Optional[float]:
    """Memory allocated by PyTorch on the current CUDA device, when this
    process already holds a CUDA context. NEVER creates one: a context
    costs about 500 MB of card memory and seconds of start-up, and on the
    heartbeat thread a blocked beat reads as runner death (the JAX probe
    guards on a live backend the same way, ``maggy_tpu/telemetry/
    runnerstats.py:87-110``)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        return round(torch.cuda.memory_allocated() / 1e6, 1)
    except Exception:  # noqa: BLE001 - a gauge must never fail a beat
        return None


class RunnerStats:
    """Thread-safe runner-side stat buffer with delta-encoded shipping."""

    def __init__(self, mem_interval_s: float = 2.0):
        self._lock = threading.Lock()
        self.mem_interval_s = mem_interval_s
        self._trial_id: Optional[str] = None  # guarded-by: _lock
        self._trial_t0: Optional[float] = None  # guarded-by: _lock # monotonic train start
        self._last_broadcast: Optional[float] = None  # guarded-by: _lock
        self._steps = 0  # guarded-by: _lock # broadcasts within the current trial
        self._trials_done = 0  # guarded-by: _lock
        self._cadence_ms: Optional[float] = None  # guarded-by: _lock
        self._ttfm_ms: Optional[float] = None  # guarded-by: _lock
        self._hb_rtt_ms: Optional[float] = None  # guarded-by: _lock
        self._rss_mb: Optional[float] = None  # guarded-by: _lock
        self._dev_mem_mb: Optional[float] = None  # guarded-by: _lock
        self._last_mem_sample = 0.0  # guarded-by: _lock
        self._profile_skipped: List[str] = []  # guarded-by: _lock
        self._last_shipped: Dict[str, Any] = {}  # guarded-by: _lock
        # Compile attribution for the CURRENT trial (merged by
        # note_compile; *_ms fields accumulate across e.g. the per-shape
        # AOT compiles of one trial) and the finished records awaiting
        # shipment (ship-once channel, requeued on a failed beat).
        self._compile: Dict[str, Any] = {}  # guarded-by: _lock
        self._compile_final = False  # guarded-by: _lock
        self._ttfm_accounted: Optional[float] = None  # guarded-by: _lock
        self._compile_events: List[Dict[str, Any]] = []  # guarded-by: _lock
        # Checkpoint I/O attribution for the CURRENT trial (merged by
        # note_ckpt; save_ms/restore_ms accumulate across the trial's
        # saves/restores) and the finished records awaiting shipment —
        # the goodput ledger's ckpt_save/ckpt_restore buckets fold from
        # the journaled "ckpt_saved" span phase this becomes.
        self._ckpt: Dict[str, Any] = {}  # guarded-by: _lock
        self._ckpt_final = False  # guarded-by: _lock
        self._ckpt_events: List[Dict[str, Any]] = []  # guarded-by: _lock
        # Cumulative warm-slot / compilation-cache counters for THIS
        # runner (train/warm.py routes them here through the trial scope).
        self._counters: Dict[str, int] = {}  # guarded-by: _lock

    # ----------------------------------------------------------- recording

    def trial_start(self, trial_id: str) -> None:
        """The executor accepted a trial and is about to enter train_fn."""
        with self._lock:
            self._trial_id = trial_id
            self._trial_t0 = time.monotonic()
            self._last_broadcast = None
            self._steps = 0
            self._ttfm_ms = None
            self._compile = {}
            self._compile_final = False
            self._ttfm_accounted = None
            self._ckpt = {}
            self._ckpt_final = False

    def trial_end(self, trial_id: Optional[str] = None) -> None:
        with self._lock:
            if trial_id is not None and trial_id != self._trial_id:
                return
            # The record ships at trial END, not first metric: phases
            # recorded AFTER the first broadcast (a second batch shape
            # compiling mid-trial) still accumulate into the one record.
            # A trial that never broadcast (errored / metric-free) ships
            # too — without the ttfm-derived first_step_ms residual.
            self._finalize_compile_locked()
            self._finalize_ckpt_locked()
            self._trials_done += 1
            self._trial_id = None
            self._trial_t0 = None

    # locked-by: _lock
    def _finalize_compile_locked(self) -> None:
        if self._compile_final or not self._compile:
            return
        record = dict(self._compile)
        record["trial"] = self._trial_id
        if self._ttfm_ms is not None:
            record["ttfm_ms"] = round(self._ttfm_ms, 1)
            # Residual vs the phases accounted BEFORE the first metric
            # (snapshotted in on_broadcast) — a post-first-metric compile
            # is not part of ttfm and must not eat into the residual.
            record["first_step_ms"] = round(
                max(0.0, self._ttfm_ms - (self._ttfm_accounted or 0.0)), 1)
        for k in ("init_ms", "trace_ms", "compile_ms"):
            if k in record:
                record[k] = round(record[k], 1)
        self._compile_events.append(record)
        self._compile_final = True

    # locked-by: _lock
    def _finalize_ckpt_locked(self) -> None:
        if self._ckpt_final or not self._ckpt:
            return
        record = dict(self._ckpt)
        record["trial"] = self._trial_id
        for k in ("save_ms", "restore_ms"):
            if k in record:
                record[k] = round(record[k], 1)
        self._ckpt_events.append(record)
        self._ckpt_final = True

    def note_ckpt(self, **fields: Any) -> None:
        """Merge checkpoint I/O attribution for the current trial.
        ``*_ms`` fields and the ``saves``/``restores`` counts ACCUMULATE
        (a trial checkpoints many times); others are first-write-wins."""
        with self._lock:
            for k, v in fields.items():
                if k.endswith("_ms"):
                    self._ckpt[k] = self._ckpt.get(k, 0.0) + float(v)
                elif k in ("saves", "restores"):
                    self._ckpt[k] = int(self._ckpt.get(k, 0)) + int(v)
                else:
                    self._ckpt.setdefault(k, v)

    def note_compile(self, **fields: Any) -> None:
        """Merge compile-phase attribution for the current trial.
        ``*_ms`` fields ACCUMULATE (a trial may compile several batch
        shapes, before or after its first metric); others are
        first-write-wins."""
        with self._lock:
            for k, v in fields.items():
                if k.endswith("_ms"):
                    self._compile[k] = self._compile.get(k, 0.0) + float(v)
                else:
                    self._compile.setdefault(k, v)

    def note_counter(self, key: str, n: int = 1) -> None:
        """Bump a cumulative runner counter (warm_hits/warm_misses/
        xla_cache_hits/xla_cache_misses)."""
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def on_broadcast(self, step: Optional[int] = None) -> None:
        """One reporter.broadcast from the training loop. Pure arithmetic —
        this rides the user's step cadence."""
        now = time.monotonic()
        with self._lock:
            self._steps += 1
            if self._ttfm_ms is None and self._trial_t0 is not None:
                self._ttfm_ms = (now - self._trial_t0) * 1e3
                # First metric: snapshot the phase time attributed so far
                # — the residual (ttfm minus this) is the first steps'
                # actual execution (+ input staging). The record itself
                # ships at trial end so later compiles still accumulate.
                self._ttfm_accounted = sum(
                    self._compile.get(k) or 0.0
                    for k in ("init_ms", "trace_ms", "compile_ms"))
            if self._last_broadcast is not None:
                gap_ms = (now - self._last_broadcast) * 1e3
                self._cadence_ms = gap_ms if self._cadence_ms is None else \
                    (1 - _EWMA_ALPHA) * self._cadence_ms + _EWMA_ALPHA * gap_ms
            self._last_broadcast = now

    def observe_hb_rtt(self, rtt_ms: float) -> None:
        with self._lock:
            self._hb_rtt_ms = rtt_ms if self._hb_rtt_ms is None else \
                (1 - _EWMA_ALPHA) * self._hb_rtt_ms + _EWMA_ALPHA * rtt_ms

    def note_profile_skipped(self, trial_id: Optional[str]) -> None:
        """The profiler lock was contended: this trial runs untraced.
        Shipped to the driver so the missing TensorBoard trace is
        explainable from the journal."""
        if trial_id:
            with self._lock:
                self._profile_skipped.append(trial_id)

    # ------------------------------------------------------------ shipping

    def _maybe_sample_memory(self) -> None:
        """Rate-limited memory probes, performed OUTSIDE the lock: the
        /proc read and the device probe can block, and broadcast()
        on the training hot path takes the same lock — the probe must
        never inject stalls into the cadence it measures."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_mem_sample < self.mem_interval_s:
                return
            self._last_mem_sample = now
        rss = _rss_mb()
        dev = _device_mem_mb()
        with self._lock:
            if rss is not None:
                self._rss_mb = round(rss, 1)
            if dev is not None:
                self._dev_mem_mb = dev

    def snapshot(self) -> Dict[str, Any]:
        """Full current stat dict (rounded). ``trial`` and ``ttfm_ms`` are
        kept even when None — they legitimately TRANSITION to None at a
        trial boundary, and the delta encoding must be able to ship that
        transition (or the driver's merged state would claim a finished
        trial forever). The remaining fields only ever go None -> value,
        so their Nones are omitted as start-up noise."""
        self._maybe_sample_memory()
        with self._lock:
            snap: Dict[str, Any] = {
                "trial": self._trial_id,
                "steps": self._steps,
                "trials_done": self._trials_done,
                "ttfm_ms": None if self._ttfm_ms is None
                else round(self._ttfm_ms, 1),
                "cadence_ms": None if self._cadence_ms is None
                else round(self._cadence_ms, 1),
                "hb_rtt_ms": None if self._hb_rtt_ms is None
                else round(self._hb_rtt_ms, 2),
                "rss_mb": self._rss_mb,
                "dev_mem_mb": self._dev_mem_mb,
            }
            snap.update(self._counters)
        return {k: v for k, v in snap.items()
                if v is not None or k in ("trial", "ttfm_ms")}

    def snapshot_delta(self) -> Dict[str, Any]:
        """Fields changed since the last ship, plus any pending
        profile_skipped trial ids and finished compile records (both
        drained, ship-once). Empty dict = nothing to ship (the caller
        omits the ``rstats`` payload field entirely)."""
        current = self.snapshot()
        with self._lock:
            delta = {k: v for k, v in current.items()
                     if self._last_shipped.get(k, _NEVER_SHIPPED) != v}
            self._last_shipped.update(delta)
            if self._profile_skipped:
                delta["profile_skipped"] = self._profile_skipped
                self._profile_skipped = []
            if self._compile_events:
                delta["compile_events"] = self._compile_events
                self._compile_events = []
            if self._ckpt_events:
                delta["ckpt_events"] = self._ckpt_events
                self._ckpt_events = []
        return delta

    def requeue_delta(self, delta: Dict[str, Any]) -> None:
        """A ship failed (heartbeat ConnectionError): put the delta back so
        the next beat re-sends it instead of silently losing the fields."""
        if not delta:
            return
        with self._lock:
            skipped = delta.get("profile_skipped") or []
            self._profile_skipped = list(skipped) + self._profile_skipped
            events = delta.get("compile_events") or []
            self._compile_events = list(events) + self._compile_events
            ckpts = delta.get("ckpt_events") or []
            self._ckpt_events = list(ckpts) + self._ckpt_events
            for k, v in delta.items():
                if k not in ("profile_skipped", "compile_events",
                             "ckpt_events") \
                        and self._last_shipped.get(k) == v:
                    del self._last_shipped[k]
