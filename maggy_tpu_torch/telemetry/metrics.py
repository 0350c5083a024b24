"""Low-overhead in-process metrics: counters, gauges, latency histograms.

No dependencies, thread-safe, snapshot-able to plain dicts (msgpack/json
friendly — the TELEM RPC verb ships snapshots verbatim). Modeled on the
measurement discipline Podracer-style systems apply to actor/learner
hand-off utilization (arxiv 2104.06272): the scheduler's perf claims must
be queryable counters, not ad-hoc timers.

Histograms use FIXED bucket bounds chosen at creation (cumulative counts
per bound, like Prometheus): observation is O(#buckets) worst case with no
allocation, and two snapshots subtract cleanly. Percentiles read from the
bucket CDF are upper-bound estimates — good enough to steer by, cheap
enough for the RPC hot path.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

# Default bounds for latency histograms, in milliseconds. Spans the sub-ms
# RPC handler times up to the multi-second compile stalls the control plane
# must notice.
DEFAULT_LATENCY_BOUNDS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-written value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bound histogram with cumulative bucket counts.

    ``bounds`` are the inclusive upper edges of the finite buckets; one
    implicit +inf bucket catches the rest.
    """

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count", "_min", "_max")

    def __init__(self, bounds: Sequence[float] = DEFAULT_LATENCY_BOUNDS_MS):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError("Histogram bounds must be non-empty and sorted.")
        self._lock = threading.Lock()
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # last = +inf
        self._sum = 0.0
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        idx = len(self.bounds)
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value

    def percentile(self, q: float) -> Optional[float]:
        """Upper-bound estimate of the q-quantile (0 < q <= 1) from the
        bucket CDF; the observed max for the +inf bucket."""
        with self._lock:
            if self._count == 0:
                return None
            return self._percentile_from(self._counts, self._count,
                                         self._max, q)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            lo, hi = self._min, self._max
        snap: Dict[str, object] = {
            "count": total,
            "sum": round(s, 3),
            "min": None if lo is None else round(lo, 3),
            "max": None if hi is None else round(hi, 3),
            "buckets": {str(b): c for b, c in zip(self.bounds, counts)},
            "overflow": counts[-1],
        }
        if total:
            snap["p50"] = self._percentile_from(counts, total, hi, 0.5)
            snap["p95"] = self._percentile_from(counts, total, hi, 0.95)
        return snap

    def _percentile_from(self, counts: List[int], total: int,
                         observed_max: Optional[float], q: float):
        target = q * total
        cum = 0
        for i, bound in enumerate(self.bounds):
            cum += counts[i]
            if cum >= target:
                return bound
        return observed_max


class MetricsRegistry:
    """Named metric store: get-or-create accessors, one flat namespace.

    Creation takes the registry lock; recording takes only the metric's own
    lock — the message hot path never contends on the registry once its
    metrics exist.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}  # guarded-by: _lock
        self._gauges: Dict[str, Gauge] = {}  # guarded-by: _lock
        self._histograms: Dict[str, Histogram] = {}  # guarded-by: _lock

    def counter(self, name: str) -> Counter:
        with self._lock:
            metric = self._counters.get(name)
            if metric is None:
                metric = self._counters[name] = Counter()
            return metric

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            metric = self._gauges.get(name)
            if metric is None:
                metric = self._gauges[name] = Gauge()
            return metric

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_LATENCY_BOUNDS_MS) -> Histogram:
        with self._lock:
            metric = self._histograms.get(name)
            if metric is None:
                metric = self._histograms[name] = Histogram(bounds)
            return metric

    def prune(self, predicate) -> int:
        """Drop every metric whose NAME satisfies ``predicate``. The
        registry grows one gauge per live runner field per partition
        (``runner.<field>.p<pid>``); without pruning, a reaped or
        replaced partition's gauges linger forever — skewing snapshots
        and polluting the /metrics exposition with dead series. Returns
        the number of metrics removed. Callers must not hold metric
        refs across a prune (get-or-create re-mints them)."""
        removed = 0
        with self._lock:
            for table in (self._counters, self._gauges, self._histograms):
                for name in [n for n in table if predicate(n)]:
                    del table[name]
                    removed += 1
        return removed

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Plain-dict snapshot of every metric (json/msgpack-serializable)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot() for k, h in sorted(histograms.items())},
        }
