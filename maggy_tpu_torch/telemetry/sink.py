"""Fleet-wide telemetry fan-in: the journal sink service and its shipper.

The port's copy of ``maggy_tpu/telemetry/sink.py``, with the same wire
verb, event ids, file layout and readers, so either package reads the
other's ``<home>/journal/``:

- **Client side**: ``SinkJournal`` stands in for ``TelemetryJournal`` in
  the ``Telemetry`` facade. ``record()`` stamps every event with a
  per-source monotonic ``sid`` (the id the exactly-once contract keys on)
  and buffers it; one process-wide ``SinkShipper`` thread a binding ships
  the unacked suffix of every attached journal as ``JSINK`` frames over the
  fleet's shared socket.
- **Fleet side**: ``JournalSink`` demuxes each batch into
  ``<home>/journal/<source>.jsonl`` (one shared flusher for all sources),
  drops re-shipped events by ``sid``, journals a ``jsink`` ingest record a
  batch into the fleet journal, and keeps each source's shipped counters
  for the fleet's ``/metrics``.
- **Degradation**: a dead or shedding sink makes the shipper journal
  ``sink_degraded``, persist the suffix to the source's local journal file
  and keep retrying; the first ship that lands journals ``sink_recovered``
  and re-ships the unacked suffix. The sink's dedup and the readers' merge
  (``merge_source_events``) give each event id exactly once across the
  seam (``check_exactly_once``; chaos invariant 12, ``python -m
  maggy_tpu_torch.chaos --sink``).
- **Clock alignment**: ``ClockOffsetEstimator`` turns an agent's AJOIN and
  ALEASE exchanges into an RTT-bounded clock offset (Cristian's algorithm
  with a min-RTT filter); the fleet journals it per agent as
  ``clock_offset``, and ``telemetry trace --unified`` aligns the agents'
  journals with it.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from maggy_tpu_torch.telemetry.journal import (JournalEvents, TelemetryJournal,
                                         read_events)

#: Directory (under the fleet home) the sink demuxes per-source journals
#: into — the fleet's unified journal dir.
SINK_DIR_NAME = "journal"

#: Default shipper flush cadence. Short: the sink is on the same
#: control-plane network as the heartbeats, and small batches keep the
#: ingest lag (and the loss window on a hard kill) bounded.
SHIP_INTERVAL_S = 0.25

#: Events per JSINK frame. Batches beyond this split across frames —
#: well under MAX_FRAME even for log-heavy events.
SHIP_BATCH_EVENTS = 400

#: Cadence at which a shipper re-sends the per-source metric counter
#: snapshot for fleet-side federation (every batch would be wasteful for
#: an idle source).
COUNTER_SHIP_INTERVAL_S = 2.0

#: A clock-offset estimate older than this is re-anchored even if its
#: RTT is worse than the best seen — clocks drift, and a minutes-old
#: tight bound is a lie.
OFFSET_MAX_AGE_S = 60.0

#: How often an agent reports its current offset estimate to the fleet
#: (piggybacked on its ALEASE poll; also reported immediately whenever
#: the estimate improves).
OFFSET_REPORT_INTERVAL_S = 5.0


def sanitize_source(source: str) -> str:
    """Filename-safe source id (one journal file per source)."""
    return "".join(ch if ch.isalnum() or ch in "-_." else "_"
                   for ch in str(source)) or "unknown"


# ------------------------------------------------------------ clock offset


class ClockOffsetEstimator:
    """RTT-based clock-offset estimate between this process and a server
    (Cristian's algorithm): for one request/reply exchange timed locally
    as ``t_send``/``t_recv`` around a reply carrying the server's
    ``server_t``, the server clock read maps to local time
    ``(t_send + t_recv) / 2`` with error at most ``rtt / 2`` — so
    ``offset_s = (t_send + t_recv) / 2 - server_t`` is the local clock's
    lead over the server's, bounded by ``bound_s = rtt / 2``.

    A min-RTT filter makes re-estimation converge monotonically: a new
    sample replaces the estimate only when its RTT (and therefore its
    error bound) is no worse than the current one, unless the estimate
    aged past ``max_age_s`` (clock drift makes an old tight bound
    worthless, so staleness re-anchors unconditionally). Not
    thread-safe: one estimator per polling loop.
    """

    def __init__(self, max_age_s: float = OFFSET_MAX_AGE_S):
        self.max_age_s = float(max_age_s)
        self.offset_s: Optional[float] = None
        self.rtt_s: Optional[float] = None
        self.bound_s: Optional[float] = None
        self.samples = 0
        self._estimate_t: Optional[float] = None

    def sample(self, t_send: float, server_t: Optional[float],
               t_recv: float) -> bool:
        """Feed one exchange; returns True when the estimate updated.
        All timestamps are caller-supplied (testable with fake clocks):
        ``t_send``/``t_recv`` on the LOCAL clock, ``server_t`` on the
        server's."""
        if server_t is None:
            return False
        rtt = t_recv - t_send
        if rtt < 0:
            return False
        self.samples += 1
        stale = (self._estimate_t is not None
                 and t_recv - self._estimate_t > self.max_age_s)
        if self.bound_s is not None and rtt / 2.0 > self.bound_s \
                and not stale:
            return False
        self.offset_s = (t_send + t_recv) / 2.0 - float(server_t)
        self.rtt_s = rtt
        self.bound_s = rtt / 2.0
        self._estimate_t = t_recv
        return True


# ----------------------------------------------------------- wire client


class SinkBinding:
    """Where a shipper dials: the fleet's shared listener address plus
    the sink tenant's secret (distinct from every experiment's and from
    the fleet-agent secret — a journal shipper cannot lease agents)."""

    def __init__(self, addr: Tuple[str, int], secret: str):
        self.addr = (str(addr[0]), int(addr[1]))
        self.secret = secret

    def key(self) -> Tuple[Tuple[str, int], str]:
        return (self.addr, self.secret)


class _SinkChannel:
    """One persistent authenticated connection to the sink tenant, with
    a single reconnect retry per call (the shipper's own cycle provides
    the outer retry loop)."""

    def __init__(self, addr: Tuple[str, int], secret: str,
                 timeout: float = 5.0):
        self.addr = tuple(addr)
        self.secret = secret.encode() if isinstance(secret, str) else secret
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None

    def call(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        from maggy_tpu_torch.core.rpc import MessageSocket

        for attempt in (0, 1):
            try:
                if self._sock is None:
                    sock = socket.create_connection(self.addr,
                                                    timeout=self.timeout)
                    sock.settimeout(self.timeout)
                    self._sock = sock
                MessageSocket.send_msg(self._sock, msg, self.secret)
                return MessageSocket.recv_msg(self._sock, self.secret)
            except (ConnectionError, socket.timeout, OSError):
                self.close()
                if attempt:
                    raise
        raise ConnectionError("unreachable")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


# --------------------------------------------------------- client journal


class SinkJournal:
    """Drop-in journal for the ``Telemetry`` facade that ships its
    events to the fleet's journal sink instead of running a private
    flusher thread. ``record()`` stamps each event with a monotonic
    ``sid`` (the exactly-once event id) and buffers it; the process-wide
    ``SinkShipper`` this journal attaches to drains the unshipped suffix
    on its cadence.

    Degradation contract: when shipping fails (sink dead, sink tenant
    backpressured and shedding frames), the journal records ONE
    ``sink_degraded`` event, persists everything not yet locally durable
    to its ordinary local journal file (``local_path`` — the same
    ``telemetry.jsonl`` a sink-less run would write), and keeps
    retrying; the first successful ship records ``sink_recovered`` and
    re-ships the whole unacked suffix. The sink dedupes by ``sid``, and
    readers merging sink segments with a surviving local journal dedupe
    the same way (``merge_source_events``) — each event id lands exactly
    once in the unified view no matter where the seam fell.
    """

    def __init__(self, env, local_path: str, binding: SinkBinding,
                 source: str,
                 metrics_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 shipper: Optional["SinkShipper"] = None):
        self.env = env
        self.local_path = local_path
        self.source = sanitize_source(source)
        self.metrics_fn = metrics_fn
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._sid = 0  # guarded-by: _lock
        #: Leading events acked by the sink (durable fleet-side).
        self._acked = 0  # guarded-by: _lock
        #: Leading events persisted to the local fallback file.
        self._local_flushed = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._closing = False  # guarded-by: _lock
        self.degraded = False  # unguarded-ok: diagnostic flag written only by the shipper thread's ship_cycle, read by monitors/tests
        self.torn_lines = 0
        self._local_append_ok: Optional[bool] = None  # shipper-thread only
        self._last_counter_ship = 0.0  # shipper-thread only
        if shipper is not None:
            self.shipper = shipper
            shipper.attach(self)
        else:
            # Lookup + attach are ONE atomic step under the registry
            # lock: attaching after get_shipper returned would race a
            # concurrent last-detach stopping the same shipper.
            self.shipper = get_shipper(binding, journal=self)

    # ------------------------------------------------------------- hot path

    def record(self, event: Dict[str, Any]) -> None:
        """Buffer one event, stamped with its per-source event id."""
        with self._lock:
            if self._closed:
                return
            self._sid += 1
            event["sid"] = self._sid
            self._events.append(event)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def max_sid(self) -> int:
        with self._lock:
            return self._sid

    # ------------------------------------------------------------- shipping

    def ship_cycle(self, channel: "_SinkChannel",
                   counters: Optional[Dict[str, Any]] = None) -> None:
        """One shipper pass: ship the unacked suffix in bounded batches;
        on failure enter (or stay in) degraded mode and persist the
        not-yet-local suffix to the local journal file. Serialized by
        the shipper's ship lock; ``counters`` is pre-computed by the
        caller OUTSIDE that lock (a metrics snapshot takes the registry
        locks, which the canonical lock order puts before the
        shipper's)."""
        import json

        while True:
            with self._lock:
                start = self._acked
                batch = list(self._events[start:start + SHIP_BATCH_EVENTS])
            # An empty batch still ships while degraded: the probe is
            # what detects recovery for a source that went quiet.
            if not batch and counters is None and not self.degraded:
                return
            try:
                # Wire-safe copy: journal events may hold values only the
                # file writer's default=str serializer accepts.
                wire = json.loads(json.dumps(batch, default=str))
                # client_t: this source's wall clock at ship time — the
                # sink derives a SKEW-FREE ingest lag from it (event age
                # measured entirely on the client clock), so remote
                # agents with offset clocks don't poison the lag stats.
                resp = channel.call({"type": "JSINK",
                                     "source": self.source,
                                     "events": wire,
                                     "counters": counters,
                                     "client_t": time.time()})
                if resp.get("type") == "ERR":
                    raise ConnectionError(resp.get("error"))
            except (ConnectionError, socket.timeout, OSError, ValueError,
                    TypeError):
                self._enter_degraded()
                return
            with self._lock:
                # Advance by POSITION, not by the acked sid: after a
                # resume restore the local buffer may start mid-sid-run,
                # and a sid-based cursor could overshoot past events
                # never shipped. The sink acked at least our batch's top
                # sid (its dedup absorbs overlap), so the whole shipped
                # prefix is durable fleet-side.
                self._acked = max(self._acked, start + len(batch))
            counters = None  # shipped at most once per cycle
            if self.degraded:
                self.degraded = False
                self.record({"t": time.time(), "ev": "sink_recovered",
                             "source": self.source})
            if len(batch) < SHIP_BATCH_EVENTS:
                return

    def counters_payload(self) -> Optional[Dict[str, Any]]:
        now = time.monotonic()
        if self.metrics_fn is None \
                or now - self._last_counter_ship < COUNTER_SHIP_INTERVAL_S:
            return None
        self._last_counter_ship = now
        try:
            snap = self.metrics_fn() or {}
        except Exception:  # noqa: BLE001 - metrics must never break shipping
            return None
        return {"counters": snap.get("counters") or {},
                "gauges": snap.get("gauges") or {}}

    def _enter_degraded(self) -> None:
        if not self.degraded:
            self.degraded = True
            self.record({"t": time.time(), "ev": "sink_degraded",
                         "source": self.source})
        self._flush_local()

    def _flush_local(self) -> None:
        """Persist events[_local_flushed:] to the local journal file —
        the degraded-mode durability path. First write is a full atomic
        rewrite (truncates any stale file), later writes append.
        Shipper-thread only (plus the final close())."""
        with self._lock:
            start = self._local_flushed
            total = len(self._events)
            snapshot = list(self._events[start:total])
        if not snapshot:
            return
        import json

        payload = "".join(json.dumps(e, default=str) + "\n"
                          for e in snapshot)
        try:
            if start == 0 or self._local_append_ok is False:
                with self._lock:
                    full = list(self._events[:total])
                payload = "".join(json.dumps(e, default=str) + "\n"
                                  for e in full)
                self.env.dump(payload, self.local_path)
            else:
                try:
                    with self.env.open_file(self.local_path, "a") as f:
                        f.write(payload)
                    self._local_append_ok = True
                except Exception:  # noqa: BLE001 - backend without append
                    self._local_append_ok = False
                    with self._lock:
                        full = list(self._events[:total])
                    payload = "".join(json.dumps(e, default=str) + "\n"
                                      for e in full)
                    self.env.dump(payload, self.local_path)
            with self._lock:
                self._local_flushed = max(self._local_flushed, total)
        except Exception:  # noqa: BLE001 - telemetry must never fail a run
            pass

    # ------------------------------------------------------------ lifecycle

    def load_existing(self) -> int:
        """Resume support: a sink-routed journal's history lives fleet-
        side; only a local fallback file (a previous degraded window) is
        restorable here. Restored events keep their original sids and
        are NOT re-shipped (the sink may already hold them)."""
        try:
            existing = read_events(self.local_path, env=self.env)
        except Exception:  # noqa: BLE001 - no local file = nothing to restore
            return 0
        with self._lock:
            self.torn_lines += getattr(existing, "torn_lines", 0)
            self._events = list(existing) + self._events
            restored = len(existing)
            self._acked += restored
            self._local_flushed += restored
            self._sid = max(self._sid,
                            max((e.get("sid") or 0 for e in existing),
                                default=0))
        return restored

    def flush(self) -> None:
        """Synchronous best-effort drain (finalize paths): ask the
        shipper for an immediate cycle on the caller's thread."""
        self.shipper.flush_now(self)

    def close(self) -> None:
        with self._lock:
            if self._closed or self._closing:
                return
            self._closing = True
        # Drain while still OPEN: if this final ship is the one that
        # recovers a degraded journal, its sink_recovered event must be
        # recordable — closing first would silently drop it (and leave
        # the source flagged DEGRADED in the sink forever).
        self.shipper.flush_now(self)
        with self._lock:
            self._closed = True
        # Second pass ships anything the first one recorded (e.g. the
        # recovery event); then make any tail the sink never took
        # locally durable.
        self.shipper.flush_now(self)
        with self._lock:
            unshipped = self._acked < len(self._events)
        if unshipped:
            self._flush_local()
        self.shipper.detach(self)


class SinkShipper:
    """Process-wide batching shipper: ONE daemon thread drains every
    attached ``SinkJournal`` toward one sink binding — 500 churn tenants
    share one thread and one socket, which is the whole point. Keyed by
    binding in a module registry (``get_shipper``); the thread and the
    connection close when the last journal detaches."""

    def __init__(self, binding: SinkBinding,
                 interval_s: float = SHIP_INTERVAL_S):
        self.binding = binding
        self.interval_s = float(interval_s)
        self._channel = _SinkChannel(binding.addr, binding.secret)
        self._lock = threading.Lock()
        self._journals: List[SinkJournal] = []  # guarded-by: _lock
        # Serializes ship cycles: the flusher thread and a flush_now
        # caller must not interleave batches of one journal.
        self._ship_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="telemetry-sink-ship")
        self._thread.start()

    def attach(self, journal: SinkJournal) -> None:
        with self._lock:
            if journal not in self._journals:
                self._journals.append(journal)

    def detach(self, journal: SinkJournal) -> None:
        """Drop one journal; the LAST detach also retires the shipper
        from the registry and stops it. Registry membership and the
        empty-check are decided under the module registry lock so a
        concurrent ``get_shipper`` can never attach to a shipper that
        is already being stopped."""
        stop = False
        with _SHIPPER_LOCK:
            with self._lock:
                self._journals = [j for j in self._journals
                                  if j is not journal]
                remaining = len(self._journals)
            if remaining == 0:
                if _SHIPPERS.get(self.binding.key()) is self:
                    del _SHIPPERS[self.binding.key()]
                stop = True
        if stop:
            self.stop()

    def flush_now(self, journal: Optional[SinkJournal] = None) -> None:
        targets = [journal] if journal is not None else None
        if targets is None:
            with self._lock:
                targets = list(self._journals)
        self._ship_all(targets)

    def _ship_all(self, journals: List[SinkJournal]) -> None:
        for j in journals:
            try:
                # Metrics snapshot BEFORE the ship lock: the registry
                # locks sit earlier in the canonical acquisition order.
                counters = j.counters_payload()
                with self._ship_lock:
                    j.ship_cycle(self._channel, counters=counters)
            except Exception:  # noqa: BLE001 - one journal must not kill the shipper
                pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            with self._lock:
                journals = list(self._journals)
            self._ship_all(journals)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self._channel.close()


_SHIPPER_LOCK = threading.Lock()
_SHIPPERS: Dict[Tuple[Tuple[str, int], str], SinkShipper] = {}


def get_shipper(binding: SinkBinding,
                journal: Optional[SinkJournal] = None) -> SinkShipper:
    """The process-wide shipper for ``binding`` (started on first use).
    Pass ``journal`` to attach it atomically with the lookup — the only
    race-free way to join a refcounted shipper (a bare lookup could
    return a shipper whose last journal is concurrently detaching,
    which stops it)."""
    with _SHIPPER_LOCK:
        shipper = _SHIPPERS.get(binding.key())
        if shipper is None:
            shipper = SinkShipper(binding)
            _SHIPPERS[binding.key()] = shipper
        if journal is not None:
            shipper.attach(journal)
        return shipper


# ------------------------------------------------------------- fleet side


class JournalSink:
    """The fleet-side journal sink service: demux JSINK batches into
    per-source journal files under ``journal_dir`` (size-based rotation, one
    shared flusher thread for ALL sources), dedupe re-shipped events by
    ``sid``, journal a ``jsink`` ingest record per batch into the fleet
    journal (offline-replayable ingest lag), and hold each source's last
    shipped counter snapshot for /metrics federation."""

    def __init__(self, env, journal_dir: str, telemetry=None,
                 max_mb: Optional[float] = None,
                 flush_interval_s: float = 0.5):
        self.env = env
        self.journal_dir = journal_dir.rstrip("/")
        self.telemetry = telemetry
        self.max_mb = max_mb
        self._lock = threading.Lock()
        self._writers: Dict[str, TelemetryJournal] = {}  # guarded-by: _lock
        self._last_sid: Dict[str, int] = {}  # guarded-by: _lock
        self._stats: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._federated: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._stopped = False  # guarded-by: _lock
        try:
            env.mkdir(self.journal_dir)
        except Exception:  # noqa: BLE001 - writers mkdir through env.dump anyway
            pass
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._flusher, daemon=True,
                                        name="telemetry-sink-flush")
        self._thread.start()

    # -------------------------------------------------------------- ingest

    def ingest(self, source, events, counters=None,
               client_t=None) -> Dict[str, Any]:
        """One JSINK batch. Returns the ack carrying the highest ``sid``
        this sink now holds for the source; the sink's sid dedup absorbs
        re-shipped (lost-ack) batches without duplication. ``client_t``
        is the source's wall clock at ship time: event age is measured
        against it — entirely on the CLIENT clock — so a remote agent's
        clock skew never poisons the lag stats."""
        if not isinstance(source, str) or not source:
            return {"type": "ERR", "error": "JSINK without a source id"}
        source = sanitize_source(source)
        now = time.time()
        events = events if isinstance(events, list) else []
        with self._lock:
            if self._stopped:
                return {"type": "ERR", "error": "journal sink is stopped"}
            writer = self._writers.get(source)
            if writer is None:
                writer = TelemetryJournal(
                    self.env,
                    "{}/{}.jsonl".format(self.journal_dir, source),
                    max_mb=self.max_mb, start_flusher=False)
                self._writers[source] = writer
            last = self._last_sid.get(source, 0)
            stats = self._stats.setdefault(source, {
                "ingested": 0, "dup": 0, "batches": 0, "degraded": False,
                "last_lag_s": None, "last_ingest_t": None})
        fresh: List[Dict[str, Any]] = []
        top = last
        for ev in events:
            if not isinstance(ev, dict):
                continue
            sid = ev.get("sid")
            if isinstance(sid, int):
                if sid <= last:
                    continue
                top = max(top, sid)
            fresh.append(ev)
        for ev in fresh:
            writer.record(ev)
        dup = len(events) - len(fresh)
        lag_ms = None
        event_ts = [ev["t"] for ev in fresh
                    if isinstance(ev.get("t"), (int, float))]
        if event_ts:
            # Skew-free when the shipper stamped its clock: the newest
            # event's age AT SHIP TIME, both ends on the source clock.
            # Fallback (no stamp) compares across clocks — fine for the
            # in-process case, wrong by the skew for remote agents.
            ref = float(client_t) if isinstance(client_t, (int, float)) \
                else now
            lag_ms = max(0.0, (ref - max(event_ts)) * 1e3)
        degraded = None
        for ev in fresh:
            if ev.get("ev") == "sink_degraded":
                degraded = True
            elif ev.get("ev") == "sink_recovered":
                degraded = False
        with self._lock:
            self._last_sid[source] = top
            stats["batches"] += 1
            stats["ingested"] += len(fresh)
            stats["dup"] += dup
            stats["last_ingest_t"] = now
            if lag_ms is not None:
                stats["last_lag_s"] = lag_ms / 1e3
            if degraded is not None:
                stats["degraded"] = degraded
            if isinstance(counters, dict):
                self._federated[source] = {
                    "counters": dict(counters.get("counters") or {}),
                    "gauges": dict(counters.get("gauges") or {})}
        telem = self.telemetry
        if telem is not None:
            telem.metrics.counter("sink.batches").inc()
            telem.metrics.counter("sink.events").inc(len(fresh))
            if dup:
                telem.metrics.counter("sink.dup_drops").inc(dup)
            if lag_ms is not None:
                telem.metrics.histogram("sink.ingest_lag_ms").observe(
                    lag_ms)
            if events:
                # Journaled per non-empty batch — INCLUDING batches the
                # sid dedup fully absorbed (n=0, dup>0): the re-ship
                # window's dedup activity must be replayable, or offline
                # dup counts stay blind to the seam. Empty keepalive
                # probes alone skip.
                telem.event("jsink", source=source, n=len(fresh),
                            dup=dup, sid=top,
                            lag_ms=round(lag_ms, 3)
                            if lag_ms is not None else None)
        return {"type": "OK", "acked": top}

    # ------------------------------------------------------------ querying

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-source lag view for status.json / ``monitor --fleet``:
        backlog (events buffered fleet-side but not yet flushed to the
        segment files), last-event age, last-ingest age, degraded flag
        (as reported by the source's own journal across the seam)."""
        now = time.time()
        with self._lock:
            out: Dict[str, Dict[str, Any]] = {}
            for source, stats in self._stats.items():
                writer = self._writers.get(source)
                backlog = 0
                if writer is not None:
                    with writer._lock:
                        backlog = len(writer._events) - writer._flushed
                ingest_age = (now - stats["last_ingest_t"]) \
                    if stats["last_ingest_t"] else None
                # Event age = time since last ingest (fleet clock) plus
                # how old the newest event already was AT ingest
                # (client clock) — no cross-clock subtraction, so a
                # skewed remote agent reads true lag, not its offset.
                event_age = None
                if ingest_age is not None:
                    event_age = ingest_age + (stats["last_lag_s"] or 0.0)
                out[source] = {
                    "ingested": stats["ingested"],
                    "batches": stats["batches"],
                    "dup": stats["dup"],
                    "backlog": backlog,
                    "last_sid": self._last_sid.get(source, 0),
                    "degraded": stats["degraded"],
                    "last_event_age_s": round(event_age, 2)
                    if event_age is not None else None,
                    "last_ingest_age_s": round(ingest_age, 2)
                    if ingest_age is not None else None,
                }
            return out

    def federated_snapshots(self) -> List[Tuple[Dict[str, str],
                                                Dict[str, Any]]]:
        """``[(labels, registry-snapshot), ...]`` per source, in the
        shape ``obs.render_prometheus`` consumes — plugged into the
        fleet's obs registration so one scrape of the fleet host exposes
        every agent's and tenant's shipped counters."""
        with self._lock:
            return [({"experiment": source, "via": "jsink"},
                     {"counters": dict(snap.get("counters") or {}),
                      "gauges": dict(snap.get("gauges") or {}),
                      "histograms": {}})
                    for source, snap in sorted(self._federated.items())]

    def source_path(self, source: str) -> str:
        return "{}/{}.jsonl".format(self.journal_dir,
                                    sanitize_source(source))

    # ----------------------------------------------------------- lifecycle

    def _flusher(self) -> None:
        while not self._stop.wait(0.5):
            with self._lock:
                writers = list(self._writers.values())
            for writer in writers:
                writer.flush()

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            writers = list(self._writers.values())
        self._stop.set()
        self._thread.join(timeout=5)
        for writer in writers:
            writer.close()


# ----------------------------------------------------------- offline read


def sink_sources(journal_dir: str) -> Dict[str, str]:
    """Discover the per-source journals in a sink dir: ``{source:
    path}``. Rotation segments (``<name>.jsonl.000001``) belong to their
    base file and are not separate sources."""
    out: Dict[str, str] = {}
    if not os.path.isdir(journal_dir):
        return out
    for name in sorted(os.listdir(journal_dir)):
        if name.endswith(".jsonl"):
            out[name[:-len(".jsonl")]] = os.path.join(journal_dir, name)
    return out


def read_sink_dir(journal_dir: str) -> Dict[str, JournalEvents]:
    """Read every source's (possibly rotated) journal in a sink dir.
    Torn lines — including a torn tail in a segment the sink is still
    appending — are counted per source, never raised."""
    out: Dict[str, JournalEvents] = {}
    for source, path in sink_sources(journal_dir).items():
        try:
            out[source] = read_events(path)
        except Exception:  # noqa: BLE001 - a half-written source must not block the rest
            empty = JournalEvents()
            empty.torn_lines = 0
            out[source] = empty
    return out


def merge_source_events(*streams: Optional[List[Dict[str, Any]]]
                        ) -> JournalEvents:
    """Merge one source's event streams (sink segments, surviving local
    journal) into a single exactly-once stream: events deduped by their
    ``sid`` event id (first stream wins), events without a sid kept
    verbatim, result ordered by timestamp. ``torn_lines`` sums across
    the inputs."""
    merged = JournalEvents()
    torn = 0
    seen: set = set()
    for stream in streams:
        if not stream:
            continue
        torn += getattr(stream, "torn_lines", 0)
        for ev in stream:
            sid = ev.get("sid") if isinstance(ev, dict) else None
            if isinstance(sid, int):
                if sid in seen:
                    continue
                seen.add(sid)
            merged.append(ev)
    merged.sort(key=lambda e: (e.get("t") or 0.0, e.get("sid") or 0))
    merged.torn_lines = torn
    return merged


def check_exactly_once(merged: List[Dict[str, Any]],
                       expected_max_sid: Optional[int] = None
                       ) -> List[str]:
    """Invariant-12 core: over one source's MERGED stream, every event
    id 1..max must appear exactly once — no gap (a lost event the
    re-ship should have recovered) and no duplicate (a dedup failure
    across the fallback seam). ``expected_max_sid`` additionally pins
    the tail: the source is known to have emitted that many events."""
    violations: List[str] = []
    sids = [ev.get("sid") for ev in merged
            if isinstance(ev, dict) and isinstance(ev.get("sid"), int)]
    counts: Dict[int, int] = {}
    for sid in sids:
        counts[sid] = counts.get(sid, 0) + 1
    dups = sorted(s for s, c in counts.items() if c > 1)
    if dups:
        violations.append(
            "duplicate event id(s) across the fallback seam: "
            "{}".format(dups[:10]))
    top = expected_max_sid if expected_max_sid is not None \
        else (max(counts) if counts else 0)
    missing = sorted(s for s in range(1, top + 1) if s not in counts)
    if missing:
        violations.append(
            "lost event id(s) — never re-shipped and absent from the "
            "local journal: {} of {} (sample {})".format(
                len(missing), top, missing[:10]))
    return violations


__all__ = [
    "SINK_DIR_NAME", "ClockOffsetEstimator", "SinkBinding", "SinkJournal",
    "SinkShipper", "JournalSink", "get_shipper",
    "sink_sources", "read_sink_dir", "merge_source_events",
    "check_exactly_once", "sanitize_source",
    "OFFSET_REPORT_INTERVAL_S",
]
