"""JSONL telemetry journal, written through the environment abstraction.

``record()`` only appends to an in-memory buffer — NO I/O on the caller's
thread, so the RPC hot path (METRIC/FINAL handlers on the server event
loop) never blocks on a disk or GCS write. A daemon flusher thread
persists the journal every ``flush_interval_s``: the FIRST flush is a full
atomic rewrite via ``env.dump`` (truncating any stale file from an
unrelated earlier run at this path), subsequent flushes append only the
new events through ``env.open_file(path, "a")`` — O(new events), not
O(journal), per flush. Backends without append semantics (object stores)
fall back to the full rewrite automatically. A hard kill mid-append can
leave a torn tail LINE; readers skip it (``_parse_jsonl``), so the journal
stays old-or-new at event granularity. A crashed experiment therefore
retains its telemetry up to the last flush; a resumed one loads the prior
events and keeps appending, so the journal covers the whole logical
experiment.

Events are plain dicts with at least ``{"t": <unix s>, "ev": <kind>}``;
trial events add ``{"trial", "span", "phase"}`` (see spans.PHASES).

**Rotation** (``MAGGY_TPU_JOURNAL_MAX_MB``, or the ``max_mb`` argument;
off by default): a multi-day sweep's journal grows without bound, and a
single multi-GB JSONL file is exactly what an operator cannot tail or
copy mid-run. With a size cap set, a flush that leaves the ACTIVE file
over the cap seals it into a numbered segment
(``telemetry.jsonl.000001``, ``.000002``, ... — ascending = older) and
starts a fresh active file; ``read_events`` transparently reads the
segments in order followed by the active file, so replay, resume
(``load_existing``) and every journal consumer see one continuous
event stream regardless of how it is sharded on disk.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

FLUSHER_THREAD_NAME = "telemetry-flush"

#: Env var naming the active-file size cap in MB (float ok); unset/empty
#: or <= 0 disables rotation.
ROTATE_ENV = "MAGGY_TPU_JOURNAL_MAX_MB"

#: Env var arming fsync durability (``1``/``true``): the journal fsyncs
#: on segment SEAL and on ``barrier()`` (the terminal-event flush the
#: FINAL path runs before its RPC reply) — never on the periodic flusher
#: tick. Off by default: the flusher's cadence already bounds loss to
#: ~1 s of TAIL events, and crash-only recovery tolerates a torn tail
#: line by design (docs/telemetry.md, "torn-tail tolerance"). Chaos
#: ``kill_driver`` soaks turn it on so an acknowledged FINAL can never
#: be lost to the page cache.
FSYNC_ENV = "MAGGY_TPU_JOURNAL_FSYNC"


def _resolved_fsync(fsync) -> bool:
    if fsync is not None:
        return bool(fsync)
    return os.environ.get(FSYNC_ENV, "").strip().lower() in ("1", "true",
                                                             "on", "yes")


def _fsync_path(path: str) -> None:
    """Best-effort fsync of a local file (object-store backends have no
    fd to sync — their dump() durability is the PUT's)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _segment_path(path: str, index: int) -> str:
    return "{}.{:06d}".format(path, index)


def _resolved_max_bytes(max_mb: Optional[float]) -> Optional[int]:
    if max_mb is None:
        raw = os.environ.get(ROTATE_ENV, "").strip()
        if not raw:
            return None
        try:
            max_mb = float(raw)
        except ValueError:
            return None
    return int(max_mb * 1024 * 1024) if max_mb and max_mb > 0 else None


class TelemetryJournal:
    def __init__(self, env, path: str, flush_interval_s: float = 1.0,
                 max_mb: Optional[float] = None,
                 start_flusher: bool = True,
                 fsync: Optional[bool] = None):
        self.env = env
        self.path = path
        self.flush_interval_s = flush_interval_s
        #: Active-file rotation threshold in bytes; None = never rotate.
        self._max_bytes = _resolved_max_bytes(max_mb)
        #: Durability knob (MAGGY_TPU_JOURNAL_FSYNC / fsync=): fsync on
        #: segment seal and on barrier() only — the periodic flusher
        #: never pays it.
        self._fsync = _resolved_fsync(fsync)
        self._lock = threading.Lock()
        # Serializes whole flush cycles (read-suffix -> write -> advance
        # _flushed): a finalize-path flush() racing the flusher thread's
        # tick would otherwise both read the same unflushed suffix and
        # append it twice — duplicated events break replay's
        # same-journal-same-numbers contract.
        self._flush_lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []  # guarded-by: _lock
        # How many leading events are already on disk. 0 forces the first
        # flush to be a full rewrite (truncates a stale journal from an
        # unrelated earlier run at the same path); afterwards flushes
        # append only events[_flushed:].
        self._flushed = 0  # guarded-by: _lock
        # Leading events that live in SEALED rotation segments (always <=
        # _flushed): the full-rewrite flush path must rewrite only the
        # active file's share, events[_rotated:], or every rewrite would
        # resurrect the rotated prefix into the active file and replay
        # would see each rotated event twice.
        self._rotated = 0  # guarded-by: _lock
        # Sealed segment count / bytes currently in the active file.
        # Flush-cycle state, mutated only with _flush_lock held.
        self._segments = 0  # guarded-by: _flush_lock
        self._active_bytes = 0  # guarded-by: _flush_lock
        # None = untried, False = backend rejected append mode (object
        # stores): every flush falls back to the full atomic rewrite.
        self._append_ok: Optional[bool] = None  # guarded-by: _flush_lock
        self._dirty = False  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        #: Corrupt/torn lines skipped when loading a previous run's journal
        #: (load_existing). Exposed in the TELEM snapshot so journal
        #: corruption is visible instead of quietly shrinking the dataset.
        self.torn_lines = 0
        self._stop = threading.Event()
        # ``start_flusher=False`` skips the per-journal flusher thread:
        # the caller owns the flush cadence (the fleet journal sink runs
        # ONE flusher over its per-source writers — one thread for 500
        # sources, not 500 threads).
        self._thread: Optional[threading.Thread] = None
        if start_flusher:
            self._thread = threading.Thread(
                target=self._flusher, daemon=True, name=FLUSHER_THREAD_NAME)
            self._thread.start()

    # ------------------------------------------------------------- hot path

    def record(self, event: Dict[str, Any]) -> None:
        """Buffer one event. Never touches the filesystem."""
        with self._lock:
            if self._closed:
                return
            self._events.append(event)
            self._dirty = True

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # ----------------------------------------------------------- durability

    def load_existing(self) -> int:
        """Prepend events persisted by a previous (crashed/interrupted) run
        of this experiment — rotated segments first, then the active file —
        so resume keeps one continuous journal. Returns the number of
        restored events."""
        try:
            segments, active, n_segments, torn = _load_parts(
                self.path, env=self.env)
        except Exception:  # noqa: BLE001 - a torn journal must not block resume
            return 0
        if not segments and active is None:
            return 0
        active_events = active if active is not None else []
        with self._flush_lock:
            with self._lock:
                self.torn_lines += torn
                self._events = segments + active_events + self._events
                # The rotated prefix is sealed on disk — only the ACTIVE
                # file's events are ever rewritten. _flushed deliberately
                # stays 0: the next flush takes the full-rewrite path,
                # which re-persists the restored ACTIVE suffix AND
                # truncates any torn tail line the crashed writer left —
                # appending after a partial line would glue the first new
                # event onto it, corrupting both forever.
                self._rotated = len(segments)
                self._dirty = True
            self._segments = n_segments
        return len(segments) + len(active_events)

    def flush(self) -> None:
        """Persist now: append the unflushed suffix when the backend
        supports it, else a full atomic rewrite via env.dump. One flush
        cycle at a time (see _flush_lock)."""
        with self._flush_lock:
            self._flush_locked()

    def barrier(self) -> None:
        """Durability barrier for terminal events (crash-only recovery):
        flush the buffered suffix NOW — and fsync it when the durability
        knob is armed — so the journal, the recovery source of truth, can
        never trail an event the caller is about to acknowledge on the
        wire (the FINAL path runs this before its RPC reply is written).
        Without fsync the barrier still moves the events out of process
        memory into the page cache: a driver crash (the fault being
        defended against) cannot lose them; only a whole-host power loss
        can, which is what the fsync knob buys."""
        with self._flush_lock:
            self._flush_locked(fsync=self._fsync)

    # locked-by: _flush_lock
    def _flush_locked(self, fsync: bool = False) -> None:
        with self._lock:
            if not self._dirty:
                return
            start = self._flushed
            rotated = self._rotated
            new = self._events[start:]
            total = len(self._events)
            self._dirty = False
        if start > rotated and self._append_ok is not False:
            # Append only applies to a non-empty ACTIVE file: right after
            # a rotation the active file is fresh, and the rewrite path
            # below (O(active), not O(journal)) re-creates it cleanly.
            payload = "".join(json.dumps(e, default=str) + "\n" for e in new)
            try:
                with self.env.open_file(self.path, "a") as f:
                    f.write(payload)
                self._append_ok = True
                with self._lock:
                    self._flushed = max(self._flushed, total)
                self._active_bytes += len(payload)
                if fsync:
                    _fsync_path(self.path)
                self._maybe_rotate(total)
                return
            except Exception:  # noqa: BLE001 - backend without append
                self._append_ok = False
                # Fall through to the full rewrite, which also repairs any
                # partial line the failed append may have left.
        with self._lock:
            # Copy the refs under the lock, serialize OUTSIDE it: on
            # backends without append support this path runs every flush,
            # and O(journal) json.dumps under the buffer lock would stall
            # record() — i.e. the RPC hot path — for the duration. Only
            # the ACTIVE file's share is rewritten; the rotated prefix is
            # sealed in its segments.
            snapshot = list(self._events[rotated:total])
        payload = "".join(json.dumps(e, default=str) + "\n" for e in snapshot)
        try:
            self.env.dump(payload, self.path)
            with self._lock:
                self._flushed = max(self._flushed, total)
            self._active_bytes = len(payload)
            if fsync:
                _fsync_path(self.path)
            self._maybe_rotate(total)
        except Exception:  # noqa: BLE001 - telemetry must never fail a run
            with self._lock:
                self._dirty = True

    # locked-by: _flush_lock
    def _maybe_rotate(self, total: int) -> None:
        """Seal the active file into the next numbered segment when it
        outgrew the cap. Runs inside the flush cycle, so rotation can
        never interleave with a write. Failure is non-fatal: the active
        file just keeps growing until a later rotation succeeds."""
        if self._max_bytes is None or self._active_bytes < self._max_bytes:
            return
        with self._lock:
            rotated = self._rotated
        segment = _segment_path(self.path, self._segments + 1)
        snapshot = self._events_slice(rotated, total)
        payload = "".join(json.dumps(e, default=str) + "\n"
                          for e in snapshot)
        try:
            # Copy-then-truncate (no rename in the env abstraction, and
            # object stores have none anyway). A FAILED truncate deletes
            # the just-written segment below, so in-process errors never
            # leave the sealed window on disk twice; only a hard kill
            # exactly between the two writes can duplicate one rotation
            # window — the same old-or-new granularity bound the
            # unrotated journal already accepts for its tail line.
            self.env.dump(payload, segment)
            if self._fsync:
                # Seal durability (the fsync knob's other half): a sealed
                # segment is immutable recovery input — it must survive a
                # host crash, not just a process one.
                _fsync_path(segment)
            self.env.dump("", self.path)
        except Exception:  # noqa: BLE001 - telemetry must never fail a run
            try:
                self.env.delete(segment)
            except Exception:  # noqa: BLE001
                pass
            return
        self._segments += 1
        self._active_bytes = 0
        with self._lock:
            self._rotated = max(self._rotated, total)

    def _events_slice(self, start: int, stop: int) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events[start:stop])

    def _flusher(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            self.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.flush()


class JournalEvents(list):
    """Parsed journal events, plus ``torn_lines``: how many corrupt lines
    the parser had to skip. A torn tail line from a hard kill is expected
    (at most 1); more than that means real corruption silently shrinking
    the dataset — callers surface the count instead of hiding it."""

    torn_lines: int = 0


def _parse_jsonl(text: str) -> JournalEvents:
    events = JournalEvents()
    torn = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            torn += 1  # torn tail line from a hard kill mid-flush
            continue
        if isinstance(ev, dict):
            events.append(ev)
        else:
            torn += 1  # valid JSON but not an event object
    events.torn_lines = torn
    return events


def _load_parts(path: str, env=None) -> Tuple[List[Dict[str, Any]],
                                              Optional[JournalEvents],
                                              int, int]:
    """Read a (possibly rotated) journal from disk: ``(segment_events,
    active_events_or_None, n_segments, torn_lines)``. Segments are read
    in ascending index order — the order they were sealed — so the
    concatenation is the original event stream."""
    if env is not None:
        exists, load = env.exists, env.load
    else:
        exists = os.path.exists

        def load(p):
            with open(p) as f:
                return f.read()

    segments: List[Dict[str, Any]] = []
    torn = 0
    n_segments = 0
    while True:
        seg = _segment_path(path, n_segments + 1)
        if not exists(seg):
            break
        parsed = _parse_jsonl(load(seg))
        segments.extend(parsed)
        torn += parsed.torn_lines
        n_segments += 1
    active: Optional[JournalEvents] = None
    if exists(path):
        active = _parse_jsonl(load(path))
        torn += active.torn_lines
    return segments, active, n_segments, torn


def read_events(path: str, env=None) -> JournalEvents:
    """Load a journal's events: through ``env`` when given, else the local
    filesystem (offline replay of a copied artifact). Rotated segments
    (``<path>.000001`` ...) are read first, in order, then the active
    file — consumers see one continuous stream. The returned list
    carries ``torn_lines`` — the count of corrupt/torn lines skipped."""
    segments, active, _, torn = _load_parts(path, env=env)
    if not segments and active is None:
        # Preserve the unrotated contract: a missing journal raises the
        # backend's error instead of silently returning an empty list.
        if env is not None:
            env.load(path)
        else:
            with open(path) as f:
                f.read()
    events = JournalEvents(segments + (active if active is not None else []))
    events.torn_lines = torn
    return events
