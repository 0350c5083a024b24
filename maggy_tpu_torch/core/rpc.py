"""Control plane: driver <-> trial-runner RPC.

The subset of ``maggy_tpu/core/rpc.py`` a single-host sweep needs: the
framed transport, the `Reservations` registry with per-partition liveness
(every message counts as a beat), the select-loop `Server`, the HPO
`OptimizationServer` (verbs REG, GET, METRIC, FINAL, LOG, with the next
assignment piggybacked on the FINAL reply when the driver's fast path
processes the FINAL on this thread, and the heartbeat-loss scan on the loop's
tick) and the runner `Client`, whose FINAL echoes the run epoch of the
assignment it finishes. Graceful preemption (JAX `rpc.py:1351-1355, 1468-1474,
2110-2129`): a STOP reply carries ``preempt`` when the driver preempts the
trial, and the runner acks with a FINAL marked ``preempted`` that carries its
last checkpoint step. Parity: reference `maggy/core/rpc.py` (:35-113,
:116-162, :250-286, :295-437, :440-593).

Vectorized blocks (JAX `rpc.py:1333-1389, 1413-1428, 1514-1532, 1893-1939,
2083-2100`): a block's TRIAL reply journals a ``running`` edge for every
lane; its heartbeat carries ``lanes``, one lane-tagged metric a live lane,
and a lane's early stop is answered with ``stop_lanes`` (the runner masks
the lane), a STOP being kept for a preemption of the whole block; each lane
sends its own FINAL with its own run epoch, and only the last (``last``)
clears the partition, by the block leader's id, and gets the hand-off.

Telemetry rides the same places as in the JAX package (`rpc.py:433-488,
:663-675, :1306-1529, :1918-1925`): the TELEM verb answers with the
driver's telemetry snapshot, every verb's service time lands in an
``rpc.handle_ms.<verb>`` histogram, the server journals runner
registration and the ``running``, ``stop_sent`` and ``prefetch_hit`` /
``prefetch_miss`` span phases, and the client ships its ``RunnerStats``
deltas on the heartbeat METRIC (``rstats``) with the beat's round-trip
time. Every record path only appends to memory.

Fault injection (JAX `rpc.py:131-160, 614-652, 712-722, 1766-1820`): every
chaos hook first reads ``chaos.active_engine()``, and unarmed that read is
its only cost. The server's dispatch asks ``on_server_message`` whether to
drop, delay or sever a request, its loop calls the engine's ``tick`` between
selects, the client's ``_request`` calls ``on_client_request`` (where a
condemned thread runner dies with ``ChaosKilled``) and counts its retries and
reconnects in ``CLIENT_METRICS``, and ``Reservations.age_beat`` fakes a
silent runner for ``fake_preemption``.

Wire layout as in the JAX package: 4-byte big-endian length, 32-byte
HMAC-SHA256 of the payload under the experiment secret, payload. The payload
is JSON (the JAX package uses msgpack); every frame is a fixed-schema map of
declarative data — nothing on the wire is ever unpickled.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import random
import secrets as pysecrets
import selectors
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from maggy_tpu_torch import constants
from maggy_tpu_torch.chaos.injectors import ChaosKilled
from maggy_tpu_torch.chaos.injectors import active_engine as chaos_engine
from maggy_tpu_torch.exceptions import AuthenticationError
from maggy_tpu_torch.telemetry.metrics import MetricsRegistry
from maggy_tpu_torch.trial import Trial
from maggy_tpu_torch.util import json_default_numpy

_LEN = struct.Struct(">I")
_HEADER = 4 + 32
MAX_FRAME = 64 * 1024 * 1024

#: Process-wide client-side RPC counters (``rpc.client.retries``,
#: ``rpc.client.reconnects``): thread runners share them with the driver, so
#: a chaos soak can tell that the retry paths ran.
CLIENT_METRICS = MetricsRegistry()

#: The client's retry backoff sleep, a module attribute of its own so that a
#: test can count the backoff without patching ``time.sleep`` for every
#: thread of its process.
_sleep = time.sleep


# --------------------------------------------------------------------- wire


def _sign(secret: bytes, payload: bytes) -> bytes:
    return hmac.new(secret, payload, hashlib.sha256).digest()


def _encode(msg: Dict[str, Any]) -> bytes:
    return json.dumps(msg, default=json_default_numpy).encode("utf-8")


class MessageSocket:
    """Framed transport: 4-byte big-endian length || 32-byte HMAC || JSON."""

    @staticmethod
    def send_msg(sock: socket.socket, msg: Dict[str, Any], secret: bytes) -> None:
        payload = _encode(msg)
        if len(payload) > MAX_FRAME:
            raise ValueError("Frame too large: {} bytes".format(len(payload)))
        sock.sendall(_LEN.pack(len(payload)) + _sign(secret, payload) + payload)

    @staticmethod
    def recv_msg(sock: socket.socket, secret: bytes) -> Dict[str, Any]:
        header = MessageSocket._recv_exact(sock, _HEADER)
        (length,) = _LEN.unpack(header[:4])
        if length > MAX_FRAME:
            raise AuthenticationError("Oversized frame.")
        payload = MessageSocket._recv_exact(sock, length)
        if not hmac.compare_digest(header[4:], _sign(secret, payload)):
            raise AuthenticationError("Bad message HMAC.")
        return json.loads(payload)

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(min(constants.RPC_RECV_BUFSIZE, n - len(buf)))
            if not chunk:
                raise ConnectionError("Socket closed mid-frame.")
            buf.extend(chunk)
        return bytes(buf)


# -------------------------------------------------------------- reservations


class Reservations:
    """Thread-safe registry partition_id -> runner record (reference
    `rpc.py:35-113`)."""

    def __init__(self):
        self.lock = threading.RLock()
        self._table: Dict[int, Dict[str, Any]] = {}  # guarded-by: lock

    def add(self, meta: Dict[str, Any]) -> None:
        with self.lock:
            rec = dict(meta)
            rec["last_beat"] = time.monotonic()
            self._table[int(meta["partition_id"])] = rec

    def touch(self, partition_id) -> None:
        """Record liveness: any message from the runner counts as a beat.
        A chaos mute window (``age_beat``) suppresses the update."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None and rec.get("mute_until", 0.0) <= time.monotonic():
                rec["last_beat"] = time.monotonic()

    def age_beat(self, partition_id, age_s: float, mute_s: float = 0.0) -> None:
        """Chaos ``fake_preemption``: push the partition's last beat
        ``age_s`` into the past and ignore its beats for ``mute_s`` seconds,
        so the heartbeat-loss scan sees a silent runner while the runner
        stays alive (the falsely-declared-lost race)."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None:
                now = time.monotonic()
                rec["last_beat"] = min(rec.get("last_beat", now), now - age_s)
                if mute_s > 0:
                    rec["mute_until"] = now + mute_s

    # locked-by: lock
    def _silent_locked(self, timeout: float):
        now = time.monotonic()
        return [pid for pid, rec in self._table.items()
                if not rec.get("released") and now - rec["last_beat"] > timeout]

    def silent(self, timeout: float):
        """Registered, unreleased partitions silent for longer than
        ``timeout``, whether or not they hold a trial."""
        with self.lock:
            return self._silent_locked(timeout)

    def lost_assignments(self, timeout: float):
        """Silent partitions that hold a trial: [(partition_id, trial_id)].
        Read-only; the caller decides recovery (``maggy_tpu/core/rpc.py:
        181-189``)."""
        with self.lock:
            return [(pid, self._table[pid]["trial_id"])
                    for pid in self._silent_locked(timeout)
                    if self._table[pid].get("trial_id") is not None]

    def assign_trial(self, partition_id: int, trial_id: Optional[str]) -> None:
        """Assign (or with None clear) the partition's trial; either way the
        driver has decided, so a held re-registration is released."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None:
                rec["trial_id"] = trial_id
                rec.pop("held", None)

    def clear_trial_if(self, partition_id: int, trial_id: Optional[str]) -> None:
        """Clear the partition's assignment only if it still names
        ``trial_id``: a retried FINAL must not wipe the next trial assigned
        in between (at-least-once delivery)."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None and rec.get("trial_id") == trial_id:
                rec["trial_id"] = None

    def mark_released(self, partition_id) -> None:
        """The runner has been told GSTOP — it will send nothing more."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None:
                rec["released"] = True

    def live_count(self) -> int:
        """Registered, unreleased partitions: the prefetch queue's bound."""
        with self.lock:
            return sum(1 for rec in self._table.values() if not rec.get("released"))

    def get(self, partition_id) -> Optional[Dict[str, Any]]:
        """A copy of the partition's record (None before its REG)."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            return dict(rec) if rec is not None else None

    def is_silent(self, partition_id, timeout: float) -> bool:
        """Whether the registered partition has sent nothing for longer
        than ``timeout``."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            return rec is not None and time.monotonic() - rec["last_beat"] > timeout

    def get_assigned_trial(self, partition_id: int) -> Optional[str]:
        with self.lock:
            rec = self._table.get(int(partition_id))
            return rec.get("trial_id") if rec else None

    def all(self) -> Dict[int, Dict[str, Any]]:
        """Copies of every partition's record: the health engine's view of
        who holds what, and the obs /status reservation table."""
        with self.lock:
            return {pid: dict(rec) for pid, rec in self._table.items()}

    def servable_trial(self, partition_id: int) -> Optional[str]:
        """The assignment a GET may hand out: none while a re-registration
        is held for the driver's BLACK path (``held``)."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            return None if rec is None or rec.get("held") else rec.get("trial_id")

    # ------------------------------------------------------- crash recovery

    def restore(self, partition_id, trial_id: Optional[str] = None,
                capacity: Optional[int] = None) -> None:
        """Re-seed a pre-crash partition's record from the replayed journal,
        with a fresh last beat: a live runner's next message re-binds it
        (``pop_recovered`` journals ``adopted``), a dead one goes silent
        past the loss bound and the ordinary loss scan requeues its trial.
        Never overwrites a live registration."""
        with self.lock:
            pid = int(partition_id)
            if pid in self._table:
                return
            self._table[pid] = {"partition_id": pid, "trial_id": trial_id,
                                "capacity": capacity, "recovered": True,
                                "last_beat": time.monotonic()}

    def pop_recovered(self, partition_id) -> bool:
        """Consume the partition's recovered flag: True exactly once, on the
        first message after recovery."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None and rec.get("recovered"):
                rec.pop("recovered", None)
                return True
            return False


# --------------------------------------------------------------------- server


class Server:
    """Event-loop RPC server running in a daemon thread. Verbs are
    dispatched to ``_handlers``; an unknown verb gets an ERR reply."""

    def __init__(self, secret: Optional[str] = None):
        # Telemetry facade (maggy_tpu_torch.telemetry.Telemetry), attached
        # by the driver. None = no TELEM verb, no verb timing.
        self.telemetry = None
        self.secret_hex = secret or pysecrets.token_hex(16)
        self.secret = self.secret_hex.encode()
        self.reservations = Reservations()
        self._buffers: Dict[socket.socket, bytearray] = {}
        self._sel = selectors.DefaultSelector()
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._handlers: Dict[str, Callable[[Dict[str, Any]], Dict[str, Any]]] = {}
        self._register_handlers()

    def _register_handlers(self) -> None:
        """Subclasses add their verbs."""
        self._handlers["TELEM"] = self._telem

    def _telem(self, msg):
        """The telemetry snapshot: live metric registry and span-derived
        scheduling numbers, under the same per-message HMAC as every verb."""
        telem = self.telemetry
        if telem is None or not telem.enabled:
            return {"type": "ERR", "error": "telemetry is not enabled for this experiment"}
        return {"type": "TELEM", **telem.snapshot()}

    def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(128)
        srv.setblocking(False)
        self._sel.register(srv, selectors.EVENT_READ, self._accept)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="rpc-server")
        self._thread.start()
        return srv.getsockname()

    def _accept(self, sock, mask):
        conn, _ = sock.accept()
        # Non-blocking with a per-connection reassembly buffer: a stalled
        # client must never freeze the event loop.
        conn.setblocking(False)
        self._buffers[conn] = bytearray()
        self._sel.register(conn, selectors.EVENT_READ, self._serve)

    def _serve(self, conn, mask):
        try:
            chunk = conn.recv(constants.RPC_RECV_BUFSIZE)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        if not chunk:
            self._drop(conn)
            return
        buf = self._buffers[conn]
        buf.extend(chunk)
        while conn in self._buffers:
            payload = self._try_extract_frame(conn, buf)
            if payload is None:
                return
            self._dispatch(conn, payload)

    def _try_extract_frame(self, conn, buf: bytearray) -> Optional[bytes]:
        """Pop one complete authenticated frame from the buffer, or None. An
        oversized frame or a MAC mismatch drops the connection."""
        if len(buf) < _HEADER:
            return None
        (length,) = _LEN.unpack(bytes(buf[:4]))
        if length > MAX_FRAME:
            self._drop(conn)
            return None
        if len(buf) < _HEADER + length:
            return None
        payload = bytes(buf[_HEADER:_HEADER + length])
        if not hmac.compare_digest(bytes(buf[4:_HEADER]), _sign(self.secret, payload)):
            self._drop(conn)
            return None
        del buf[:_HEADER + length]
        return payload

    def _dispatch(self, conn, payload: bytes):
        sever_reply = False
        try:
            msg = json.loads(payload)
            engine = chaos_engine()
            if engine is not None:
                action = engine.on_server_message(msg)
                if action is not None:
                    if action[0] == "drop":
                        # Message lost and the connection reset: the
                        # client's retry path re-delivers.
                        self._drop(conn)
                        return
                    if action[0] == "delay":
                        # On the event loop on purpose: a stalled control
                        # plane stalls every client.
                        time.sleep(action[1])
                    elif action[0] == "sever":
                        # Handle, then cut the connection instead of
                        # replying: the client retries and the handler runs
                        # twice (at-least-once delivery).
                        sever_reply = True
            resp = self.handle_message(msg)
        except Exception as e:  # noqa: BLE001 - a bad message must never kill the loop
            resp = {"type": "ERR", "error": "handler error: {!r}".format(e)}
        if sever_reply:
            self._drop(conn)
            return
        try:
            conn.setblocking(True)
            MessageSocket.send_msg(conn, resp, self.secret)
            conn.setblocking(False)
        except OSError:
            self._drop(conn)

    def handle_message(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Handler lookup and the verb's service time, recorded even when
        the handler raises (``maggy_tpu/core/rpc.py:663-675``)."""
        handler = self._handlers.get(msg.get("type"))
        if handler is None:
            return {"type": "ERR", "error": "unknown message type"}
        t0 = time.monotonic()
        try:
            return handler(msg)
        finally:
            telem = self.telemetry
            if telem is not None:
                telem.observe_ms("rpc.handle_ms.{}".format(msg.get("type")),
                                 (time.monotonic() - t0) * 1e3)

    def _drop(self, conn):
        self._buffers.pop(conn, None)
        try:
            self._sel.unregister(conn)
        except (KeyError, ValueError):
            pass
        try:
            conn.close()
        except OSError:
            pass

    def _loop(self):
        while not self._stop_event.is_set():
            for key, mask in self._sel.select(timeout=0.2):
                key.data(key.fileobj, mask)
            self._tick()
            engine = chaos_engine()
            if engine is not None:
                # Elapsed-time fault triggers ride the loss scan's cadence.
                engine.tick()

    def _tick(self) -> None:
        """Periodic hook run on the event-loop thread between selects."""

    def stop(self):
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for key in list(self._sel.get_map().values()):
            self._drop(key.fileobj)
        self._sel.close()


class OptimizationServer(Server):
    """HPO message semantics (reference `rpc.py:295-388`). The driver
    attaches itself via `attach_driver` so handlers can read trial state
    and hand work to the driver."""

    def __init__(self, secret: Optional[str] = None):
        self.driver = None
        # partition -> when its last FINAL arrived, until its next TRIAL
        # leaves (the hand-off gap); touched only on the server thread.
        self._final_at: Dict[int, float] = {}
        # Seconds of silence after which a partition holding a trial is
        # declared lost (set by the driver); None disables the scan.
        self.hb_loss_timeout: Optional[float] = None
        self._last_loss_scan = time.monotonic()
        super().__init__(secret)

    def attach_driver(self, driver) -> None:
        self.driver = driver

    def _register_handlers(self) -> None:
        super()._register_handlers()
        self._handlers.update(REG=self._reg, METRIC=self._metric,
                              FINAL=self._final, GET=self._get, LOG=self._log)

    def _tick(self) -> None:
        """The heartbeat-loss scan, at most every min(1 s, timeout / 4):
        each silent partition holding a trial loses its assignment first
        (so its late FINAL clears nothing), then the driver gets LOST
        (``maggy_tpu/core/rpc.py:1260-1286``)."""
        if self.driver is None or self.hb_loss_timeout is None:
            return
        now = time.monotonic()
        if now - self._last_loss_scan < min(1.0, self.hb_loss_timeout / 4):
            return
        self._last_loss_scan = now
        for pid, trial_id in self.reservations.lost_assignments(self.hb_loss_timeout):
            self.reservations.assign_trial(pid, None)
            self.driver.enqueue({"type": "LOST", "trial_id": trial_id, "partition_id": pid})

    def _note_adopted(self, partition_id) -> None:
        """A recovered partition's first message: the runner outlived the
        driver and re-bound on the same secret and address; the ``adopted``
        runner edge is journaled once."""
        if self.reservations.pop_recovered(partition_id) and self.telemetry is not None:
            self.telemetry.event("runner", phase="adopted", partition=int(partition_id))

    def _reg(self, msg):
        """A registration from a partition that already holds a trial means
        its runner died and was relaunched (or a resumed driver restored the
        dead incarnation's assignment): the trial stays on the record and
        the driver takes the BLACK path, which requeues it and hands it back
        to this slot (reference `rpc.py:308-326`). Until the driver has
        done so the record is ``held``: the trial stays on it (an IDLE nudge
        must not assign over it) but no GET serves it, since the new runner
        would run it under the dead run's epoch, whose FINAL the requeue
        then drops as stale, clearing the re-assignment and stranding the
        trial. Otherwise REG asks for a first assignment."""
        pid = msg["partition_id"]
        prev = self.reservations.get_assigned_trial(pid)
        self.reservations.add({"partition_id": pid, "trial_id": prev,
                               "capacity": msg.get("capacity"), "held": prev is not None})
        if prev is not None:
            self.driver.enqueue({"type": "BLACK", "trial_id": prev, "partition_id": pid})
        else:
            self.driver.enqueue({"type": "REG", "partition_id": pid})
        telem = self.telemetry
        if telem is not None:
            telem.event("runner", phase="registered", partition=int(pid),
                        capacity=msg.get("capacity"), reregistration=prev is not None)
        return {"type": "OK"}

    def _metric(self, msg):
        pid = msg["partition_id"]
        self.reservations.touch(pid)
        self._note_adopted(pid)
        telem = self.telemetry
        rstats = msg.pop("rstats", None)
        if rstats and telem is not None:
            # Popped first: the driver's METRIC callback sees the payload
            # shape it always did.
            telem.record_runner_stats(pid, rstats)
        trial_id = msg.get("trial_id")
        assigned = self.reservations.get_assigned_trial(pid)
        if trial_id is not None and assigned != trial_id and (
                assigned is None or self.driver.block_leader(trial_id) != assigned):
            # A runner declared lost keeps beating if it was only slow: its
            # metric must not enter the history of the trial's re-run (a
            # lane of a block the partition holds is its own).
            msg = {k: v for k, v in msg.items() if k != "lanes"}
            msg["value"] = None
        self.driver.enqueue(dict(msg))
        if msg.get("lanes"):
            return self._metric_lanes(msg, trial_id)
        trial = self.driver.get_trial(trial_id) if trial_id else None
        if trial is not None and trial.get_early_stop():
            if telem is not None:
                # The moment the runner is FIRST told to stop: once, since
                # every beat draws STOP until the training loop honors it.
                telem.trial_event(trial_id, "stop_sent", once=True, partition=int(pid))
            # ``preempt``: a scheduler preemption, not an early-stop verdict
            # — the runner acks with a preempted FINAL carrying its last
            # checkpoint step instead of finalizing (JAX `rpc.py:1351-1355`).
            return {"type": "STOP", "preempt": trial.get_preempt()}
        return {"type": "OK"}

    def _metric_lanes(self, msg, leader_id):
        """The reply to a block's beat: ``stop_lanes`` names the lanes the
        driver stopped (the runner masks them; the block keeps running), and
        a STOP is kept for a preemption, which stops the whole block (JAX
        `rpc.py:1358-1389`)."""
        telem = self.telemetry
        stop_lanes, preempt = [], False
        for beat in msg["lanes"]:
            lane_trial = self.driver.get_trial(beat.get("trial_id"))
            if lane_trial is None or not lane_trial.get_early_stop():
                continue
            if lane_trial.get_preempt():
                preempt = True
                continue
            stop_lanes.append(beat["trial_id"])
            if telem is not None:
                # once: the lane appears in beats until the loop masks it.
                telem.trial_event(beat["trial_id"], "stop_sent", once=True,
                                  partition=int(msg["partition_id"]), lane=beat.get("lane"))
        leader = self.driver.get_trial(leader_id) if leader_id else None
        if preempt or (leader is not None and leader.get_early_stop() and leader.get_preempt()):
            return {"type": "STOP", "preempt": True}
        reply = {"type": "OK"}
        if stop_lanes:
            reply["stop_lanes"] = stop_lanes
        return reply

    def _final(self, msg):
        """The FINAL handler with its durability barrier, run after the
        handler and before the reply is written: the journal can never
        trail a FINAL the runner saw acknowledged. On the inline fast path
        the finalized edge and trial.json are both durable when the reply
        leaves; on the worker fallback the FINAL is still queued, and a
        crash in that window re-runs the trial (at least once, never lost;
        JAX `rpc.py:1390-1408`)."""
        try:
            return self._final_unbarriered(msg)
        finally:
            if self.telemetry is not None:
                self.telemetry.barrier()

    def _final_unbarriered(self, msg):
        """Finalize on this thread when the driver's fast path takes it and
        reply with the runner's next assignment (TRIAL), its release
        (GSTOP), or OK; otherwise enqueue the FINAL for the driver's worker
        thread and reply OK: the runner then GET-polls (JAX `rpc.py:1428-
        1447`)."""
        pid = msg["partition_id"]
        self.reservations.touch(pid)
        self._note_adopted(pid)
        if msg.get("block") is not None and not msg.get("last"):
            # A lane's FINAL before the block's last: the partition still
            # holds the block, so no clear and no hand-off; the driver
            # reports the lane to the controller now.
            if not self.driver.process_final_inline(msg):
                self.driver.enqueue(dict(msg))
            return {"type": "OK"}
        self._final_at[pid] = time.monotonic()
        # Conditional: a retried FINAL must not wipe the next assignment. A
        # FINAL of a run declared lost finds its assignment already cleared
        # by the scan, and the driver drops it by its stale run epoch. A
        # block's last lane clears by the leader, whose id the partition
        # holds.
        self.reservations.clear_trial_if(pid, msg.get("block") or msg.get("trial_id"))
        if not self.driver.process_final_inline(msg):
            self.driver.enqueue(dict(msg))
            return {"type": "OK"}
        telem = self.telemetry
        reply = self._serve_assigned(pid)
        if reply is not None:
            if telem is not None and reply["type"] == "TRIAL":
                # once: a retried FINAL re-serves the same undelivered
                # assignment — one hand-off, one hit.
                telem.trial_event(reply["trial_id"], "prefetch_hit", once=True,
                                  partition=int(pid))
            return reply
        if self.driver.experiment_done:
            self._release(pid)
            return {"type": "GSTOP"}
        if telem is not None and not msg.get("preempted"):
            # Nothing ready: the runner falls back to GET polling. A
            # preempted ack is no hand-off attempt, so it is no miss.
            telem.trial_event(msg.get("trial_id"), "prefetch_miss", once=True,
                              partition=int(pid))
        return {"type": "OK"}

    def _release(self, partition_id) -> None:
        self._final_at.pop(partition_id, None)
        self.reservations.mark_released(partition_id)
        if self.telemetry is not None:
            # A released runner sends nothing more: its live gauges go.
            self.telemetry.prune_partition(partition_id)

    def _serve_assigned(self, partition_id):
        """The TRIAL reply for the partition's assigned trial — shared by GET
        and the FINAL piggyback. None = no assignment."""
        trial_id = self.reservations.servable_trial(partition_id)
        if trial_id is None:
            return None
        trial = self.driver.get_trial(trial_id)
        if trial is None:
            return {"type": "OK", "trial_id": None}
        trial.set_status(Trial.RUNNING)
        with trial.lock:
            trial.start = time.time()
            trial.info_dict["partition"] = partition_id
            # The FINAL echoes the run epoch: the driver drops a dead run's
            # FINAL by epoch even when the re-run is on the same partition.
            trial.info_dict["epoch"] = trial.run_epoch
            info = dict(trial.info_dict)
        t_final = self._final_at.pop(partition_id, None)
        telem = self.telemetry
        if telem is not None:
            # "running" = the TRIAL reply leaves the driver: the hand-off
            # gap's closing edge. ``handoff_ms`` is the gap from this
            # runner's FINAL reaching the server, where there was one.
            extra = {} if t_final is None else \
                {"handoff_ms": (time.monotonic() - t_final) * 1e3}
            telem.trial_event(trial.trial_id, "running", partition=int(partition_id),
                              epoch=info.get("epoch"), **extra)
        for entry in (info.get("vmap_block") or {}).get("lanes", ()):
            # A block's lanes enter RUNNING with the leader, each with a
            # running edge of its own, so every lane's span closes.
            if entry["trial_id"] == trial.trial_id:
                continue
            lane_trial = self.driver.get_trial(entry["trial_id"])
            if lane_trial is None:
                continue
            lane_trial.set_status(Trial.RUNNING)
            with lane_trial.lock:
                lane_trial.start = time.time()
                lane_trial.info_dict["partition"] = partition_id
                lane_trial.info_dict["epoch"] = lane_trial.run_epoch
            if telem is not None:
                telem.trial_event(entry["trial_id"], "running", partition=int(partition_id),
                                  epoch=entry.get("epoch"), lane=entry.get("lane"),
                                  block=trial.trial_id)
        return {"type": "TRIAL", "trial_id": trial.trial_id,
                "params": trial.params, "info": info}

    def _get(self, msg):
        self.reservations.touch(msg["partition_id"])
        self._note_adopted(msg["partition_id"])
        # Serve an already-assigned trial BEFORE honoring experiment-done:
        # the last suggestion may be assigned concurrently with another
        # FINAL ending the experiment, and must still run.
        reply = self._serve_assigned(msg["partition_id"])
        if reply is not None:
            return reply
        if self.driver.experiment_done:
            self._release(msg["partition_id"])
            return {"type": "GSTOP"}
        return {"type": "OK", "trial_id": None}

    def _log(self, msg):
        return {"type": "LOG", **self.driver.progress_snapshot()}


# --------------------------------------------------------------------- client


class Client:
    """Runner-side control-plane client (reference `rpc.py:440-593`): one
    request socket plus one heartbeat socket; the heartbeat thread ships
    (metric, step, logs) every ``hb_interval`` and applies STOP replies to
    the reporter."""

    def __init__(self, server_addr: Tuple[str, int], partition_id: int,
                 hb_interval: float, secret: str):
        self.server_addr = tuple(server_addr)
        self.partition_id = partition_id
        self.hb_interval = hb_interval
        self.secret = secret.encode() if isinstance(secret, str) else secret
        self.done = False
        self.last_info: dict = {}
        # Next assignment piggybacked on a FINAL reply: (trial_id, params,
        # info), consumed by the next get_suggestion without a round trip.
        self._piggyback: Optional[tuple] = None
        self._sock = self._connect()
        self._hb_sock = self._connect()
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._lock = threading.Lock()  # serializes the request socket
        # Runner-side stat buffer (telemetry.runnerstats.RunnerStats), set
        # by the trial executor: its deltas ride the heartbeat METRIC.
        self.runner_stats = None

    def _connect(self) -> socket.socket:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(30.0)
        sock.connect(self.server_addr)
        return sock

    def _request(self, msg: Dict[str, Any], heartbeat: bool = False) -> Dict[str, Any]:
        """Send one message with reconnect retries (exponential backoff with
        full jitter, reference `rpc.py:465-493`), counted in
        ``CLIENT_METRICS``. An armed chaos engine may stall the call or, for
        a condemned runner, raise ``ChaosKilled``, which no retry catches."""
        msg = {**msg, "partition_id": self.partition_id}
        last_err = None
        delay = constants.CLIENT_RETRY_BACKOFF_BASE_S
        for attempt in range(constants.CLIENT_MAX_RETRIES + 1):
            engine = chaos_engine()
            if engine is not None:
                engine.on_client_request(msg)
            try:
                if heartbeat:
                    MessageSocket.send_msg(self._hb_sock, msg, self.secret)
                    return MessageSocket.recv_msg(self._hb_sock, self.secret)
                with self._lock:
                    MessageSocket.send_msg(self._sock, msg, self.secret)
                    return MessageSocket.recv_msg(self._sock, self.secret)
            except ChaosKilled:
                raise
            except (ConnectionError, socket.timeout, OSError) as e:
                last_err = e
                if attempt >= constants.CLIENT_MAX_RETRIES:
                    break
                CLIENT_METRICS.counter("rpc.client.retries").inc()
                _sleep(delay * (0.5 + 0.5 * random.random()))
                delay = min(delay * 2, constants.CLIENT_RETRY_BACKOFF_CAP_S)
                try:
                    fresh = self._connect()
                except OSError as conn_err:
                    last_err = conn_err
                    continue
                CLIENT_METRICS.counter("rpc.client.reconnects").inc()
                if heartbeat:
                    self._hb_sock = fresh
                else:
                    self._sock = fresh
        raise ConnectionError("RPC request failed after retries: {}".format(last_err))

    def register(self) -> None:
        self._request({"type": "REG"})

    def start_heartbeat(self, reporter) -> None:
        def beat():
            while not self._hb_stop.is_set():
                try:
                    data = reporter.get_data()
                except Exception as e:  # noqa: BLE001
                    # A failed materialization must not silence the beat.
                    reporter.log("heartbeat error: {!r}".format(e))
                    data = {"metric": None, "step": None, "logs": [],
                            "trial_id": reporter.trial_id}
                sent_tid = data["trial_id"]
                payload = {"type": "METRIC", "trial_id": sent_tid, "value": data["metric"],
                           "step": data["step"], "logs": data["logs"],
                           "span": data.get("span")}
                if data.get("lanes"):
                    # A block's beat: one lane-tagged entry a live lane.
                    payload["lanes"] = data["lanes"]
                stats = self.runner_stats
                delta = stats.snapshot_delta() if stats is not None else None
                if delta:
                    payload["rstats"] = delta
                t_send = time.monotonic()
                try:
                    resp = self._request(payload, heartbeat=True)
                    if stats is not None:
                        # Retries and backoff included: the control-plane
                        # latency the runner experiences.
                        stats.observe_hb_rtt((time.monotonic() - t_send) * 1e3)
                except (ConnectionError, ValueError):
                    resp = {}
                    if delta:
                        # Re-send on the next beat instead of losing it.
                        stats.requeue_delta(delta)
                if resp.get("type") == "STOP":
                    # Only stop the trial the beat was ABOUT: the runner may
                    # have rolled over to the next trial meanwhile.
                    reporter.early_stop(trial_id=sent_tid, preempt=bool(resp.get("preempt")))
                elif resp.get("stop_lanes"):
                    # Lanes of the block the driver stopped: the training
                    # loop masks them in place.
                    reporter.stop_lanes(resp["stop_lanes"])
                self._hb_stop.wait(self.hb_interval)

        self._hb_thread = threading.Thread(target=beat, daemon=True, name="heartbeat")
        self._hb_thread.start()

    def get_suggestion(self):
        """Blocking poll for the next trial: (trial_id, params), or (None,
        None) once the experiment is over (reference `rpc.py:537-546`). An
        assignment piggybacked on the last FINAL reply returns without a
        round trip; GET polls back off from 5 ms to the driver tick."""
        pg = self._piggyback
        if pg is not None:
            self._piggyback = None
            trial_id, params, self.last_info = pg
            return trial_id, params
        if self.done:
            return None, None
        delay = constants.CLIENT_GET_POLL_MIN_S
        while True:
            resp = self._request({"type": "GET"})
            if resp.get("type") == "GSTOP":
                self.done = True
                return None, None
            if resp.get("type") == "TRIAL":
                self.last_info = resp.get("info", {})
                return resp["trial_id"], resp["params"]
            time.sleep(delay)
            delay = min(delay * 2, constants.DRIVER_IDLE_REQUEUE_TICK_S)

    def _finalize(self, payload: Dict[str, Any], reporter) -> Dict[str, Any]:
        """Send FINAL and reset the reporter atomically under its lock
        (reference `rpc.py:584-593`); bank a piggybacked TRIAL or GSTOP."""
        with reporter.lock:
            data = reporter.get_data()
            resp = self._request({"epoch": self.last_info.get("epoch"), **payload,
                                  "type": "FINAL", "logs": data["logs"]})
            reporter.reset()
        self._bank(resp)
        return resp

    def finalize_lane(self, trial_id: str, metric, reporter, *, lane: int, block: str,
                      epoch=None, last: bool = False, error: bool = False) -> Dict[str, Any]:
        """One lane's FINAL of a K-lane block, with the LANE's run epoch (the
        leader's would let a stale lane FINAL past the driver's epoch
        guard). Only the ``last`` releases the partition, resets the
        reporter and banks the reply's hand-off (JAX `rpc.py:2083-2108`)."""
        payload = {"trial_id": trial_id, "value": None if error else metric, "epoch": epoch,
                   "lane": int(lane), "block": block, "last": bool(last)}
        if error:
            payload["error"] = True
        if last:
            return self._finalize(payload, reporter)
        return self._request({**payload, "type": "FINAL", "logs": []})

    def _bank(self, resp: Dict[str, Any]) -> None:
        if resp.get("type") == "TRIAL":
            self._piggyback = (resp["trial_id"], resp["params"], resp.get("info", {}))
        elif resp.get("type") == "GSTOP":
            self.done = True

    def finalize_metric(self, metric, reporter) -> Dict[str, Any]:
        return self._finalize({"trial_id": reporter.trial_id, "value": metric}, reporter)

    def finalize_error(self, trial_id: str, reporter) -> Dict[str, Any]:
        """Report a failed trial (train_fn raised): FINAL with the error
        flag and no metric."""
        return self._finalize({"trial_id": trial_id, "value": None, "error": True},
                              reporter)

    def preempt_ack(self, trial_id: str, reporter, step: Optional[int] = None) -> Dict[str, Any]:
        """Acknowledge a scheduler preemption: a FINAL marked ``preempted``
        with the trial's last checkpoint ``step`` (None = it never
        checkpointed; the driver requeues it from scratch). Its reply is
        banked as a finalize's is: the runner's next assignment may ride it
        (JAX `rpc.py:2110-2129`)."""
        return self._finalize({"trial_id": trial_id, "value": None, "preempted": True,
                               "step": None if step is None else int(step)}, reporter)

    def get_progress(self) -> Dict[str, Any]:
        return self._request({"type": "LOG"})

    def stop(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
        stats = self.runner_stats
        if stats is not None:
            # Last stats flush: the final trial's pending records (its
            # ``compile_events``, finalized at trial end) would otherwise
            # wait for a beat that never comes. One attempt with a short
            # deadline: a server already gone must not stall shutdown
            # (``maggy_tpu/core/rpc.py:2133-2165``).
            try:
                delta = stats.snapshot_delta()
                if delta:
                    msg = {"type": "METRIC", "trial_id": None, "value": None, "step": None,
                           "logs": [], "span": None, "rstats": delta,
                           "partition_id": self.partition_id}
                    with self._lock:
                        self._sock.settimeout(2.0)
                        MessageSocket.send_msg(self._sock, msg, self.secret)
                        MessageSocket.recv_msg(self._sock, self.secret)
            except Exception:  # noqa: BLE001 - shutdown must not fail
                pass
        for sock in (self._sock, self._hb_sock):
            try:
                sock.close()
            except OSError:
                pass
