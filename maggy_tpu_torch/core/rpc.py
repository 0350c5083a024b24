"""Control plane: driver <-> trial-runner RPC.

The subset of ``maggy_tpu/core/rpc.py`` a single-process thread-runner sweep
needs: the framed transport, the `Reservations` registry, the select-loop
`Server`, the HPO `OptimizationServer` (verbs REG, GET, METRIC, FINAL, LOG,
with the next assignment piggybacked on the FINAL reply when the driver's
fast path processes the FINAL on this thread) and the runner `Client`.
Parity: reference `maggy/core/rpc.py` (:35-113, :116-162, :250-286,
:295-437, :440-593).

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
from maggy_tpu_torch.exceptions import AuthenticationError
from maggy_tpu_torch.trial import Trial
from maggy_tpu_torch.util import json_default_numpy

_LEN = struct.Struct(">I")
_HEADER = 4 + 32
MAX_FRAME = 64 * 1024 * 1024


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
            self._table[int(meta["partition_id"])] = dict(meta)

    def assign_trial(self, partition_id: int, trial_id: Optional[str]) -> None:
        with self.lock:
            if int(partition_id) in self._table:
                self._table[int(partition_id)]["trial_id"] = trial_id

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

    def get_assigned_trial(self, partition_id: int) -> Optional[str]:
        with self.lock:
            rec = self._table.get(int(partition_id))
            return rec.get("trial_id") if rec else None


# --------------------------------------------------------------------- server


class Server:
    """Event-loop RPC server running in a daemon thread. Verbs are
    dispatched to ``_handlers``; an unknown verb gets an ERR reply."""

    def __init__(self, secret: Optional[str] = None):
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
        try:
            msg = json.loads(payload)
            handler = self._handlers.get(msg.get("type"))
            resp = handler(msg) if handler is not None \
                else {"type": "ERR", "error": "unknown message type"}
        except Exception as e:  # noqa: BLE001 - a bad message must never kill the loop
            resp = {"type": "ERR", "error": "handler error: {!r}".format(e)}
        try:
            conn.setblocking(True)
            MessageSocket.send_msg(conn, resp, self.secret)
            conn.setblocking(False)
        except OSError:
            self._drop(conn)

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
        super().__init__(secret)

    def attach_driver(self, driver) -> None:
        self.driver = driver

    def _register_handlers(self) -> None:
        self._handlers.update(REG=self._reg, METRIC=self._metric,
                              FINAL=self._final, GET=self._get, LOG=self._log)

    def _reg(self, msg):
        self.reservations.add({"partition_id": msg["partition_id"], "trial_id": None})
        self.driver.enqueue({"type": "REG", "partition_id": msg["partition_id"]})
        return {"type": "OK"}

    def _metric(self, msg):
        self.driver.enqueue(dict(msg))
        trial_id = msg.get("trial_id")
        trial = self.driver.get_trial(trial_id) if trial_id else None
        if trial is not None and trial.get_early_stop():
            return {"type": "STOP"}
        return {"type": "OK"}

    def _final(self, msg):
        """Finalize on this thread when the driver's fast path takes it and
        reply with the runner's next assignment (TRIAL), its release
        (GSTOP), or OK; otherwise enqueue the FINAL for the driver's worker
        thread and reply OK: the runner then GET-polls (JAX `rpc.py:1428-
        1447`)."""
        pid = msg["partition_id"]
        self._final_at[pid] = time.monotonic()
        self.reservations.clear_trial_if(pid, msg.get("trial_id"))
        if not self.driver.process_final_inline(msg):
            self.driver.enqueue(dict(msg))
            return {"type": "OK"}
        reply = self._serve_assigned(pid)
        if reply is not None:
            if reply["type"] == "TRIAL":
                self.driver.note_prefetch_hit(reply["trial_id"])
            return reply
        if self.driver.experiment_done:
            self._release(pid)
            return {"type": "GSTOP"}
        self.driver.note_prefetch_miss(msg.get("trial_id"))
        return {"type": "OK"}

    def _release(self, partition_id) -> None:
        self._final_at.pop(partition_id, None)
        self.reservations.mark_released(partition_id)

    def _serve_assigned(self, partition_id):
        """The TRIAL reply for the partition's assigned trial — shared by GET
        and the FINAL piggyback. None = no assignment."""
        trial_id = self.reservations.get_assigned_trial(partition_id)
        if trial_id is None:
            return None
        trial = self.driver.get_trial(trial_id)
        if trial is None:
            return {"type": "OK", "trial_id": None}
        trial.set_status(Trial.RUNNING)
        with trial.lock:
            trial.start = time.time()
            trial.info_dict["partition"] = partition_id
            info = dict(trial.info_dict)
        t_final = self._final_at.pop(partition_id, None)
        if t_final is not None:
            self.driver.note_handoff(partition_id, (time.monotonic() - t_final) * 1e3)
        return {"type": "TRIAL", "trial_id": trial.trial_id,
                "params": trial.params, "info": info}

    def _get(self, msg):
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

    def _connect(self) -> socket.socket:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(30.0)
        sock.connect(self.server_addr)
        return sock

    def _request(self, msg: Dict[str, Any], heartbeat: bool = False) -> Dict[str, Any]:
        """Send one message with reconnect retries (exponential backoff with
        full jitter, reference `rpc.py:465-493`)."""
        msg = {**msg, "partition_id": self.partition_id}
        last_err = None
        delay = constants.CLIENT_RETRY_BACKOFF_BASE_S
        for attempt in range(constants.CLIENT_MAX_RETRIES + 1):
            try:
                if heartbeat:
                    MessageSocket.send_msg(self._hb_sock, msg, self.secret)
                    return MessageSocket.recv_msg(self._hb_sock, self.secret)
                with self._lock:
                    MessageSocket.send_msg(self._sock, msg, self.secret)
                    return MessageSocket.recv_msg(self._sock, self.secret)
            except (ConnectionError, socket.timeout, OSError) as e:
                last_err = e
                if attempt >= constants.CLIENT_MAX_RETRIES:
                    break
                time.sleep(delay * (0.5 + 0.5 * random.random()))
                delay = min(delay * 2, constants.CLIENT_RETRY_BACKOFF_CAP_S)
                try:
                    fresh = self._connect()
                except OSError as conn_err:
                    last_err = conn_err
                    continue
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
                try:
                    resp = self._request(
                        {"type": "METRIC", "trial_id": sent_tid, "value": data["metric"],
                         "step": data["step"], "logs": data["logs"]}, heartbeat=True)
                except (ConnectionError, ValueError):
                    resp = {}
                if resp.get("type") == "STOP":
                    # Only stop the trial the beat was ABOUT: the runner may
                    # have rolled over to the next trial meanwhile.
                    reporter.early_stop(trial_id=sent_tid)
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
            resp = self._request({**payload, "type": "FINAL", "logs": data["logs"]})
            reporter.reset()
        if resp.get("type") == "TRIAL":
            self._piggyback = (resp["trial_id"], resp["params"], resp.get("info", {}))
        elif resp.get("type") == "GSTOP":
            self.done = True
        return resp

    def finalize_metric(self, metric, reporter) -> Dict[str, Any]:
        return self._finalize({"trial_id": reporter.trial_id, "value": metric}, reporter)

    def finalize_error(self, trial_id: str, reporter) -> Dict[str, Any]:
        """Report a failed trial (train_fn raised): FINAL with the error
        flag and no metric."""
        return self._finalize({"trial_id": trial_id, "value": None, "error": True},
                              reporter)

    def get_progress(self) -> Dict[str, Any]:
        return self._request({"type": "LOG"})

    def stop(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
        for sock in (self._sock, self._hb_sock):
            try:
                sock.close()
            except OSError:
                pass
