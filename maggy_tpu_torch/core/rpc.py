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
:116-162, :250-286, :295-437, :440-593). Distributed training's
`DistributedServer` (JAX `rpc.py:1618-1717`: REG with the coordinator
endpoint, the registration barrier, DIST_CONFIG and the heartbeat-loss scan
that fails the experiment) pairs with the client's ``register(host_port)``,
``await_reservations`` and ``get_dist_config``.

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

Remote runners and the registration barrier (JAX `rpc.py:443-452,
490-542, 727-738, 1833-1840`): with ``join_info`` published (``pool=
"remote"``) the JOIN verb hands a dialing agent the lowest free partition
id and the executor config; an explicit id reclaims a slot whose holder
went silent or was released, and a slot issued to a joiner that has not
registered yet stays taken for the liveness bound. QUERY answers whether
every slot registered (``Reservations.required``); the driver-side and the
client-side barrier waits poll it.

The shared fleet listener (JAX `rpc.py:767-1100`): ``SharedServer`` puts
many experiments' servers behind one socket. A frame routes to the server
whose secret authenticates it (an unbound connection tries every attached
secret, as the JAX package does, and binds to the first match); each tenant
has its own ``_TenantDispatcher`` thread, so one tenant's slow handler
never delays another's replies. A fleet preemption with eviction
(``request_evict``) releases the runner with GSTOP after its preempted
FINAL, or on its next GET when it is idle.

Gangs and elastic sizing (JAX `rpc.py:57, 196-232, 303-384, 1114,
1538-1612, 1955-2008`): the reservation table holds gang holds (a
conscripted runner is no free runner and gets no 1-chip work), the
one-shot member latch of a remote gang, a revocation STOP armed for a
healthy leader (``request_stop``, answered as a preempting STOP on its
next beat), and an elastic runner's capacity with its pending resize,
served on its next GET as ``RESIZE``. A REG carries the runner's
``host_port`` (a fleet agent's reserved rendezvous address) and its
``capacity``; a held member of a remote gang is served the gang trial
once as ``gang_role="member"``. The loop's tick also runs the driver's
``periodic_check`` (the resize watchdog and the gang member scan).

Fleet agents, the journal sink and heartbeat batching (JAX `rpc.py:679-699,
1102-1220, 1843-1907`): ``FleetAgentServer`` (AJOIN, ALEASE, ADONE, under the
fleet ticket's secret) hands leases to agent processes through the
attached ``fleet.agent.AgentPlane``; ``SinkServer`` (JSINK, under a secret of
its own) feeds the attached ``telemetry.sink.JournalSink``; both ride the
fleet's shared listener. A runner whose beats failed banks them, coalesced
per trial, and re-delivers them as one BATCH frame whose beats run through
the METRIC handler, the reply being the newest beat's.

Wire layout as in the JAX package: 4-byte big-endian length, 32-byte
HMAC-SHA256 of the payload under the experiment secret, payload. The payload
is JSON (the JAX package uses msgpack); every frame is a fixed-schema map of
declarative data — nothing on the wire is ever unpickled. The HMAC and the
server's frame scan run in the native codec (``maggy_tpu_torch/native``,
JAX `rpc.py:62-64, 617-635`), with a Python fallback where it is not built.
"""

from __future__ import annotations

import hmac
import json
import os
import queue
import random
import secrets as pysecrets
import selectors
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from maggy_tpu_torch import constants, native
from maggy_tpu_torch.chaos.injectors import ChaosKilled
from maggy_tpu_torch.chaos.injectors import active_engine as chaos_engine
from maggy_tpu_torch.exceptions import AuthenticationError
from maggy_tpu_torch.telemetry.metrics import MetricsRegistry
from maggy_tpu_torch.trial import Trial
from maggy_tpu_torch.util import json_default_numpy

#: The get_suggestion result that tells an elastic runner to exit for a
#: respawn at another size.
RESIZE = "__resize__"

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
    return native.hmac_sha256(secret, payload)


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

    def __init__(self, required: int = 0):
        #: Registrations the barrier waits for (``done``).
        self.required = required
        self.lock = threading.RLock()
        self._table: Dict[int, Dict[str, Any]] = {}  # guarded-by: lock
        # Evictions requested before the partition registered (a fleet
        # preemption racing a fresh lease's REG): applied at ``add`` so the
        # release is delivered, not lost.
        self._pending_evict: set = set()  # guarded-by: lock

    def add(self, meta: Dict[str, Any]) -> None:
        with self.lock:
            rec = dict(meta)
            # When this runner registered: a fleet lease tells its own
            # runner's record from the one its partition's last holder left.
            rec["last_beat"] = rec["registered_t"] = time.monotonic()
            pid = int(meta["partition_id"])
            if pid in self._pending_evict:
                self._pending_evict.discard(pid)
                rec["evict"] = True
            self._table[pid] = rec

    def done(self) -> bool:
        """The registration barrier: every required slot registered."""
        with self.lock:
            return len(self._table) >= self.required

    def remaining(self) -> int:
        with self.lock:
            return max(0, self.required - len(self._table))

    def request_evict(self, partition_id) -> None:
        """Fleet preemption: release this partition's runner (GSTOP) at its
        next reply, after its preempted FINAL or on its next GET when idle.
        A fresh registration of the slot builds a fresh record, which clears
        it; an unknown partition's eviction is parked until it registers
        (JAX `rpc.py:386-400`)."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is None:
                self._pending_evict.add(int(partition_id))
            else:
                rec["evict"] = True

    def evict_requested(self, partition_id) -> bool:
        with self.lock:
            rec = self._table.get(int(partition_id))
            return bool(rec and rec.get("evict"))

    def all_released(self) -> bool:
        with self.lock:
            return all(rec.get("released") for rec in self._table.values())

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

    def capacity(self, partition_id: int) -> Optional[int]:
        """The runner's advertised chip capacity (None = not elastic)."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            return rec.get("capacity") if rec else None

    def capacities(self) -> Dict[int, int]:
        """Count of live (registered, unreleased) runners by capacity."""
        with self.lock:
            out: Dict[int, int] = {}
            for rec in self._table.values():
                cap = rec.get("capacity")
                if cap is not None and not rec.get("released"):
                    out[cap] = out.get(cap, 0) + 1
            return out

    def request_resize(self, partition_id: int, chips: int) -> None:
        """Ask a runner to exit and respawn pinned to ``chips`` chips (0:
        retire); delivered on its next GET."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None:
                rec["resize"] = int(chips)

    def pop_resize(self, partition_id: int) -> Optional[int]:
        with self.lock:
            rec = self._table.get(int(partition_id))
            return rec.pop("resize", None) if rec is not None else None

    # ------------------------------------------------------------ gang holds

    def hold_for_gang(self, partition_id, trial_id: str) -> None:
        """Conscript the runner into a gang: while held it is not free (the
        driver hands it no 1-chip work) but it keeps heartbeating and
        idle-polling; its chip belongs to ``trial_id``'s block until the
        gang releases."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None:
                rec["gang"] = trial_id

    def gang_of(self, partition_id) -> Optional[str]:
        with self.lock:
            rec = self._table.get(int(partition_id))
            return rec.get("gang") if rec else None

    def release_gang(self, trial_id: str) -> list:
        """Free every member held for ``trial_id``; returns their ids."""
        with self.lock:
            freed = []
            for pid, rec in self._table.items():
                if rec.get("gang") == trial_id:
                    rec.pop("gang", None)
                    rec.pop("gang_served", None)
                    freed.append(pid)
            return freed

    def mark_gang_served(self, partition_id, trial_id: str) -> bool:
        """The one-shot delivery latch of a remote gang's member program:
        True the first time this held member is served ``trial_id``, False
        on every re-poll (cleared with the hold, so a reassembled gang
        serves its members again)."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is None or rec.get("gang") != trial_id or \
                    rec.get("gang_served") == trial_id:
                return False
            rec["gang_served"] = trial_id
            return True

    def gang_members(self, trial_id: str) -> list:
        with self.lock:
            return sorted(pid for pid, rec in self._table.items()
                          if rec.get("gang") == trial_id)

    def free_pids(self) -> list:
        """Runners free for new work: registered, unreleased, not evicted,
        holding no trial and held by no gang (the gang assembler's free
        set)."""
        with self.lock:
            return sorted(pid for pid, rec in self._table.items()
                          if not rec.get("released") and not rec.get("evict")
                          and rec.get("trial_id") is None and rec.get("gang") is None)

    def request_stop(self, partition_id, trial_id: str) -> None:
        """Gang revocation: arm a one-shot preempting STOP for the
        partition's next beat about ``trial_id``, aborting a healthy leader
        whose gang lost a member. The trial is already requeued, so the
        leader's preempt ack is dropped."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None:
                rec["stop_trial"] = trial_id

    def pop_stop(self, partition_id, trial_id) -> bool:
        """Consume an armed revocation STOP if it names ``trial_id``."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            if rec is not None and trial_id is not None and rec.get("stop_trial") == trial_id:
                rec.pop("stop_trial", None)
                return True
            return False

    def servable_trial(self, partition_id: int) -> Optional[str]:
        """The assignment a GET may hand out: none while a re-registration
        is held for the driver's BLACK path (``held``)."""
        with self.lock:
            rec = self._table.get(int(partition_id))
            return None if rec is None or rec.get("held") else rec.get("trial_id")

    # ------------------------------------------------------- crash recovery

    def restore(self, partition_id, trial_id: Optional[str] = None,
                capacity: Optional[int] = None, host_port: Optional[str] = None) -> None:
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
                                "capacity": capacity, "host_port": host_port,
                                "recovered": True,
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

    def __init__(self, secret: Optional[str] = None, num_executors: int = 0):
        # Telemetry facade (maggy_tpu_torch.telemetry.Telemetry), attached
        # by the driver. None = no TELEM verb, no verb timing.
        self.telemetry = None
        #: The experiment's partition-id range: the JOIN slots and the
        #: registration barrier's size.
        self.num_executors = int(num_executors)
        self.secret_hex = secret or pysecrets.token_hex(16)
        self.secret = self.secret_hex.encode()
        self.reservations = Reservations(self.num_executors)
        # Remote-runner admission: the driver publishes the executor config
        # here when its runners are agents that dial in; None refuses JOIN.
        self.join_info: Optional[Dict[str, Any]] = None
        self._join_lock = threading.Lock()
        # pid -> when JOIN issued it. A slot is taken while its issue is
        # fresher than the liveness bound or its holder registered; an
        # issued slot whose agent died before REG expires and is reclaimed.
        self._issued_pids: Dict[int, float] = {}  # guarded-by: _join_lock
        # Set while this server is published on a fleet's SharedServer:
        # frames arrive through the shared loop, and stop() detaches.
        self._shared: Optional["SharedServer"] = None
        self._buffers: Dict[socket.socket, bytearray] = {}
        self._sel = selectors.DefaultSelector()
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._handlers: Dict[str, Callable[[Dict[str, Any]], Dict[str, Any]]] = {}
        self._register_handlers()

    def _register_handlers(self) -> None:
        """Subclasses add their verbs."""
        self._handlers["QUERY"] = lambda msg: {"type": "QUERY",
                                               "done": self.reservations.done()}
        self._handlers["JOIN"] = self._join
        # rpc-ok: TELEM produced by monitor --telem via a generic send_msg
        self._handlers["TELEM"] = self._telem

    def _join(self, msg):
        """Admit a remote runner agent: a partition id and the executor
        config (JAX `rpc.py:490-542`). An explicit id (a restarted agent
        reclaiming its slot, whose REG then takes the BLACK path) is
        refused outside the experiment, while its holder is alive, and
        while it was just issued to another joiner (two agents on one pid
        would interleave GET and FINAL); otherwise the lowest slot neither
        registered nor freshly issued."""
        info = self.join_info
        if info is None:
            return {"type": "ERR", "error": "this experiment does not accept remote runners"}
        want = msg.get("partition_id")
        liveness = getattr(self, "hb_loss_timeout", None) or 10.0
        now = time.monotonic()
        with self._join_lock:
            if want is not None and int(want) >= 0:
                pid = int(want)
                if pid >= self.num_executors:
                    return {"type": "ERR",
                            "error": "partition_id {} out of range (experiment has {} "
                                     "slots)".format(pid, self.num_executors)}
                rec = self.reservations.get(pid)
                if rec is not None and not rec.get("released") and \
                        not self.reservations.is_silent(pid, liveness):
                    return {"type": "ERR", "error": "slot {} is held by a live runner".format(pid)}
                issued = self._issued_pids.get(pid)
                if issued is not None and now - issued < liveness:
                    return {"type": "ERR",
                            "error": "slot {} was just issued to another joining "
                                     "runner".format(pid)}
            else:
                taken = set(self.reservations.all()) | {
                    p for p, t in self._issued_pids.items() if now - t < liveness}
                pid = next((i for i in range(self.num_executors) if i not in taken), None)
                if pid is None:
                    return {"type": "ERR", "error": "experiment full"}
            self._issued_pids[pid] = now
        return {"type": "JOIN", "partition_id": pid, **info}

    def _telem(self, msg):
        """The telemetry snapshot: live metric registry and span-derived
        scheduling numbers, under the same per-message HMAC as every verb."""
        telem = self.telemetry
        if telem is None or not telem.enabled:
            return {"type": "ERR", "error": "telemetry is not enabled for this experiment"}
        return {"type": "TELEM", **telem.snapshot()}

    def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        # The codec's first build (g++, seconds) runs here, before the
        # event loop exists, not inside it while registrations queue up.
        native.get_lib()
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
        """Pop one complete authenticated frame from the buffer, or None.
        The scan and the HMAC check run in the native codec; an oversized
        frame (-1) or a MAC mismatch (-2) drops the connection."""
        result = native.frame_scan(buf, self.secret, MAX_FRAME)
        if result == 0:
            return None
        if result < 0:
            self._drop(conn)
            return None
        payload = bytes(buf[_HEADER:result])
        del buf[:result]
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

    def _batch(self, msg):
        """Coalesced heartbeats (JAX `rpc.py:679-699`): ``beats`` is an
        oldest-first list of METRIC payloads a runner banked while its beats
        failed. Each runs through the METRIC handler (liveness, rstats,
        metric history), and the reply is the newest beat's: a STOP about a
        retired beat's trial is stale, and beats re-draw STOP until it is
        honored."""
        metric = self._handlers.get("METRIC")
        if metric is None:
            return {"type": "ERR", "error": "this server does not accept heartbeats"}
        reply: Dict[str, Any] = {"type": "OK"}
        for beat in msg.get("beats") or []:
            reply = metric({**beat, "type": "METRIC",
                            "partition_id": msg["partition_id"]})
        return reply

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

    def await_reservations(self, timeout: float = constants.REGISTRATION_TIMEOUT_S,
                           on_timeout: Optional[Callable[[], None]] = None
                           ) -> Dict[int, Dict[str, Any]]:
        """The driver-side registration barrier (JAX `rpc.py:727-744`):
        block until every slot registered; a timeout calls ``on_timeout``
        and raises."""
        deadline = time.monotonic() + timeout
        while not self.reservations.done():
            if time.monotonic() > deadline:
                if on_timeout:
                    on_timeout()
                raise TimeoutError(
                    "Registration barrier timed out: {} of {} executors missing.".format(
                        self.reservations.remaining(), self.num_executors))
            time.sleep(0.1)
        return self.reservations.all()

    def stop(self):
        if self._shared is not None:
            # Published on a fleet's shared listener: detach this
            # experiment's routing; the shared socket outlives it.
            self._shared.detach(self)
            self._shared = None
            self._sel.close()
            return
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

    def __init__(self, secret: Optional[str] = None, num_executors: int = 0):
        self.driver = None
        # partition -> when its last FINAL arrived, until its next TRIAL
        # leaves (the hand-off gap); touched only on the server thread.
        self._final_at: Dict[int, float] = {}
        # Seconds of silence after which a partition holding a trial is
        # declared lost (set by the driver); None disables the scan.
        self.hb_loss_timeout: Optional[float] = None
        self._last_loss_scan = time.monotonic()
        super().__init__(secret, num_executors)

    def attach_driver(self, driver) -> None:
        self.driver = driver

    def _register_handlers(self) -> None:
        super()._register_handlers()
        self._handlers.update(REG=self._reg, METRIC=self._metric, BATCH=self._batch,
                              FINAL=self._final, GET=self._get, LOG=self._log)

    def _tick(self) -> None:
        """The heartbeat-loss scan, at most every min(1 s, timeout / 4):
        each silent partition holding a trial loses its assignment first
        (so its late FINAL clears nothing), then the driver gets LOST
        (``maggy_tpu/core/rpc.py:1260-1286``)."""
        if self.driver is None:
            return
        now = time.monotonic()
        gate = min(1.0, self.hb_loss_timeout / 4) if self.hb_loss_timeout is not None else 1.0
        if now - self._last_loss_scan < gate:
            return
        self._last_loss_scan = now
        check = getattr(self.driver, "periodic_check", None)
        if check is not None:
            try:
                check()
            except Exception:  # noqa: BLE001 - never kill the event loop
                import traceback

                traceback.print_exc()
        if self.hb_loss_timeout is None:
            return
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
                               "host_port": msg.get("host_port"),
                               "capacity": msg.get("capacity"), "held": prev is not None})
        if prev is not None:
            self.driver.enqueue({"type": "BLACK", "trial_id": prev, "partition_id": pid})
        else:
            self.driver.enqueue({"type": "REG", "partition_id": pid,
                                 "capacity": msg.get("capacity")})
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
        # A revocation STOP is answered to a beat that carries a metric:
        # the leader's reporter arms a stop only once it has one.
        has_value = msg.get("value") is not None or bool(msg.get("lanes"))
        assigned = self.reservations.get_assigned_trial(pid)
        if trial_id is not None and assigned != trial_id and (
                assigned is None or self.driver.block_leader(trial_id) != assigned):
            # A runner declared lost keeps beating if it was only slow: its
            # metric must not enter the history of the trial's re-run (a
            # lane of a block the partition holds is its own).
            msg = {k: v for k, v in msg.items() if k != "lanes"}
            msg["value"] = None
        self.driver.enqueue(dict(msg))
        if trial_id and has_value and self.reservations.pop_stop(pid, trial_id):
            # A gang revocation's abort: preempt-shaped, so the leader acks
            # and frees itself; the driver already requeued the trial.
            return {"type": "STOP", "span": msg.get("span"), "preempt": True}
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
            # The reply echoes the span, so the runner side can attribute
            # the abort without re-deriving it.
            return {"type": "STOP", "span": msg.get("span"), "preempt": trial.get_preempt()}
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
            return {"type": "STOP", "span": msg.get("span"), "preempt": True}
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
            if msg.get("preempted") and self.reservations.evict_requested(pid):
                # An evicted runner's preempt ack on the worker path: the
                # queued message requeues the trial, and the runner leaves
                # now instead of GET-polling an experiment it was preempted
                # out of (JAX `rpc.py:1436-1446`).
                self._release(pid)
                return {"type": "GSTOP"}
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
        if self.reservations.evict_requested(pid):
            # A fleet preemption: the ack doubles as the runner's release;
            # it re-binds to another experiment.
            self._release(pid)
            return {"type": "GSTOP"}
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
        pid = msg["partition_id"]
        if self.reservations.evict_requested(pid):
            # A fleet preemption of an idle runner: an undelivered
            # assignment goes back to the schedule as a never-started
            # preemption (from scratch), and the runner is released to
            # re-bind elsewhere (JAX `rpc.py:1537-1552`).
            tid = self.reservations.get_assigned_trial(pid)
            if tid is not None:
                self.reservations.clear_trial_if(pid, tid)
                self.driver.enqueue({"type": "FINAL", "trial_id": tid, "partition_id": pid,
                                     "preempted": True, "step": None, "logs": []})
            self._release(pid)
            return {"type": "GSTOP"}
        # Serve an already-assigned trial BEFORE honoring experiment-done:
        # the last suggestion may be assigned concurrently with another
        # FINAL ending the experiment, and must still run.
        reply = self._serve_assigned(msg["partition_id"])
        if reply is not None:
            return reply
        member = self._serve_gang_member(pid)
        if member is not None:
            return member
        if self.driver.experiment_done:
            self._release(msg["partition_id"])
            return {"type": "GSTOP"}
        resize = self.reservations.pop_resize(pid)
        if resize is not None:
            # The runner exits and its pool respawns it pinned to ``chips``
            # chips; released here, so the loss scan ignores the gap until
            # it registers again.
            self._release(pid)
            return {"type": "RESIZE", "chips": resize}
        return {"type": "OK", "trial_id": None}

    def _serve_gang_member(self, partition_id):
        """A remote gang's member delivery (JAX `rpc.py:1576-1612`): a held
        member whose gang carries a ``rendezvous`` block lives in another
        process and must run the program itself, or the leader's
        collectives hang. It is served the gang trial once an assembly,
        flagged ``gang_role="member"``: the executor joins the world, runs
        the program, discards the result and never finalizes. Members of an
        in-process gang never get here: the leader's ranks do their work."""
        res = self.reservations
        tid = res.gang_of(partition_id)
        if tid is None or res.get_assigned_trial(partition_id) == tid:
            return None
        gang_info = getattr(self.driver, "gang_info", None)
        info_g = gang_info(tid) if gang_info is not None else None
        if not info_g or not info_g.get("rendezvous"):
            return None
        if int(partition_id) == int(info_g.get("leader", -1)):
            # The assembly window: the leader waits for its own assignment.
            return None
        if not res.mark_gang_served(partition_id, tid):
            return None
        trial = self.driver.get_trial(tid)
        if trial is None:
            return None
        with trial.lock:
            info = dict(trial.info_dict)
        info["partition"] = int(partition_id)
        info["gang_role"] = "member"
        return {"type": "TRIAL", "trial_id": trial.trial_id, "params": trial.params,
                "info": info}

    def _log(self, msg):
        return {"type": "LOG", **self.driver.progress_snapshot()}



# ---------------------------------------------------------------- shared


class DistributedServer(Server):
    """The distributed-training verbs (``maggy_tpu/core/rpc.py:1618-1717``):
    REG carries the worker's coordinator endpoint, QUERY is the
    registration barrier, and DIST_CONFIG returns partition 0's endpoint
    and the world size once every worker registered (the reference's
    TORCH_CONFIG MASTER_ADDR/PORT brokering, `rpc.py:391-437`). Worker 0
    hosts the rendezvous store that ``torch.distributed`` joins there.
    ``_tick``'s heartbeat-loss scan declares a silent worker dead: a dead
    rank wedges every collective in the world, so the driver fails the
    experiment instead of waiting."""

    def __init__(self, num_executors: int, secret: Optional[str] = None):
        self.driver = None
        self.hb_loss_timeout: Optional[float] = None
        self._last_loss_scan = time.monotonic()
        super().__init__(secret, num_executors)

    def attach_driver(self, driver) -> None:
        self.driver = driver

    def _register_handlers(self) -> None:
        super()._register_handlers()
        self._handlers.update(REG=self._reg, METRIC=self._metric, BATCH=self._batch,
                              FINAL=self._final, DIST_CONFIG=self._dist_config, LOG=self._log)

    def _reg(self, msg):
        self.reservations.add({"partition_id": msg["partition_id"],
                               "host_port": msg.get("host_port"), "trial_id": None})
        if self.telemetry is not None:
            self.telemetry.event("worker", phase="registered",
                                 partition=int(msg["partition_id"]))
        return {"type": "OK"}

    def _metric(self, msg):
        self.reservations.touch(msg["partition_id"])
        rstats = msg.pop("rstats", None)
        if rstats and self.telemetry is not None:
            self.telemetry.record_runner_stats(msg["partition_id"], rstats)
        if self.driver is not None:
            self.driver.enqueue(dict(msg))
        return {"type": "OK"}

    def _final(self, msg):
        # FINAL is a worker's last message: its slot is released here.
        self.reservations.touch(msg["partition_id"])
        self.reservations.mark_released(msg["partition_id"])
        if self.driver is not None:
            self.driver.enqueue(dict(msg))
        telem = self.telemetry
        if telem is not None:
            # The worker-measured rendezvous latency rides the FINAL; the
            # event carries it too, so a replay of the journal reads it.
            rendezvous_ms = (msg.get("telem") or {}).get("rendezvous_ms")
            telem.event("worker", phase="finalized", partition=int(msg["partition_id"]),
                        error=bool(msg.get("error")), rendezvous_ms=rendezvous_ms)
            if rendezvous_ms is not None:
                telem.observe_ms("dist.rendezvous_ms", float(rendezvous_ms))
        return {"type": "OK"}

    def _tick(self) -> None:
        """A worker whose heartbeats stopped is dead: DEAD_WORKER to the
        driver, at most every min(1 s, timeout / 4)."""
        if self.hb_loss_timeout is None or self.driver is None:
            return
        now = time.monotonic()
        if now - self._last_loss_scan < min(1.0, self.hb_loss_timeout / 4):
            return
        self._last_loss_scan = now
        for pid in self.reservations.silent(self.hb_loss_timeout):
            self.reservations.mark_released(pid)
            self.driver.enqueue({"type": "DEAD_WORKER", "partition_id": pid})

    def _dist_config(self, msg):
        rec = self.reservations.get(0)
        if rec is None or not self.reservations.done():
            return {"type": "OK", "config": None}
        return {"type": "DIST_CONFIG",
                "config": {"coordinator_address": rec["host_port"],
                           "num_processes": self.num_executors}}

    def _log(self, msg):
        snap = self.driver.progress_snapshot() if self.driver else {}
        return {"type": "LOG", **snap}


class _TenantDispatcher:
    """One tenant's handler thread on a shared listener: a bounded FIFO of
    (conn, payload) frames drained by one daemon worker (JAX `rpc.py:
    767-811`). One worker keeps a connection's frames handled and replied
    in arrival order, as a listener of its own would, and keeps the
    tenant's handler time off every other tenant. ``submit`` never blocks:
    a full queue returns False and the caller sheds the frame."""

    def __init__(self, shared: "SharedServer", server: Server, depth: int):
        self.depth = int(depth)
        self._shared = shared
        self._server = server
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rpc-dispatch-{}".format(server.secret_hex[:8]))
        self._thread.start()

    def submit(self, conn, payload: bytes) -> bool:
        try:
            self._q.put_nowait((conn, payload))
            return True
        except queue.Full:
            return False

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                conn, payload = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._shared._dispatch(conn, self._server, payload)
            except Exception:  # noqa: BLE001 - one bad frame must not end the tenant's worker
                pass


class SharedServer:
    """One listening socket for many experiments' control planes (the
    fleet; JAX `rpc.py:814-1100`). Each attached ``Server`` keeps its
    handlers, reservations and secret; a frame goes to the server whose
    secret authenticates it, and the connection binds to that server at its
    first authenticated frame, so later frames are checked against one
    secret. A runner re-binding to another experiment reconnects to the
    same address with the other experiment's secret.

    The event loop only accepts, reassembles and routes; each tenant's
    ``_TenantDispatcher`` runs its handlers and replies, so one tenant's
    slow handler stalls its own queue only. A frame for a tenant whose
    queue is full is shed with its connection (``rpc.tenant.
    backpressure_drops`` and a ``shed`` event with ``scope="rpc"``), and
    the client's retry re-delivers it. The JAX package's loop-dispatch
    path (``dispatch_pool=False``, an A/B for its scale bench) is not
    ported: every tenant gets its dispatcher. The loop also drives each attached server's ``_tick`` (its heartbeat-
    loss scan) and the chaos engine's elapsed-time triggers."""

    def __init__(self, tenant_queue_depth: Optional[int] = None):
        self.tenant_queue_depth = int(
            tenant_queue_depth if tenant_queue_depth is not None
            else os.environ.get("MAGGY_TPU_TENANT_QUEUE_DEPTH",
                                constants.TENANT_DISPATCH_QUEUE_DEPTH))
        self._lock = threading.RLock()
        self._servers: Dict[bytes, Server] = {}  # guarded-by: _lock
        self._dispatchers: Dict[bytes, _TenantDispatcher] = {}  # guarded-by: _lock
        self._conn_server: Dict[socket.socket, Server] = {}  # guarded-by: _lock
        self._buffers: Dict[socket.socket, bytearray] = {}  # guarded-by: _lock
        self._sel = selectors.DefaultSelector()
        self._listener: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self.addr: Optional[Tuple[str, int]] = None

    def attach(self, server: Server, host: str = "127.0.0.1") -> Tuple[str, int]:
        """Publish ``server`` on the shared listener (started at the first
        attach); returns the shared (host, port)."""
        with self._lock:
            self._servers[server.secret] = server
            self._dispatchers[server.secret] = _TenantDispatcher(
                self, server, self.tenant_queue_depth)
            server._shared = self
            if self._listener is None:
                self._start_locked(host)
        return self.addr

    def detach(self, server: Server) -> None:
        with self._lock:
            self._servers.pop(server.secret, None)
            dispatcher = self._dispatchers.pop(server.secret, None)
            stale = [c for c, s in self._conn_server.items() if s is server]
        for conn in stale:
            self._drop(conn)
        if dispatcher is not None:
            dispatcher.stop()

    # locked-by: _lock
    def _start_locked(self, host: str, port: int = 0) -> None:
        native.get_lib()  # the codec's first build, off the event loop
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(128)
        srv.setblocking(False)
        self._listener = srv
        self.addr = srv.getsockname()
        self._sel.register(srv, selectors.EVENT_READ, self._accept)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rpc-shared-server")
        self._thread.start()

    def _accept(self, sock, mask):
        conn, _ = sock.accept()
        conn.setblocking(False)
        with self._lock:
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
        with self._lock:
            buf = self._buffers.get(conn)
        if buf is None:
            return
        buf.extend(chunk)
        # Stop at the first drop: frames left in the buffer of a closed
        # connection must not be dispatched, nor re-bind it.
        while self._tracked(conn):
            extracted = self._try_extract_frame(conn, buf)
            if extracted is None:
                return
            self._route(conn, *extracted)

    def _tracked(self, conn) -> bool:
        with self._lock:
            return conn in self._buffers

    def _try_extract_frame(self, conn, buf: bytearray):
        """(server, payload) of one complete frame, or None. A bound
        connection verifies against its server's secret only; an unbound
        one tries every attached secret and binds to the first match; no
        match is an unauthenticated peer, and its connection drops."""
        if len(buf) < _HEADER:
            return None
        (length,) = _LEN.unpack(bytes(buf[:4]))
        if length > MAX_FRAME:
            self._drop(conn)
            return None
        if len(buf) < _HEADER + length:
            return None
        mac = bytes(buf[4:_HEADER])
        payload = bytes(buf[_HEADER:_HEADER + length])
        with self._lock:
            bound = self._conn_server.get(conn)
            candidates = [bound] if bound is not None else list(self._servers.values())
        server = next((s for s in candidates
                       if native.digest_eq(mac, _sign(s.secret, payload))), None)
        if server is None:
            self._drop(conn)
            return None
        if bound is None:
            with self._lock:
                # Bind only a connection still tracked: a concurrent drop
                # must not come back as a routing entry of a closed socket.
                if conn not in self._buffers:
                    return None
                self._conn_server[conn] = server
        del buf[:_HEADER + length]
        return server, payload

    def _route(self, conn, server: Server, payload: bytes) -> None:
        """Hand one authenticated frame to its tenant's dispatcher; a frame
        for a tenant detached meanwhile drops its connection."""
        with self._lock:
            dispatcher = self._dispatchers.get(server.secret)
        if dispatcher is None:
            self._drop(conn)
            return
        if not dispatcher.submit(conn, payload):
            telem = server.telemetry
            if telem is not None:
                telem.metrics.counter("rpc.tenant.backpressure_drops").inc()
                telem.event("shed", scope="rpc", queue_depth=dispatcher.depth)
            self._drop(conn)

    def _dispatch(self, conn, server: Server, payload: bytes):
        """``Server._dispatch`` with the target server resolved per frame:
        the same chaos hooks, the reply signed with that server's secret."""
        sever_reply = False
        try:
            msg = json.loads(payload)
            engine = chaos_engine()
            if engine is not None:
                action = engine.on_server_message(msg)
                if action is not None:
                    if action[0] == "drop":
                        self._drop(conn)
                        return
                    if action[0] == "delay":
                        time.sleep(action[1])
                    elif action[0] == "sever":
                        sever_reply = True
            resp = server.handle_message(msg)
        except Exception as e:  # noqa: BLE001 - a bad message must never kill the loop
            resp = {"type": "ERR", "error": "handler error: {!r}".format(e)}
        if sever_reply:
            self._drop(conn)
            return
        try:
            conn.setblocking(True)
            MessageSocket.send_msg(conn, resp, server.secret)
        except OSError:
            self._drop(conn)
        finally:
            try:
                conn.setblocking(False)
            except OSError:
                pass

    def _drop(self, conn):
        """Tear down one connection; called from the loop and from the
        dispatcher threads, so every table is touched under the lock and a
        double drop is harmless."""
        with self._lock:
            self._buffers.pop(conn, None)
            self._conn_server.pop(conn, None)
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
            with self._lock:
                servers = list(self._servers.values())
            for server in servers:
                try:
                    server._tick()
                except Exception:  # noqa: BLE001 - one tenant's tick must not end the loop
                    pass
            engine = chaos_engine()
            if engine is not None:
                engine.tick()

    def stop(self):
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._lock:
            servers = list(self._servers.values())
            self._servers.clear()
            dispatchers = list(self._dispatchers.values())
            self._dispatchers.clear()
        for dispatcher in dispatchers:
            dispatcher.stop()
        for server in servers:
            server._shared = None
        for key in list(self._sel.get_map().values()):
            self._drop(key.fileobj)
        self._sel.close()


# --------------------------------------------------------------------- client


class FleetAgentServer(Server):
    """The fleet host's control plane for agent processes (``python -m
    maggy_tpu_torch.fleet agent``), published on the fleet's shared listener
    under the fleet ticket's secret (JAX `rpc.py:1102-1176`):

    - ``AJOIN``: an agent declares its host, chips, process index and OS pid
      and is admitted into an agent slot; the reply carries its ``agent`` id,
      the poll cadence and the liveness bound.
    - ``ALEASE``: the agent's idle poll and idle heartbeat. Replies ``ABIND``
      (a lease: the experiment's secret, partition id, executor config and
      the train function's ``module:function`` path), ``OK`` (nothing to do)
      or ``AGSTOP`` (the fleet is shutting down).
    - ``ADONE``: the agent's executor loop returned; the lease closes and the
      agent goes back to the idle pool.

    The handlers delegate to the attached ``fleet.agent.AgentPlane``."""

    def __init__(self, max_agents: int, secret: Optional[str] = None):
        # The plane, attached by the fleet; None rejects every agent verb.
        self.agent_plane = None
        super().__init__(secret, max_agents)

    def attach_plane(self, plane) -> None:
        self.agent_plane = plane

    def _register_handlers(self) -> None:
        super()._register_handlers()
        self._handlers.update(AJOIN=self._ajoin, ALEASE=self._alease, ADONE=self._adone)

    def _no_plane(self):
        return {"type": "ERR", "error": "this fleet does not accept remote agents"}

    def _ajoin(self, msg):
        plane = self.agent_plane
        if plane is None:
            return self._no_plane()
        return plane.agent_join(host=msg.get("host"), chips=msg.get("chips"),
                                process_index=msg.get("process_index"),
                                coord_addr=msg.get("coord_addr"),
                                os_pid=msg.get("os_pid"), agent=msg.get("agent"))

    def _alease(self, msg):
        plane = self.agent_plane
        if plane is None:
            return self._no_plane()
        return plane.agent_lease(agent=msg.get("agent"), offset_s=msg.get("offset_s"),
                                 rtt_s=msg.get("rtt_s"))

    def _adone(self, msg):
        plane = self.agent_plane
        if plane is None:
            return self._no_plane()
        return plane.agent_done(agent=msg.get("agent"), error=msg.get("error"))


class SinkServer(Server):
    """The fleet host's journal-sink tenant (``telemetry/sink.py``, JAX
    `rpc.py:1178-1220`), published on the shared listener under its own
    secret, so a journal shipper can neither lease agents nor speak to any
    experiment. One verb, ``JSINK``: a batch of one source's journal events,
    each stamped with the source's monotonic ``sid``, and an optional
    counter snapshot; the reply acks the highest sid the sink holds.
    Batches land on this tenant's own dispatch thread, so ingestion never
    delays an experiment's control traffic, and a full queue sheds frames,
    which the shipper treats as a dead sink."""

    def __init__(self, secret: Optional[str] = None):
        # The sink service (telemetry.sink.JournalSink), attached by the
        # fleet; None rejects JSINK.
        self.sink = None
        super().__init__(secret, 1)

    def attach_sink(self, sink) -> None:
        self.sink = sink

    def _register_handlers(self) -> None:
        super()._register_handlers()
        self._handlers.update(JSINK=self._jsink)

    def _jsink(self, msg):
        sink = self.sink
        if sink is None:
            return {"type": "ERR", "error": "this fleet has no journal sink attached"}
        return sink.ingest(source=msg.get("source"), events=msg.get("events"),
                           counters=msg.get("counters"), client_t=msg.get("client_t"))


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

    def register(self, host_port: Optional[str] = None,
                 capacity: Optional[int] = None) -> None:
        """REG; a distributed worker or a fleet agent advertises its
        coordinator endpoint, an elastic runner the chips it is pinned to."""
        msg = {"type": "REG"}
        if host_port is not None:
            msg["host_port"] = host_port
        if capacity is not None:
            msg["capacity"] = int(capacity)
        self._request(msg)

    def await_reservations(self, timeout: float = constants.REGISTRATION_TIMEOUT_S) -> None:
        """The runner-side registration barrier (JAX `rpc.py:1833-1840`):
        poll QUERY until every slot registered."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._request({"type": "QUERY"}).get("done"):
                return
            time.sleep(constants.CLIENT_POLL_INTERVAL_S)
        raise TimeoutError("Registration barrier not reached.")

    @staticmethod
    def _queue_beat(pending: list, payload: Dict[str, Any]) -> None:
        """Bank a failed beat for BATCH re-delivery (JAX `rpc.py:1843-1864`):
        coalesce with the newest banked beat of the same trial (the fresher
        metric, step and span; the logs concatenated, newest last, capped at
        CLIENT_MAX_PENDING_LOG_LINES), and keep at most
        CLIENT_MAX_PENDING_BEATS, dropping the oldest. ``rstats`` is stripped:
        that delta requeues through the runner-stats buffer."""
        beat = {k: v for k, v in payload.items() if k != "rstats"}
        if pending and pending[-1].get("trial_id") == beat.get("trial_id"):
            beat["logs"] = ((pending[-1].get("logs") or []) + (beat.get("logs") or []))[
                -constants.CLIENT_MAX_PENDING_LOG_LINES:]
            pending[-1] = beat
            return
        pending.append(beat)
        del pending[:-constants.CLIENT_MAX_PENDING_BEATS]

    def start_heartbeat(self, reporter) -> None:
        def beat():
            # Beats whose ship failed, oldest first: re-delivered as one
            # BATCH frame with the next beat, which rides last so the reply
            # is about the newest data.
            pending: list = []
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
                send = {"type": "BATCH", "beats": pending + [payload]} if pending else payload
                t_send = time.monotonic()
                try:
                    resp = self._request(send, heartbeat=True)
                    if pending:
                        CLIENT_METRICS.counter("rpc.client.batched_beats").inc(len(pending))
                        pending = []
                    if stats is not None:
                        # Retries and backoff included: the control-plane
                        # latency the runner experiences.
                        stats.observe_hb_rtt((time.monotonic() - t_send) * 1e3)
                except (ConnectionError, ValueError) as e:
                    resp = {}
                    if delta:
                        # Re-send on the next beat instead of losing it.
                        stats.requeue_delta(delta)
                    if isinstance(e, ConnectionError):
                        self._queue_beat(pending, payload)
                    else:
                        # Too large a frame: the bank can never ship.
                        pending = []
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
            if resp.get("type") == "RESIZE":
                # An elastic runner exits to be respawned pinned to
                # resp["chips"] chips (pinning precedes CUDA init).
                self.done = True
                return RESIZE, {"chips": resp["chips"]}
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
        payload = {"type": "FINAL", "trial_id": trial_id,
                   "value": None if error else metric, "epoch": epoch,
                   "lane": int(lane), "block": block, "last": bool(last)}
        if error:
            payload["error"] = True
        if last:
            return self._finalize(payload, reporter)
        return self._request({**payload, "logs": []})

    def _bank(self, resp: Dict[str, Any]) -> None:
        if resp.get("type") == "TRIAL":
            self._piggyback = (resp["trial_id"], resp["params"], resp.get("info", {}))
        elif resp.get("type") == "GSTOP":
            self.done = True

    def finalize_metric(self, metric, reporter,
                        extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """FINAL with the metric; ``extra`` adds payload fields (a
        distributed worker's rendezvous time)."""
        return self._finalize({"trial_id": reporter.trial_id, "value": metric, **(extra or {})},
                              reporter)

    def get_dist_config(self, timeout: float = constants.RENDEZVOUS_TIMEOUT_S) -> Dict[str, Any]:
        """Poll DIST_CONFIG until the server has every registration (JAX
        `rpc.py:2013-2031`): from CLIENT_GET_POLL_MIN_S, doubling up to
        CLIENT_DIST_CONFIG_POLL_MAX_S."""
        deadline = time.monotonic() + timeout
        delay = constants.CLIENT_GET_POLL_MIN_S
        while time.monotonic() < deadline:
            resp = self._request({"type": "DIST_CONFIG"})
            if resp.get("config"):
                return resp["config"]
            time.sleep(delay)
            delay = min(delay * 2, constants.CLIENT_DIST_CONFIG_POLL_MAX_S)
        raise TimeoutError("Coordinator rendezvous timed out.")

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
