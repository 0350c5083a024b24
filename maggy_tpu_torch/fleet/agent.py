"""Fleet agents: one persistent fleet across processes.

The port's copy of ``maggy_tpu/fleet/agent.py``. An **agent** is a
long-lived process started apart (``python -m maggy_tpu_torch.fleet agent
--ticket <home>/agent_ticket.json``) that reads the **fleet ticket**
(address and fleet secret), declares its capacity, and JOINs the fleet's
``SharedServer`` socket. The ``FleetScheduler`` then leases, preempts and
re-binds it across experiments as it does a thread runner:

- an ``ABIND`` reply ships the experiment's secret and the train
  function's ``module:function`` path (the agent imports it; only
  declarative data crosses the wire);
- a release (GSTOP or eviction) returns the agent to the idle pool, and its
  next ``ALEASE`` poll may bind it to another experiment on the same
  socket in the same process, so its warm slots (``train/warm.py``)
  survive same-family re-leases;
- an agent that dies mid-lease is caught twice: the experiment's own
  heartbeat-loss scan (``core/rpc.py``) requeues its trial exactly once,
  and the agent's proxy here revokes the lease (``lease`` end
  ``reason=agent_lost``, ``agent`` phase ``lost``), so the runner slot
  frees; chaos invariant 11 holds both halves.

Fleet side, ``AgentPlane``: the registry plus one proxy thread an agent,
which pulls bindings through the scheduler's ``next_binding`` (as thread
runners do), delivers them as pending ``ABIND`` replies and watches the
lease. Agent side, ``FleetAgent``: join, poll, run ``TrialExecutor``
against the leased experiment's secret, ``ADONE``, repeat.

An agent runs its trials on one device, ``--device`` (default ``cuda``): it
refuses to start when no card is visible, and ``--device cpu`` hides every
card from the process, the port's counterpart of the JAX package's
``JAX_PLATFORMS=cpu`` agents. Train functions read it with
``trial_device()``.

Remote gangs (JAX `agent.py:126-138, 150-157, 253-274, 589-636, 851`): an
agent reserves its rendezvous address at start (``reserve_coord_addr``
binds the store that a gang world led by this agent is served from, so it
listens before it is advertised), sends it at AJOIN as ``coord_addr`` and
registers with it as its REG's ``host_port``: a gang whose members are all
agents then gets a rendezvous block, and its members join one
``torch.distributed`` world (``gang.GangContext.ensure_rendezvous``).

Wire contract (``core/rpc.py``'s ``FleetAgentServer``): ``AJOIN {host,
chips, process_index, os_pid, agent}`` -> ``{agent, poll_s, liveness_s,
server_t}``; ``ALEASE {agent, offset_s?, rtt_s?}`` -> ``ABIND {exp,
partition_id, secret, hb_interval, exp_dir, optimization_key, trial_type,
warm_start, train_fn, family}`` | ``OK`` | ``AGSTOP``; ``ADONE {agent,
error}`` -> ``OK``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: The variable an agent process publishes its trial device in.
DEVICE_ENV = "MAGGY_TPU_TORCH_DEVICE"

#: Fleet-ticket filename inside the fleet home dir.
AGENT_TICKET_NAME = "agent_ticket.json"

#: Default idle-poll cadence the AJOIN reply hands the agent.
DEFAULT_POLL_S = 0.2

#: Default silence bound after which an agent is declared lost. Idle
#: agents are measured on their ALEASE polls; leased agents on the
#: target experiment's own heartbeat-loss bound (slot-reclaim liveness).
DEFAULT_LIVENESS_S = 10.0

#: How long a delivered lease may sit without the agent's REG arriving
#: at the experiment server (relative to the liveness bound) before the
#: proxy concludes the agent died between ABIND and REG.
_REG_GRACE_FACTOR = 1.5

#: Grace for the agent's ADONE after its partition was released (GSTOP
#: observed): the done message normally lands within one poll.
_DONE_GRACE_S = 10.0


def train_fn_path(fn) -> Optional[str]:
    """Dotted ``module:function`` path for a MODULE-LEVEL callable, or
    None when the callable cannot be named on the wire (lambda, closure,
    method, ``__main__``) — such experiments lease thread runners only;
    agents are never offered them."""
    import sys

    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    if not mod or not qual or mod == "__main__" \
            or "<" in qual or "." in qual:
        return None
    module = sys.modules.get(mod)
    if module is None or getattr(module, qual, None) is not fn:
        return None
    return "{}:{}".format(mod, qual)


def write_fleet_ticket(env, path: str, host: str, port: int, secret: str,
                       fleet: str, max_agents: int,
                       sink: Optional[str] = None) -> Dict[str, Any]:
    ticket = {"host": host, "port": int(port), "secret": secret,
              "fleet": fleet, "max_agents": int(max_agents)}
    if sink:
        # The journal-sink tenant's secret (telemetry/sink.py): agents
        # ship their own journals + counters to the fleet through it.
        # Absent for sink-less fleets — agents then journal locally only.
        ticket["sink"] = sink
    env.dump(json.dumps(ticket, indent=2), path)
    return ticket


def read_fleet_ticket(path: str, wait_s: float = 0.0) -> Dict[str, Any]:
    """Load the fleet ticket, optionally waiting for it to appear (the
    fleet host writes it at start). Validates before use: the writer may
    not be atomic on a shared fs, so a partial read retries."""
    deadline = time.monotonic() + wait_s
    while True:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    ticket = json.load(f)
                ticket["host"], ticket["port"], ticket["secret"]
                return ticket
            except (json.JSONDecodeError, KeyError, OSError):
                pass
        if time.monotonic() >= deadline:
            raise FileNotFoundError("No fleet ticket at {}".format(path))
        time.sleep(0.5)


def reserve_coord_addr(host: str = "127.0.0.1") -> str:
    """Reserve this process's gang rendezvous address: bind a
    ``torch.distributed.TCPStore`` on an ephemeral port of ``host`` and keep
    it (``gang.set_coord_store``). A gang world whose rank 0 is this
    process is served from that store, so the address listens from the
    moment it is advertised (the JAX package binds a port, releases it and
    lets ``jax.distributed`` re-bind it)."""
    from datetime import timedelta

    import torch.distributed as dist

    from maggy_tpu_torch import gang

    store = dist.TCPStore(host, 0, 1, is_master=True, timeout=timedelta(seconds=120),
                          wait_for_workers=False)
    gang.set_coord_store(store)
    return "{}:{}".format(host, store.port)


# ----------------------------------------------------------- fleet side


class AgentRecord:  # guarded-by: AgentPlane._lock
    """One joined agent's registry state. All mutable fields are guarded
    by the plane's lock (class-line annotation: externally
    synchronized)."""

    def __init__(self, agent_id: str, runner: int, host: str, chips: int,
                 process_index: int, os_pid: Optional[int],
                 coord_addr: Optional[str] = None):
        self.agent_id = agent_id
        self.runner = runner
        self.host = host
        self.chips = chips
        self.process_index = process_index
        self.coord_addr = coord_addr
        self.os_pid = os_pid
        self.joined_t = time.time()
        self.last_beat = time.monotonic()
        self.state = "idle"  # idle | leased | lost | left
        # Pending lease: the next ALEASE poll delivers it as ABIND.
        self.pending: Optional[Dict[str, Any]] = None
        self.pending_set_t = 0.0
        self.delivered = False
        self.delivered_t = 0.0
        self.abind_ms: Optional[float] = None
        # Current lease identity (exp name, pid) while leased.
        self.lease: Optional[Tuple[str, int]] = None
        self.done = False
        self.done_error: Optional[str] = None
        self.leases_served = 0
        # Whether a poll was answered AGSTOP since the fleet stopped.
        self.stop_delivered = False

    def snapshot(self) -> Dict[str, Any]:
        return {"agent": self.agent_id, "runner": self.runner,
                "host": self.host, "chips": self.chips,
                "process_index": self.process_index,
                "state": self.state,
                "lease": self.lease[0] if self.lease else None,
                "pid": self.lease[1] if self.lease else None,
                "leases": self.leases_served,
                "last_beat_age_s": round(
                    time.monotonic() - self.last_beat, 2),
                "joined_t": self.joined_t}


class AgentPlane:
    """Fleet-side agent manager: admits agents (AJOIN), hands each a
    dedicated proxy thread that leases it through the scheduler's
    ordinary ``next_binding`` path, delivers leases as pending ABIND
    replies, and revokes leases whose agent went silent. Owns the
    ``FleetAgentServer`` published on the fleet's shared listener and
    the fleet ticket on disk."""

    def __init__(self, fleet, max_agents: int,
                 poll_s: float = DEFAULT_POLL_S,
                 liveness_s: float = DEFAULT_LIVENESS_S):
        self.fleet = fleet
        self.scheduler = fleet.scheduler
        self.telemetry = fleet.telemetry
        self.max_agents = int(max_agents)
        self.poll_s = float(poll_s)
        self.liveness_s = float(liveness_s)
        self._lock = threading.RLock()
        self._agents: Dict[str, AgentRecord] = {}  # guarded-by: _lock
        self._live_count = 0  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._stopped = False  # guarded-by: _lock
        self._threads: List[threading.Thread] = []  # guarded-by: _lock
        self.server = None
        self.ticket: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "AgentPlane":
        from maggy_tpu_torch.core.rpc import FleetAgentServer

        self.server = FleetAgentServer(self.max_agents)
        self.server.telemetry = self.telemetry
        self.server.attach_plane(self)
        host, port = self.fleet.shared_server.attach(
            self.server, host=self.fleet.bind_host)
        advertise = host
        if advertise in ("0.0.0.0", "", "::"):
            from maggy_tpu_torch.util import host_address

            advertise = host_address()
        sink_server = getattr(self.fleet, "sink_server", None)
        self.ticket = write_fleet_ticket(
            self.fleet.env,
            self.fleet.home_dir + "/" + AGENT_TICKET_NAME,
            advertise, port, self.server.secret_hex, self.fleet.name,
            self.max_agents,
            sink=sink_server.secret_hex if sink_server is not None
            else None)
        return self

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            threads = list(self._threads)
            leaving = [rec for rec in self._agents.values()
                       if rec.state in ("idle", "leased")]
            # Keep answering for a couple of poll periods, so each idle
            # agent's next ALEASE reads AGSTOP and the agent exits 0; an
            # agent still inside a lease also gets the ADONE grace, since
            # its ADONE and its next poll follow the lease's end. One that
            # polls after the listener detached only sees a dead fleet and
            # exits 1 once its liveness bound passes. (The JAX package
            # detaches at once, and its agents' exit depends on that race.)
            now = time.monotonic()
            deadlines = [(rec, now + 2 * self.poll_s + 1.0
                          + (_DONE_GRACE_S if rec.state == "leased" else 0.0))
                         for rec in leaving]
            for rec in leaving:
                rec.state = "left"
        for rec in leaving:
            self._event(rec, "leave")
        for t in threads:
            t.join(timeout=5)
        while True:
            with self._lock:
                now = time.monotonic()
                if all(rec.stop_delivered or now >= deadline
                       for rec, deadline in deadlines):
                    break
            time.sleep(0.02)
        if self.server is not None:
            self.server.stop()  # detaches from the shared listener

    # ---------------------------------------------------------- rpc handlers

    def agent_join(self, host, chips, process_index, os_pid, agent,
                   coord_addr=None) -> Dict[str, Any]:
        """AJOIN handler body. ``agent`` (a previous id) is accepted for
        restart-rejoin symmetry but a fresh identity is always minted —
        the dead record's lease was already revoked by its proxy, and id
        reuse would let two processes interleave one lease."""
        del agent
        with self._lock:
            if self._stopped:
                return {"type": "ERR", "error": "fleet is shutting down"}
            if self._live_count >= self.max_agents:
                return {"type": "ERR",
                        "error": "fleet is full ({} agent slot(s))".format(
                            self.max_agents)}
            self._seq += 1
            agent_id = "a{}-{}".format(self._seq, os.urandom(3).hex())
            self._live_count += 1
        runner = self.scheduler.agent_slot_attach()
        rec = AgentRecord(agent_id, runner, host=str(host or "?"),
                          chips=int(chips or 1),
                          process_index=int(process_index or 0),
                          os_pid=int(os_pid) if os_pid else None,
                          coord_addr=coord_addr)
        thread = threading.Thread(target=self._proxy_loop, args=(rec,),
                                  daemon=True,
                                  name="agent-proxy-{}".format(agent_id))
        with self._lock:
            self._agents[agent_id] = rec
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(thread)
        self._event(rec, "join", host=rec.host, chips=rec.chips,
                    process_index=rec.process_index)
        thread.start()
        # rpc-ok: AJOIN reply literal, not a request producer — poll_s/liveness_s/server_t are consumed by the agent CLIENT (FleetAgent.join), a direction the checker does not model
        return {"type": "AJOIN", "agent": agent_id,
                "poll_s": self.poll_s, "liveness_s": self.liveness_s,
                "server_t": time.time()}

    def agent_lease(self, agent, offset_s=None,
                    rtt_s=None) -> Dict[str, Any]:
        """ALEASE handler body: idle heartbeat + lease delivery. A
        retried ALEASE (lost reply) re-serves the same undelivered ABIND
        — at-least-once delivery, idempotent on the agent side because
        the lease names one (exp, partition) pair.

        Clock piggyback: every reply carries ``server_t`` (this host's
        wall clock at reply build) so the agent's RTT-bounded offset
        estimator (telemetry.sink.ClockOffsetEstimator) gets a sample
        per poll; the agent reports its current estimate back on a
        cadence via ``offset_s``/``rtt_s``, journaled here as a
        ``clock_offset`` event per agent — the unified trace's
        cross-process time base."""
        if offset_s is not None:
            telem = self.telemetry
            if telem is not None:
                telem.event("clock_offset", agent=agent,
                            offset_s=float(offset_s),
                            rtt_s=float(rtt_s) if rtt_s is not None
                            else None)
        lease = None
        with self._lock:
            rec = self._agents.get(agent)
            if rec is None:
                return {"type": "ERR",
                        "error": "unknown agent {!r} (fleet restarted?); "
                                 "rejoin with AJOIN".format(agent)}
            rec.last_beat = time.monotonic()
            if self._stopped or rec.state in ("left", "lost"):
                # "lost": the fleet already revoked this agent's slot
                # (silence past the liveness bound) — a still-alive
                # agent reconnecting afterwards must exit and rejoin
                # under a FRESH identity, not zombie-poll a record whose
                # proxy is gone and that can never be leased again.
                rec.stop_delivered = True
                return {"type": "AGSTOP"}
            if rec.pending is not None and not rec.done:
                first = not rec.delivered
                rec.delivered = True
                rec.delivered_t = time.monotonic()
                if first:
                    rec.abind_ms = round(
                        (rec.delivered_t - rec.pending_set_t) * 1e3, 3)
                lease = dict(rec.pending)
                abind_ms = rec.abind_ms
        if lease is not None:
            self._event_raw(agent, "lease", exp=lease.get("exp"),
                            pid=lease.get("partition_id"),
                            abind_ms=abind_ms)
            lease["server_t"] = time.time()
            return lease
        return {"type": "OK", "server_t": time.time()}

    def agent_done(self, agent, error) -> Dict[str, Any]:
        with self._lock:
            rec = self._agents.get(agent)
            if rec is None:
                return {"type": "ERR",
                        "error": "unknown agent {!r}".format(agent)}
            rec.last_beat = time.monotonic()
            rec.done = True
            rec.done_error = str(error) if error else None
            rec.pending = None
        return {"type": "OK"}

    # ------------------------------------------------------------ proxy loop

    def _proxy_loop(self, rec: AgentRecord) -> None:
        """Driver-side stand-in for one remote agent: the exact shape of
        ``Fleet._runner_loop``, with the executor call replaced by lease
        delivery + remote liveness watching. Runs until the agent leaves
        or is lost; the runner slot then returns to the vacancy pool."""
        scheduler = self.scheduler
        why = "leave"
        while True:
            with self._lock:
                stopped = self._stopped or rec.state == "left"
                idle_age = time.monotonic() - rec.last_beat
            if stopped:
                break
            if idle_age > self.liveness_s:
                why = "lost"
                break
            binding = scheduler.next_binding(rec.runner, timeout=0.25)
            if binding is None:
                if scheduler.stopped:
                    break
                continue
            entry, pid = binding
            err, reason = self._serve_lease(rec, entry, pid)
            scheduler.release_binding(rec.runner, entry, pid, error=err,
                                      reason=reason)
            if reason == "agent_lost":
                why = "lost"
                break
        with self._lock:
            rec.state = "lost" if why == "lost" else "left"
            rec.pending = None
            self._live_count -= 1
        if why == "lost":
            self._event(rec, "lost")
        scheduler.agent_slot_detach(rec.runner)

    def _serve_lease(self, rec: AgentRecord, entry, pid: int):
        """Deliver one lease to the agent and watch it to a terminal
        state. Returns ``(error, lease_end_reason)`` for
        ``release_binding``. The trial-requeue half of agent death is NOT
        here: the leased experiment's own heartbeat-loss scan (slot-
        reclaim liveness in core/rpc.py) requeues exactly once; this
        proxy only closes the fleet-side lease accounting."""
        info = dict(entry.agent_info or {})
        lease = {"type": "ABIND", "exp": entry.name,
                 "partition_id": int(pid), **info}
        now = lease_set_t = time.monotonic()
        with self._lock:
            rec.pending = lease
            rec.pending_set_t = now
            rec.delivered = False
            rec.abind_ms = None
            rec.done = False
            rec.done_error = None
            rec.state = "leased"
            rec.lease = (entry.name, pid)
        drv = entry.driver
        res = drv.server.reservations if drv is not None else None
        bound = (drv.server.hb_loss_timeout
                 if drv is not None and drv.server.hb_loss_timeout
                 else self.liveness_s)
        deliver_deadline = now + max(self.liveness_s, 4 * self.poll_s)
        released_at: Optional[float] = None
        err: Optional[BaseException] = None
        reason = "released"
        while True:
            with self._lock:
                done, done_error = rec.done, rec.done_error
                delivered = rec.delivered
                delivered_t = rec.delivered_t
                stopped = self._stopped or rec.state == "left"
            if done:
                if done_error:
                    err = RuntimeError(
                        "agent {} failed lease for {!r} (partition {}): "
                        "{}".format(rec.agent_id, entry.name, pid,
                                    done_error))
                    reason = "error"
                break
            if stopped or self.scheduler.stopped:
                break
            now = time.monotonic()
            if not delivered:
                if now > deliver_deadline:
                    err = RuntimeError(
                        "agent {} vanished before its ABIND for {!r} was "
                        "delivered".format(rec.agent_id, entry.name))
                    reason = "agent_lost"
                    break
            else:
                rrec = res.get(pid) if res is not None else None
                if rrec is not None and rrec.get("registered_t", 0.0) < lease_set_t:
                    # The record the partition's last holder left (a lost
                    # agent's, silent since it died): this agent has not
                    # REGed yet, and that silence is not its own.
                    rrec = None
                if rrec is None:
                    if now - delivered_t > bound * _REG_GRACE_FACTOR:
                        # ABIND delivered but the agent never REGed: it
                        # died in between. No trial was assigned, so
                        # only the lease closes.
                        err = RuntimeError(
                            "agent {} took lease for {!r} but never "
                            "registered partition {}".format(
                                rec.agent_id, entry.name, pid))
                        reason = "agent_lost"
                        break
                elif rrec.get("released"):
                    # GSTOP observed by the executor: the ADONE is one
                    # poll away — bounded grace, then close anyway.
                    released_at = released_at or now
                    if now - released_at > _DONE_GRACE_S:
                        break
                elif res.is_silent(pid, bound):
                    # Mid-lease death: the experiment's LOST scan is
                    # requeueing the trial (exactly once); revoke the
                    # fleet lease.
                    err = RuntimeError(
                        "agent {} went silent mid-lease in {!r} "
                        "(partition {})".format(rec.agent_id, entry.name,
                                                pid))
                    reason = "agent_lost"
                    break
            time.sleep(0.05)
        with self._lock:
            rec.pending = None
            rec.lease = None
            rec.done = False
            if rec.state == "leased":
                rec.state = "idle"
            rec.leases_served += 1
            if reason != "agent_lost":
                # The agent was provably alive moments ago (experiment
                # heartbeats / its ADONE); without this, a long lease
                # whose last ALEASE poll predates it would read as
                # instant idle-silence back in the proxy loop.
                rec.last_beat = time.monotonic()
        self._event(rec, "done", exp=entry.name, pid=pid,
                    error=err is not None, reason=reason,
                    detail=str(err) if err is not None else None)
        return err, reason

    # -------------------------------------------------------------- querying

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [rec.snapshot() for rec in
                    sorted(self._agents.values(), key=lambda r: r.runner)]

    def record(self, agent_id: str) -> Optional[AgentRecord]:
        with self._lock:
            return self._agents.get(agent_id)

    def kill_agent_by_runner(self, runner_idx: int) -> bool:
        """SIGKILL the agent holding ``runner_idx``'s slot — same-host
        only (the soak/chaos path; an agent on another host can only be
        lost, not killed, from here). Returns True when a signal was
        sent."""
        import signal

        with self._lock:
            rec = next((r for r in self._agents.values()
                        if r.runner == runner_idx
                        and r.state in ("idle", "leased")), None)
            os_pid = rec.os_pid if rec is not None else None
        if not os_pid or os_pid == os.getpid():
            return False
        try:
            os.kill(os_pid, signal.SIGKILL)
            return True
        except OSError:
            return False

    def _event(self, rec: AgentRecord, phase: str, **fields: Any) -> None:
        self._event_raw(rec.agent_id, phase, runner=rec.runner, **fields)

    def _event_raw(self, agent_id: str, phase: str, **fields: Any) -> None:
        telem = self.telemetry
        if telem is not None:
            telem.event("agent", phase=phase, agent=agent_id, **fields)


# ----------------------------------------------------------- agent side


class _AgentChannel:
    """One persistent authenticated connection to the fleet's shared
    socket, with a single reconnect retry per call — the agent's polls
    are cheap and idempotent, so aggressive retry logic lives in the
    caller's loop, not here."""

    def __init__(self, addr: Tuple[str, int], secret: str,
                 timeout: float = 10.0):
        self.addr = tuple(addr)
        self.secret = secret.encode() if isinstance(secret, str) else secret
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.addr, timeout=self.timeout)
        sock.settimeout(self.timeout)
        return sock

    def call(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        from maggy_tpu_torch.core.rpc import MessageSocket

        for attempt in (0, 1):
            try:
                if self._sock is None:
                    self._sock = self._connect()
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


class FleetAgent:
    """The agent daemon body: JOIN the fleet, poll for leases, run each
    leased experiment's trial-executor loop with THAT experiment's
    secret on the SAME shared socket, report done, repeat. Lives in one
    process across many leases, which is what keeps warm slots
    (train/warm.py) resident across same-family re-leases. Its trials run on
    ``device`` (``trial_device()`` reads it in a train function)."""

    def __init__(self, ticket: Dict[str, Any], chips: int = 1,
                 process_index: int = 0, host: Optional[str] = None,
                 advertise_host: str = "127.0.0.1",
                 obs_port: Optional[int] = None, home: Optional[str] = None,
                 profile: bool = False):
        from maggy_tpu_torch.telemetry.sink import ClockOffsetEstimator

        self.addr = (ticket["host"], int(ticket["port"]))
        self.secret = ticket["secret"]
        self.chips = int(chips)
        self.process_index = int(process_index)
        self.host = host or socket.gethostname()
        self.coord_addr = reserve_coord_addr(advertise_host)
        self.profile = profile
        self.agent_id: Optional[str] = None
        self.poll_s = DEFAULT_POLL_S
        self.liveness_s = DEFAULT_LIVENESS_S
        self.leases_served = 0
        self.last_error: Optional[str] = None
        self.current_exp: Optional[str] = None
        self._channel = _AgentChannel(self.addr, self.secret)
        self._stop = threading.Event()
        self._obs_port = obs_port
        self._home = home
        self._telemetry = None
        self._obs_registration = None
        #: Journal-sink shipping (telemetry/sink.py): with the ticket's
        #: ``sink`` secret present, this agent's journal + counters ship
        #: to the fleet host over the shared socket.
        self._sink_secret = ticket.get("sink")
        #: RTT-bounded clock-offset estimate vs the fleet host, fed by
        #: the server_t every AJOIN/ALEASE reply carries; reported back
        #: on a cadence and journaled fleet-side per agent.
        self.clock = ClockOffsetEstimator()
        self._offset_reported: Optional[float] = None
        self._offset_report_t = 0.0

    @classmethod
    def from_ticket(cls, path: str, wait_s: float = 0.0,
                    **kwargs) -> "FleetAgent":
        return cls(read_fleet_ticket(path, wait_s=wait_s), **kwargs)

    # ------------------------------------------------------------- lifecycle

    def join(self) -> str:
        t_send = time.time()
        resp = self._channel.call({
            "type": "AJOIN", "host": self.host, "chips": self.chips,
            "process_index": self.process_index, "coord_addr": self.coord_addr,
            "os_pid": os.getpid(), "agent": self.agent_id,
        })
        if resp.get("type") != "AJOIN":
            raise RuntimeError("AJOIN rejected: {}".format(
                resp.get("error", resp)))
        self.clock.sample(t_send, resp.get("server_t"), time.time())
        self.agent_id = resp["agent"]
        self.poll_s = float(resp.get("poll_s") or DEFAULT_POLL_S)
        self.liveness_s = float(resp.get("liveness_s")
                                or DEFAULT_LIVENESS_S)
        return self.agent_id

    def stop(self) -> None:
        self._stop.set()

    def status(self) -> Dict[str, Any]:
        return {"agent": self.agent_id, "host": self.host,
                "chips": self.chips, "process_index": self.process_index,
                "leases_served": self.leases_served,
                "lease": self.current_exp,
                "last_error": self.last_error}

    def _start_obs(self) -> None:
        if self._obs_port is None and not self._sink_secret:
            return
        from maggy_tpu_torch.core.environment import EnvSing
        from maggy_tpu_torch.telemetry import Telemetry
        from maggy_tpu_torch.telemetry.sink import SinkBinding

        home = self._home
        if home is None:
            import tempfile

            home = tempfile.mkdtemp(prefix="maggy_agent_")
        self._home = home
        # With the ticket's sink secret, the agent's journal ships to
        # the fleet host (source = this agent's id) and agent.jsonl
        # becomes the degraded-mode fallback; without it, agent.jsonl is
        # the journal, exactly as before.
        sink = SinkBinding(self.addr, self._sink_secret) \
            if self._sink_secret else None
        self._telemetry = Telemetry(
            env=EnvSing.get_instance(),
            journal_path=home + "/agent.jsonl", enabled=True,
            sink=sink, sink_source=self.agent_id or "agent")
        if self._obs_port is not None:
            from maggy_tpu_torch.telemetry import obs as obs_mod

            self._obs_registration = obs_mod.ObsRegistration(
                key="agent:{}".format(self.agent_id),
                labels={"experiment": "fleet-agent",
                        "run": self.agent_id or "agent"},
                telemetry=self._telemetry, status_fn=self.status)
            server = obs_mod.register(self._obs_registration,
                                      port=self._obs_port)
            self._telemetry.event("obs_started", host=server.address[0],
                                  port=server.address[1],
                                  experiment=self.agent_id)

    def _offset_to_report(self):
        """The (offset_s, rtt_s) pair to piggyback on the next ALEASE —
        when the estimate changed since the last report or the report
        cadence elapsed; None otherwise (most polls carry nothing)."""
        from maggy_tpu_torch.telemetry.sink import OFFSET_REPORT_INTERVAL_S

        if self.clock.offset_s is None:
            return None
        changed = self._offset_reported != self.clock.offset_s
        due = (time.monotonic() - self._offset_report_t
               >= OFFSET_REPORT_INTERVAL_S)
        if changed or due:
            return (self.clock.offset_s, self.clock.rtt_s)
        return None

    def _stop_obs(self) -> None:
        if self._obs_registration is not None:
            from maggy_tpu_torch.telemetry import obs as obs_mod

            obs_mod.deregister(self._obs_registration)
            self._obs_registration = None
        if self._telemetry is not None:
            self._telemetry.close()
            self._telemetry = None

    # ------------------------------------------------------------ agent loop

    def run(self, max_leases: Optional[int] = None,
            idle_exit_s: Optional[float] = None) -> int:
        """Poll until the fleet says AGSTOP (or ``max_leases`` /
        ``idle_exit_s`` for tests and batch jobs). Returns the number of
        leases served. Transient channel failures are retried up to the
        liveness bound — past it the fleet has already declared this
        agent lost, so exiting (for the supervisor to restart us into a
        FRESH identity) is the correct move."""
        if self.agent_id is None:
            self.join()
        os.environ["MAGGY_TPU_CAPACITY"] = str(self.chips)
        self._start_obs()
        idle_since = time.monotonic()
        fail_since: Optional[float] = None
        try:
            while not self._stop.is_set():
                req = {"type": "ALEASE", "agent": self.agent_id}
                report = self._offset_to_report()
                if report is not None:
                    req["offset_s"] = report[0]
                    req["rtt_s"] = report[1]
                t_send = time.time()
                try:
                    resp = self._channel.call(req)
                    fail_since = None
                except (ConnectionError, OSError):
                    now = time.monotonic()
                    fail_since = fail_since or now
                    if now - fail_since > self.liveness_s:
                        raise
                    time.sleep(min(1.0, self.poll_s * 2))
                    continue
                if report is not None:
                    self._offset_reported = report[0]
                    self._offset_report_t = time.monotonic()
                if self.clock.sample(t_send, resp.get("server_t"),
                                      time.time()) \
                        and self._telemetry is not None:
                    self._telemetry.event("clock_offset",
                                          agent=self.agent_id,
                                          offset_s=self.clock.offset_s,
                                          rtt_s=self.clock.rtt_s)
                rtype = resp.get("type")
                if rtype == "AGSTOP":
                    break
                if rtype == "ABIND":
                    idle_since = time.monotonic()
                    if self._telemetry is not None:
                        # Agent-side span of the lease: the unified
                        # trace renders lease..done as this agent's
                        # execution slice, the middle anchor of the
                        # ABIND -> execution -> FINAL flow arrow.
                        self._telemetry.event(
                            "agent", phase="lease", agent=self.agent_id,
                            exp=resp.get("exp"),
                            pid=resp.get("partition_id"),
                            # Warm prewarming hint: the experiment's
                            # program-family key ABIND shipped — same
                            # family as this process's last lease means
                            # its warm slots (train/warm.py) stay hot.
                            family=resp.get("family"))
                    error = self._serve(resp)
                    self.leases_served += 1
                    self.last_error = error
                    if self._telemetry is not None:
                        self._telemetry.event(
                            "agent", phase="done", agent=self.agent_id,
                            exp=resp.get("exp"),
                            pid=resp.get("partition_id"),
                            error=bool(error))
                        self._telemetry.metrics.counter(
                            "agent.leases").inc()
                        if error:
                            self._telemetry.metrics.counter(
                                "agent.lease_errors").inc()
                    # Same transient-failure patience as the poll: a
                    # brief host blip right at lease end must not kill
                    # an otherwise healthy agent before the liveness
                    # bound the poll path already tolerates.
                    done_deadline = time.monotonic() + self.liveness_s
                    while True:
                        try:
                            self._channel.call({"type": "ADONE",
                                                "agent": self.agent_id,
                                                "error": error})
                            break
                        except (ConnectionError, OSError):
                            if time.monotonic() >= done_deadline:
                                raise
                            time.sleep(min(1.0, self.poll_s * 2))
                    idle_since = time.monotonic()
                    if max_leases is not None \
                            and self.leases_served >= max_leases:
                        break
                    continue
                if rtype == "ERR":
                    raise RuntimeError(
                        "fleet refused poll: {}".format(resp.get("error")))
                if idle_exit_s is not None \
                        and time.monotonic() - idle_since > idle_exit_s:
                    break
                self._stop.wait(self.poll_s)
        finally:
            self._stop_obs()
            self._channel.close()
        return self.leases_served

    def _serve(self, lease: Dict[str, Any]) -> Optional[str]:
        """Run one lease to completion: import the train function by its
        dotted path and drive the standard TrialExecutor loop against
        the leased experiment's secret on the shared address. Returns an
        error string (for ADONE) or None."""
        from maggy_tpu_torch.core.executors.trial_executor import TrialExecutor
        from maggy_tpu_torch.runner import load_train_fn

        self.current_exp = lease.get("exp")
        try:
            train_fn = load_train_fn(lease["train_fn"])
            executor = TrialExecutor(
                server_addr=self.addr,
                secret=lease["secret"],
                hb_interval=lease["hb_interval"],
                exp_dir=lease["exp_dir"],
                optimization_key=lease["optimization_key"],
                train_fn=train_fn,
                trial_type=lease.get("trial_type", "optimization"),
                profile=self.profile,
                warm_start=lease.get("warm_start", True),
                host_port=self.coord_addr,
            )
            executor(int(lease["partition_id"]))
            return None
        except BaseException as e:  # noqa: BLE001 - lease failure, agent survives
            return repr(e)
        finally:
            self.current_exp = None


# ------------------------------------------------------------------- CLI


def trial_device() -> str:
    """The device this agent process runs its trials on (``--device``), for
    a train function to build its Trainer on; "cuda" outside an agent."""
    return os.environ.get(DEVICE_ENV) or "cuda"


def _select_device(device: str, chips: Optional[int], process_index: int,
                   pin: bool) -> None:
    """Fix this process's device before anything touches CUDA. "cpu" hides
    every card (the JAX package's agents set ``JAX_PLATFORMS=cpu``), so a
    trial that asks for CUDA raises instead of reaching one; "cuda" needs a
    card and refuses to start without one rather than train on the CPU.
    ``pin`` narrows CUDA_VISIBLE_DEVICES to this agent's ``chips`` devices,
    the ``process_index``-th such group (``runner_pool.device_env``)."""
    if device == "cpu":
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    else:
        if pin and chips:
            from maggy_tpu_torch.core.runner_pool import device_env

            os.environ.update(device_env(process_index, chips))
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("agent --device cuda: no CUDA device is visible to this "
                             "process; pass --device cpu to run trials on the CPU")
    os.environ[DEVICE_ENV] = device


def agent_main(args) -> int:
    """Body of ``python -m maggy_tpu_torch.fleet agent`` (argparse namespace
    built in fleet/__main__.py)."""
    _select_device(args.device, args.chips, args.process_index, args.pin)
    if args.ticket:
        ticket = read_fleet_ticket(args.ticket, wait_s=args.wait_ticket)
    elif args.fleet_addr:
        host, _, port = args.fleet_addr.rpartition(":")
        if args.secret_file:
            with open(args.secret_file) as f:
                secret = f.read().strip()
        elif args.secret:
            secret = args.secret
        else:
            raise SystemExit("--fleet-addr requires --secret or "
                             "--secret-file")
        ticket = {"host": host, "port": int(port), "secret": secret}
    else:
        raise SystemExit("one of --ticket or --fleet-addr is required")
    agent = FleetAgent(
        ticket, chips=args.chips or 1, process_index=args.process_index,
        advertise_host=args.advertise_host, obs_port=args.obs_port, home=args.home,
        profile=args.profile)
    agent.join()
    print("agent {} joined fleet at {}:{} (device {})".format(
        agent.agent_id, ticket["host"], ticket["port"], args.device), flush=True)
    try:
        served = agent.run(max_leases=args.max_leases,
                           idle_exit_s=args.idle_exit)
    except (ConnectionError, OSError) as e:
        # The fleet host vanished (no AGSTOP possible) and stayed gone
        # past the liveness bound: the fleet has already declared this
        # agent lost, so exit non-zero for a supervisor to restart it
        # into a fresh identity.
        print("agent {} lost the fleet ({!r}); exiting for restart".format(
            agent.agent_id, e), flush=True)
        return 1
    print("agent {} done ({} lease(s) served)".format(
        agent.agent_id, served), flush=True)
    return 0
