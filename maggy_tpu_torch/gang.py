"""Gang-scheduled multi-chip trials: declaration, placement, replay, worlds.

Counterpart of ``maggy_tpu/gang.py``. A trial may declare that it needs N
chips plus a sharding plan (mesh axes and a strategy), and the driver
assembles a *gang* of N runners (runner = chip) into one contiguous block:
every member's chip is leased to the trial, the lowest-chip member is the
leader the trial is dispatched to, and the members hold their chips
(idle-polling, heartbeating) until the gang releases. One sweep can mix
1-chip trials with N-chip sharded trials on the same runners.

The host logic is the JAX package's, decision for decision:

- ``GangSpec``: the declaration (chips, mesh axes derived from the strategy
  when omitted, the strategy ``parallel.sharding.logical_axis_rules``
  accepts), declared per budget through ``config.chips_per_budget`` or
  searched over through a Searchspace ``GANG`` entry;
- ``GangPlacer``: best-fit aligned contiguous blocks on the chip line,
  fragmentation stalls that reserve the window with the fewest busy chips
  so it drains, ``avoid`` for dead chips, a journaled ``pack`` event for
  every decision;
- ``replay_pack``: chip-seconds utilization, stalls and assembly latency
  from a journal;
- ``run_pack_soak``: the mixed ASHA sweep with its utilization and parity
  gates.

Gang worlds are where JAX and PyTorch differ. JAX drives every chip of a
slice from one process; the port runs one process a rank, each on one
device (``core/executors/dist_executor.py``). So:

- **In-process gangs** (thread runners). The members idle-poll and
  heartbeat as in JAX; the leader's runner thread starts one rank process
  per gang chip (``run_gang_ranks``): it binds a ``TCPStore`` before the
  ranks start, and every rank joins one ``torch.distributed`` world, seeds
  torch with ``DIST_SEED`` and runs the trial function with a ``ctx.gang``
  whose world is up. Rank 0's broadcasts and logs are relayed to the
  leader's reporter; the leader sends the trial's one FINAL with rank 0's
  result. An early stop or a revocation (a STOP drawn by the leader's
  heartbeat) kills every rank, and a failed rank kills the others and fails
  the trial. No rank process outlives ``run_gang_ranks``.
- **Chips are logical, devices are physical.** Chip ``c`` runs on
  ``cuda:(c % device_count)``. Ranks that share a device talk over gloo;
  NCCL is used only where every rank has a device of its own
  (``process_backend``). The device kind is the agent's
  (``fleet.agent.trial_device``: "cuda", the default, or "cpu"), and a
  chip maps to its device and joins its world through the distributed
  executor's rank code (``dist_executor.rank_device`` and
  ``join_world``); a rank asked for the card that finds none raises.
- **Remote gangs** (fleet agents, each one process). Every member runs the
  program; ``GangContext.ensure_rendezvous`` calls
  ``init_process_group`` once a process, ranks in chip order, at the
  address the leader agent reserved (``fleet.agent.reserve_coord_addr``,
  whose store already listens when the agent advertises it). A later gang
  in the same agent process reuses the first world, as in JAX. A gang that
  mixes thread runners and agents runs the in-process path.
- **Steps** run eagerly: a gloo collective cannot sit in a CUDA graph. A
  gang trial's mesh Trainer (``Trainer(..., env=ctx.gang.sharding_env(),
  strategy=ctx.gang.strategy)``) places its model's parameters as the
  strategy says: "fsdp", "tp" and "ep" and their compositions cut them
  (``parallel/sharded.py``). ``reference_gang_loss``'s MLP keeps full
  parameters on every rank under every strategy ("fsdp" included), as its
  bare tensors declare no logical axes, and averages gradients over the data
  axes, which is the JAX sharded computation up to float rounding.

Left out: nothing of the JAX module; its ``jax.distributed`` latch became
the process-group latch above.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

#: Conventional trial-parameter name for a Searchspace ``GANG`` entry. The
#: driver resolves the entry by TYPE, so any name works.
GANG_PARAM = "gang"


def default_mesh_for(strategy: str, chips: int) -> Dict[str, int]:
    """Mesh axes derived from a strategy when the spec omits them: the
    strategy's primary sharded axis gets all the chips. Composite
    strategies ("fsdp_tp") must name axes explicitly."""
    primary = {"dp": "data", "fsdp": "fsdp", "tp": "model", "sp": "seq",
               "pp": "pipe", "ep": "expert", "zero": "data",
               "dp_zero": "data"}
    axis = primary.get(strategy)
    if axis is None:
        raise ValueError(
            "GangSpec with strategy {!r} needs explicit mesh axes (only "
            "single-part strategies {} derive a default)".format(
                strategy, sorted(primary)))
    return {axis: chips}


class GangSpec:
    """A trial's multi-chip declaration: ``chips`` runners gang up into a
    contiguous block shaped by ``mesh`` and sharded per ``strategy``.
    Serializes to a plain dict so it can ride in trial params and info."""

    __slots__ = ("chips", "mesh", "strategy")

    def __init__(self, chips: int, mesh: Optional[Dict[str, int]] = None,
                 strategy: str = "dp"):
        self.chips = int(chips)
        if self.chips < 1:
            raise ValueError("GangSpec.chips must be >= 1, got {}".format(chips))
        from maggy_tpu_torch.parallel.sharding import logical_axis_rules

        logical_axis_rules(strategy)  # validates the strategy parts
        self.strategy = strategy
        if mesh is None:
            mesh = default_mesh_for(strategy, self.chips) if self.chips > 1 else {"data": 1}
        self.mesh = {str(k): int(v) for k, v in mesh.items()}
        prod = 1
        for v in self.mesh.values():
            prod *= v
        if prod != self.chips:
            raise ValueError("GangSpec mesh {} multiplies to {} devices but chips={}".format(
                self.mesh, prod, self.chips))

    def to_dict(self) -> Dict[str, Any]:
        return {"chips": self.chips, "mesh": dict(self.mesh), "strategy": self.strategy}

    @classmethod
    def from_value(cls, value) -> "GangSpec":
        """Normalize any declaration form (GangSpec, dict or bare chip
        count) into a GangSpec."""
        if isinstance(value, GangSpec):
            return value
        if isinstance(value, dict):
            return cls(value["chips"], mesh=value.get("mesh"),
                       strategy=value.get("strategy", "dp"))
        return cls(int(value))

    def __eq__(self, other) -> bool:
        return isinstance(other, GangSpec) and self.to_dict() == other.to_dict()

    def __hash__(self) -> int:
        return hash((self.chips, tuple(sorted(self.mesh.items())), self.strategy))

    def __repr__(self) -> str:
        return "GangSpec(chips={}, mesh={}, strategy={!r})".format(
            self.chips, self.mesh, self.strategy)


def spec_chips(value) -> int:
    """Chip count of any chips_per_budget value (int or GangSpec/dict)."""
    if isinstance(value, GangSpec):
        return value.chips
    if isinstance(value, dict):
        return int(value.get("chips", 1))
    return int(value)


def config_max_gang_chips(config) -> int:
    """Largest gang any trial of this config can declare, over the
    chips_per_budget values and any Searchspace GANG entry; 1 = no gangs."""
    worst = 1
    for v in (getattr(config, "chips_per_budget", None) or {}).values():
        worst = max(worst, spec_chips(v))
    sp = getattr(config, "searchspace", None)
    if sp is not None:
        for name in sp.names():
            if sp.get_type(name) == "GANG":
                for v in sp.get(name):
                    worst = max(worst, spec_chips(v))
    return worst


def config_declares_gangs(config) -> bool:
    """Does this config declare any multi-runner gang (a GangSpec or dict
    chips_per_budget value, or a Searchspace GANG entry)? On the elastic
    pool bare int values size respawnable pinned runners, not gangs; on
    every other pool a bare int N is GangSpec(N)."""
    cpb = getattr(config, "chips_per_budget", None) or {}
    if any(isinstance(v, (GangSpec, dict)) for v in cpb.values()):
        return True
    if getattr(config, "pool", "thread") != "elastic" and any(
            spec_chips(v) > 1 for v in cpb.values()):
        return True
    sp = getattr(config, "searchspace", None)
    if sp is not None:
        return any(sp.get_type(n) == "GANG" for n in sp.names())
    return False


# ------------------------------------------------------------ gang worlds

#: The process-wide world of a remote gang: ``init_process_group`` runs at
#: most once a process, however many gang trials this agent serves.
_WORLD_LOCK = threading.Lock()
#: {"rank", "world", "device"} once this process joined a gang world.
_WORLD: Optional[Dict[str, Any]] = None  # guarded-by: _WORLD_LOCK
#: The rendezvous store an agent bound before advertising its address
#: (``fleet.agent.reserve_coord_addr``); the process that becomes rank 0
#: serves its world from it.
_COORD_STORE = None  # guarded-by: _WORLD_LOCK


def set_coord_store(store) -> None:
    """Keep the rendezvous store an agent bound at start: the world this
    process may lead is served from it."""
    global _COORD_STORE
    with _WORLD_LOCK:
        _COORD_STORE = store


def _join_world(store, rank: int, world: int, device, timeout_s: float) -> Dict[str, Any]:
    """Join a gang's world (``dist_executor.join_world``); the record that
    ``current_world`` returns."""
    from datetime import timedelta

    from maggy_tpu_torch.core.executors.dist_executor import join_world

    backend = join_world(store, rank, world, device, timedelta(seconds=timeout_s))
    return {"rank": rank, "world": world, "device": device, "backend": backend}


def current_world() -> Optional[Dict[str, Any]]:
    """This process's gang world ({"rank", "world", "device", "backend"}),
    or None."""
    with _WORLD_LOCK:
        return dict(_WORLD) if _WORLD is not None else None


class GangContext:
    """What a gang trial's function receives as ``ctx.gang``: the assembled
    block (chips, members, leader, mesh axes, strategy) and helpers that
    build the torch objects over exactly the gang's ranks.

    In a rank of an in-process gang (``rank`` is set) the world is up when
    the function runs. A remote gang carries ``rendezvous`` (coordinator
    address, process ids in chip order); ``ensure_rendezvous`` joins that
    world once a process, and ``build_mesh`` / ``sharding_env`` call it."""

    def __init__(self, info: Dict[str, Any]):
        self.chips: List[int] = [int(c) for c in info.get("chips", [])]
        self.members: List[int] = [int(p) for p in info.get("members", [])]
        self.leader: Optional[int] = info.get("leader")
        self.mesh_shape: Dict[str, int] = dict(info.get("mesh", {}))
        self.strategy: str = info.get("strategy", "dp")
        self.rendezvous: Optional[Dict[str, Any]] = \
            dict(info["rendezvous"]) if info.get("rendezvous") else None
        self.partition: Optional[int] = info.get("partition")
        #: This process's rank in an in-process gang's world (None outside
        #: a rank process).
        self.rank: Optional[int] = info.get("rank")

    @property
    def size(self) -> int:
        return len(self.chips)

    @property
    def process_id(self) -> Optional[int]:
        """This process's rank in the gang's world (0 = the leader): the
        rank of an in-process gang's rank process, or the remote gang's
        process id for this member's partition; None otherwise."""
        if self.rank is not None:
            return int(self.rank)
        if self.rendezvous is None or self.partition is None:
            return None
        pid = (self.rendezvous.get("process_ids") or {}).get(str(int(self.partition)))
        return None if pid is None else int(pid)

    @property
    def device(self):
        """This process's device: the chip at its rank (chip order)."""
        pid = self.process_id
        return self.devices()[pid if pid is not None else 0]

    def devices(self) -> list:
        """The gang's devices in chip order (chip c on cuda:(c % count))."""
        from maggy_tpu_torch.core.executors.dist_executor import rank_device
        from maggy_tpu_torch.fleet.agent import trial_device

        kind = trial_device()
        return [rank_device(kind, c) for c in self.chips]

    def ensure_rendezvous(self) -> bool:
        """Join the gang's world: a no-op (False) for a gang whose world
        is not this process's to join (an in-process gang outside its
        ranks); True once the world is up (joined now or earlier). A
        remote gang's process joins once; later gangs reuse that world."""
        global _WORLD
        if self.rank is not None:
            return current_world() is not None
        if self.rendezvous is None:
            return False
        with _WORLD_LOCK:
            if _WORLD is not None:
                return True
            process_id = self.process_id
            if process_id is None:
                raise RuntimeError(
                    "gang rendezvous info names no process id for partition {!r} "
                    "(process_ids: {})".format(self.partition,
                                               self.rendezvous.get("process_ids")))
            import torch.distributed as dist

            world = int(self.rendezvous["num_processes"])
            timeout_s = float(self.rendezvous.get("timeout_s", 120.0))
            from datetime import timedelta

            if process_id == 0 and _COORD_STORE is not None:
                store = _COORD_STORE
            else:
                host, port = self.rendezvous["coordinator"].rsplit(":", 1)
                store = dist.TCPStore(host, int(port), world, is_master=False,
                                      timeout=timedelta(seconds=timeout_s))
            _WORLD = _join_world(store, process_id, world, self.device, timeout_s)
        return True

    def build_mesh(self):
        """Named mesh over the gang's ranks (``parallel.mesh.slice_mesh``)."""
        from maggy_tpu_torch.parallel.mesh import slice_mesh

        self.ensure_rendezvous()
        return slice_mesh(self.chips, self.mesh_shape, device_type=self.device.type)

    def sharding_env(self):
        """A ``ShardingEnv`` over the gang's world, for the mesh Trainer."""
        from maggy_tpu_torch.parallel.mesh import ShardingEnv

        mesh = self.build_mesh()
        return ShardingEnv(mesh=mesh, process_index=self.process_id or 0,
                           process_count=self.size, device=self.device)

    def to_dict(self) -> Dict[str, Any]:
        out = {"chips": list(self.chips), "members": list(self.members),
               "leader": self.leader, "mesh": dict(self.mesh_shape),
               "strategy": self.strategy}
        if self.rendezvous is not None:
            out["rendezvous"] = dict(self.rendezvous)
        return out


# --------------------------------------------------- in-process gang ranks

#: Every rank process an in-process gang started in this process: (trial
#: id, rank, OS pid). Checks that no rank outlives its trial read it.
RANK_PIDS: List[Tuple[str, int, int]] = []
_RANK_PIDS_LOCK = threading.Lock()
#: Seconds the leader polls its relay between liveness checks.
_RELAY_POLL_S = 0.05


def pid_alive(pid: int) -> bool:
    """Whether OS process ``pid`` exists and is not a zombie."""
    try:
        with open("/proc/{}/stat".format(int(pid))) as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def live_rank_pids() -> List[int]:
    """Rank processes started here that are still alive."""
    with _RANK_PIDS_LOCK:
        pids = [p for _, _, p in RANK_PIDS]
    return [p for p in pids if pid_alive(p)]


class _RankReporter:
    """A rank's reporter: rank 0 relays its broadcasts (as floats) and logs
    to the leader's reporter; other ranks keep theirs. The stop decision is
    the leader's: it kills the ranks."""

    def __init__(self, queue, rank: int):
        self._queue = queue
        self.rank = rank
        self.step: Optional[int] = None

    def broadcast(self, metric, step: Optional[int] = None) -> None:
        if step is None:
            step = self.step + 1 if self.step is not None else 0
        self.step = int(step)
        if self.rank == 0:
            self._queue.put(("metric", float(metric), self.step))

    def log(self, message: str) -> None:
        if self.rank == 0:
            self._queue.put(("log", str(message)))


def _plain(value):
    """A rank's return value in plain Python (tensors to floats)."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if hasattr(value, "item") and getattr(value, "numel", lambda: 2)() == 1:
        return float(value.item())
    return value


def _rank_entry(train_fn, params: Dict[str, Any], rank: int, world: int, port: int,
                kind: str, info: Dict[str, Any], queue, wants_reporter: bool,
                wants_ctx: bool, trial: Tuple[str, str, str], timeout_s: float,
                profile: bool, ship_prints: bool) -> None:
    """One rank process of an in-process gang: join the world at the
    leader's store, seed, run the trial function, send the result. Rank 0
    runs it as a runner runs a 1-chip trial (``call_train_fn``): its
    TensorBoard session in ``<trial dir>/tensorboard`` (the hparams record,
    the train function's scalars, the session end), traced into that dir
    with ``profile``, its prints relayed as logs with ``ship_prints``."""
    import sys
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from maggy_tpu_torch import tensorboard
    from maggy_tpu_torch.core.executors.context import TrialContext
    from maggy_tpu_torch.core.executors.dist_executor import DIST_SEED, rank_device
    from maggy_tpu_torch.core.executors.trial_executor import call_train_fn

    global _WORLD
    try:
        if kind == "cpu":
            torch.set_num_threads(1)
        gang = dict(info["gang"], rank=rank)
        device = rank_device(kind, gang["chips"][rank])
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                              timeout=timedelta(seconds=timeout_s))
        with _WORLD_LOCK:
            _WORLD = _join_world(store, rank, world, device, timeout_s)
        torch.manual_seed(DIST_SEED)
        trial_id, trial_dir, exp_dir = trial
        call = dict(params)
        reporter = _RankReporter(queue, rank)
        if wants_reporter:
            call["reporter"] = reporter
        if wants_ctx:
            call["ctx"] = TrialContext(trial_id, trial_dir, exp_dir, params,
                                       dict(info, gang=gang))
        lead = rank == 0
        if lead:
            try:
                tensorboard._register(os.path.join(trial_dir, "tensorboard"))
                tensorboard.write_hparams(params)
            except Exception:  # noqa: BLE001 - TB must never kill a trial
                pass
        try:
            retval = call_train_fn(train_fn, call, trial_dir, reporter,
                                   profile=profile and lead, ship_prints=ship_prints and lead)
        finally:
            tensorboard._close()
        # Every rank is past its last collective before the world goes.
        dist.barrier()
        queue.put(("done", rank, _plain(retval) if rank == 0 else None, None))
    except BaseException:  # noqa: BLE001 - the leader fails the trial with it
        queue.put(("done", rank, None, traceback.format_exc()))
        queue.close()
        queue.join_thread()
        sys.exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()
    queue.close()
    queue.join_thread()


def run_gang_ranks(train_fn, params: Dict[str, Any], info: Dict[str, Any], reporter,
                   trial_id: str, trial_dir: str, exp_dir: str, wants_reporter: bool,
                   wants_ctx: bool, timeout_s: float = 120.0, profile: bool = False,
                   ship_prints: bool = False):
    """The leader's side of an in-process gang: bind the world's store,
    start one rank process per gang chip, relay rank 0's broadcasts and
    logs into ``reporter`` (whose STOP, an early stop or a revocation,
    kills every rank), and return rank 0's result. A rank that fails kills
    the others and raises. Every rank is dead when this returns."""
    import multiprocessing as mp
    import queue as queue_mod
    from datetime import timedelta

    import torch.distributed as dist

    from maggy_tpu_torch.core.executors.dist_executor import rank_device
    from maggy_tpu_torch.exceptions import EarlyStopException
    from maggy_tpu_torch.fleet.agent import trial_device

    kind = trial_device()
    gang = info["gang"]
    world = len(gang["chips"])
    for c in gang["chips"]:
        rank_device(kind, c)  # no card when asked for one: raise here
    store = dist.TCPStore("127.0.0.1", 0, world + 1, is_master=True,
                          timeout=timedelta(seconds=timeout_s), wait_for_workers=False)
    ctx = mp.get_context("spawn")
    relay = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, name="gang-{}-rank{}".format(trial_id, r),
                         args=(train_fn, params, r, world, store.port, kind, info, relay,
                               wants_reporter, wants_ctx, (trial_id, trial_dir, exp_dir),
                               timeout_s, profile, ship_prints), daemon=True)
             for r in range(world)]
    done: Dict[int, Tuple[Any, Optional[str]]] = {}
    try:
        for r, p in enumerate(procs):
            p.start()
            with _RANK_PIDS_LOCK:
                RANK_PIDS.append((trial_id, r, p.pid))
        while len(done) < world:
            try:
                msg = relay.get(timeout=_RELAY_POLL_S)
            except queue_mod.Empty:
                msg = None
            if msg is not None:
                if msg[0] == "metric":
                    reporter.broadcast(msg[1], step=msg[2])
                elif msg[0] == "log":
                    reporter.log(msg[1])
                elif msg[0] == "done":
                    done[msg[1]] = (msg[2], msg[3])
                    if msg[3] is not None:
                        raise RuntimeError("gang rank {} of trial {} failed:\n{}".format(
                            msg[1], trial_id, msg[3]))
                continue
            if reporter.stop_requested():
                raise EarlyStopException(reporter.stop_metric())
            dead = [r for r, p in enumerate(procs)
                    if r not in done and not p.is_alive() and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError("gang rank {} of trial {} died (exit code {})".format(
                    dead[0], trial_id, procs[dead[0]].exitcode))
        return done[0][0]
    finally:
        for p in procs:
            if p.is_alive() and p.pid is not None:
                if len(done) < world:
                    p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        relay.close()
        relay.cancel_join_thread()
        del store


# ------------------------------------------------------------------ placer


def contiguous_windows(total: int, size: int, taken: Set[int]) -> List[List[int]]:
    """Every contiguous ``size``-chip window on a ``total``-chip line that
    avoids ``taken``."""
    return [list(range(s, s + size))
            for s in range(0, total - size + 1)
            if not any(c in taken for c in range(s, s + size))]


def aligned_windows(total: int, size: int, taken: Set[int]) -> List[List[int]]:
    """``contiguous_windows`` preferring size-aligned starts when any exist
    (aligned blocks tile). ``GangPlacer`` and ``FleetScheduler.request_gang``
    both select from these windows, each with its own cost key."""
    windows = contiguous_windows(total, size, taken)
    return [w for w in windows if w[0] % size == 0] or windows


class GangPlacer:
    """Topology-aware packer: assigns gangs best-fit aligned contiguous chip
    blocks and journals every decision as a ``pack`` event (JAX
    ``gang.py:306-444``).

    Placement policy, in order:

    1. among fully free windows, the best fit (the one inside the smallest
       maximal free run), size-aligned starts first, but a free unaligned
       window still beats waiting on a busy chip;
    2. no free window but enough free chips in total: a fragmentation
       stall, journaled, and the aligned-preferred window with the fewest
       busy chips is reserved so it drains toward assembly;
    3. fewer than ``size`` free chips: the same fewest-busy window is
       reserved (members are conscripted as they free up).

    Reserved chips are excluded from other gangs' windows; the driver also
    stops handing 1-chip work to runners inside a reserved block.
    """

    def __init__(self, total_chips: int, telemetry=None):
        self.total_chips = int(total_chips)
        self.telemetry = telemetry
        self._lock = threading.Lock()
        # trial id -> ordered chip block, from reserve() to release().
        self._blocks: Dict[str, List[int]] = {}  # guarded-by: _lock
        self.stalls = 0  # guarded-by: _lock
        self._event("pack", op="init", chips=self.total_chips)

    def _event(self, kind: str, **fields: Any) -> None:
        telem = self.telemetry
        if telem is not None:
            telem.event(kind, **fields)

    def block_of(self, key: str) -> Optional[List[int]]:
        with self._lock:
            block = self._blocks.get(key)
            return list(block) if block is not None else None

    def reserved_chips(self) -> Set[int]:
        with self._lock:
            return {c for block in self._blocks.values() for c in block}

    def owner_of(self, chip: int) -> Optional[str]:
        """Which gang (trial id) reserved this chip, or None."""
        with self._lock:
            for key, block in self._blocks.items():
                if chip in block:
                    return key
        return None

    def reserve(self, key: str, size: int, free: Set[int],
                avoid: Optional[Set[int]] = None) -> Optional[List[int]]:
        """Reserve a contiguous ``size``-chip block for gang ``key``.
        ``free`` is the set of chips idle now; ``avoid`` chips are dead and
        excluded from every window. Returns the block (reservations are
        sticky), or None when no admissible window exists."""
        with self._lock:
            existing = self._blocks.get(key)
            if existing is not None:
                return list(existing)
            taken = {c for b in self._blocks.values() for c in b}
            taken |= set(avoid or ())
            free = (set(free) - taken) & set(range(self.total_chips))
            block, stalled = self._choose_locked(size, free, taken)
            if block is None:
                return None
            self._blocks[key] = block
            if stalled:
                self.stalls += 1
                self._event("pack", op="stall", gang=key, need=size, free=len(free))
            self._event("pack", op="reserve", gang=key, block=block,
                        free=sorted(free & set(block)), busy=sorted(set(block) - free))
            return list(block)

    # locked-by: _lock
    def _choose_locked(self, size: int, free: Set[int],
                       taken: Set[int]) -> Tuple[Optional[List[int]], bool]:
        windows = contiguous_windows(self.total_chips, size, taken)
        if not windows:
            return None, False
        aligned = [w for w in windows if w[0] % size == 0] or windows

        def run_len(w):
            lo = w[0]
            while lo - 1 in free and lo - 1 not in taken:
                lo -= 1
            hi = w[-1]
            while hi + 1 in free and hi + 1 not in taken:
                hi += 1
            return hi - lo + 1

        for cands in (aligned, windows):
            free_runs = [w for w in cands if all(c in free for c in w)]
            if free_runs:
                return min(free_runs, key=lambda w: (run_len(w), w[0])), False
        stalled = len(free) >= size
        best = min(aligned, key=lambda w: (sum(1 for c in w if c not in free), w[0]))
        return best, stalled

    def release(self, key: str, reason: str = "released") -> None:
        with self._lock:
            block = self._blocks.pop(key, None)
        if block is not None:
            self._event("pack", op="release", gang=key, block=block, why=reason)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"chips": self.total_chips, "stalls": self.stalls,
                    "blocks": {k: list(b) for k, b in self._blocks.items()}}


# ------------------------------------------------------------------ replay


def replay_pack(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Pure replay of one journal's packing record (JAX ``gang.py:446-
    526``): chip-seconds utilization over the sweep window, fragmentation
    stalls and gang assembly latency. A gang trial occupies
    ``len(chips)`` chips from ``gang_assembled`` to ``gang_released``, a
    1-chip trial one chip from ``running`` to ``finalized``; the window
    runs from the first busy edge to the last."""
    from maggy_tpu_torch.telemetry.spans import _dist_stats

    chips_total = None
    stalls = 0
    reserves = 0
    gang_open: Dict[str, Tuple[float, int]] = {}
    busy_intervals: List[Tuple[float, float, int]] = []
    run_open: Dict[str, float] = {}
    gang_trials: Set[str] = set()
    waiting_since: Dict[str, float] = {}
    assembly_ms: List[float] = []
    gangs_assembled = 0
    for ev in events:
        kind, t = ev.get("ev"), ev.get("t")
        if kind == "pack":
            op = ev.get("op")
            if op == "init" and ev.get("chips") is not None:
                chips_total = int(ev["chips"])
            elif op == "stall":
                stalls += 1
            elif op == "reserve":
                reserves += 1
                if ev.get("gang") is not None and t is not None:
                    waiting_since.setdefault(ev["gang"], t)
            continue
        if kind != "trial" or t is None:
            continue
        trial, phase = ev.get("trial"), ev.get("phase")
        if trial is None:
            continue
        if phase == "gang_assembled":
            gang_trials.add(trial)
            gangs_assembled += 1
            width = len(ev.get("chips") or ev.get("members") or []) or 1
            gang_open[trial] = (t, width)
            t0 = waiting_since.pop(trial, None)
            if t0 is not None:
                assembly_ms.append((t - t0) * 1e3)
        elif phase == "gang_released":
            opened = gang_open.pop(trial, None)
            if opened is not None:
                busy_intervals.append((opened[0], t, opened[1]))
        elif phase == "running":
            run_open.setdefault(trial, t)
        elif phase == "finalized":
            t0 = run_open.pop(trial, None)
            if t0 is not None and trial not in gang_trials:
                busy_intervals.append((t0, t, 1))
    # A journal ending mid-gang (a crash) still counts the open interval.
    last_t = max([t1 for _, t1, _ in busy_intervals] or [0.0])
    for trial, (t0, width) in gang_open.items():
        busy_intervals.append((t0, max(t0, last_t), width))
    out: Dict[str, Any] = {
        "chips": chips_total,
        "gangs_assembled": gangs_assembled,
        "fragmentation_stalls": stalls,
        "reservations": reserves,
        "assembly_latency": _dist_stats(assembly_ms),
    }
    if busy_intervals and chips_total:
        w0 = min(t0 for t0, _, _ in busy_intervals)
        w1 = max(t1 for _, t1, _ in busy_intervals)
        busy = sum((t1 - t0) * width for t0, t1, width in busy_intervals)
        if w1 > w0:
            out["window_s"] = round(w1 - w0, 3)
            out["busy_chip_seconds"] = round(busy, 3)
            out["chip_seconds_utilization"] = round(busy / (chips_total * (w1 - w0)), 3)
    return out


# -------------------------------------------------------------- pack soak


def gang_train_fn(lr, budget=1, gang=None, reporter=None, ctx=None):
    """The mixed-sweep gang trial: a small MLP trained over the gang's
    world (1-chip trials run the same program alone). Deterministic in (lr,
    gang shape) and independent of which chips the placer picked, so a
    gang trial's final loss compares directly with
    ``reference_gang_loss``. ``budget`` only selects the gang size."""
    del budget, gang
    g = None
    if ctx is not None and ctx.gang is not None:
        # A remote gang's world is joined here (an in-process gang's rank
        # already holds its own).
        ctx.gang.ensure_rendezvous()
        g = ctx.gang.to_dict()
    return {"metric": reference_gang_loss(lr, g, reporter=reporter)}


def reference_gang_loss(lr, gang: Optional[Dict[str, Any]] = None, reporter=None,
                        steps: int = 4) -> float:
    """The computation a gang runs (JAX ``gang.py:549-609``): SGD on a
    16-32-16 tanh MLP, MSE on a 32-row batch, all drawn from numpy seed 0
    and computed in fp32. Inside a gang world (a rank of a gang whose
    world is up) each rank takes its rows of the batch over the mesh's data
    axes, and the gradients and the loss are averaged over them; outside
    one it computes the whole batch in this process, which is the same
    function. Returns the negated final loss, as JAX does."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rng = np.random.default_rng(0)
    w1 = (rng.normal(size=(16, 32)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(32, 16)) * 0.1).astype(np.float32)
    x = rng.normal(size=(8 * 4, 16)).astype(np.float32)
    y = rng.normal(size=(8 * 4, 16)).astype(np.float32)
    world = current_world()
    env = None
    if world is not None and dist.is_initialized() and gang \
            and isinstance(gang.get("chips"), list) and len(gang["chips"]) > 1:
        env = GangContext(dict(gang, rank=world["rank"])).sharding_env()
    device = env.device if env is not None else torch.device("cpu")
    params = [torch.tensor(w, device=device, requires_grad=True) for w in (w1, w2)]
    if env is not None:
        xb, yb = env.shard_batch((x, y))
        group = env.data_group
    else:
        xb, yb = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
        group = None
    data_ranks = 1 if group is None else dist.get_world_size(group)
    loss_val = None
    for i in range(steps):
        loss = torch.mean((torch.tanh(xb @ params[0]) @ params[1] - yb) ** 2)
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        if group is not None:
            for g in grads:
                dist.all_reduce(g, group=group)
                g.div_(data_ranks)
            dist.all_reduce(loss, group=group)
            loss.div_(data_ranks)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(float(lr) * g)
        loss_val = float(loss)
        if reporter is not None:
            reporter.broadcast(-loss_val, step=i)
            # Paced so heartbeats land mid-trial and mixed sizes have
            # comparable durations.
            time.sleep(0.04)
    return -loss_val


def run_pack_soak(num_trials: int = 12, gang_chips: int = 4, workers: int = 8,
                  base_dir: Optional[str] = None, seed: int = 7,
                  utilization_gate: float = 0.7) -> Dict[str, Any]:
    """The acceptance scenario (JAX ``gang.py:612-697``): one mixed ASHA
    sweep, rung-0 trials on 1 chip and promotions on ``gang_chips``-chip
    fsdp gangs, on ``workers`` thread runners. Returns the journal-replayed
    pack report, the parity check (every gang trial's final loss against
    ``reference_gang_loss``) and the verdicts (the sweep completed;
    chip-seconds utilization >= ``utilization_gate``). The gang ranks run
    on ``MAGGY_TPU_TORCH_DEVICE``'s kind."""
    import glob
    import json as _json
    import tempfile

    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.optimizers import Asha
    from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_pack_")
    chips_map = {1: GangSpec(1), gang_chips: GangSpec(gang_chips, strategy="fsdp")}
    config = OptimizationConfig(
        name="pack_soak", num_trials=num_trials,
        optimizer=Asha(reduction_factor=gang_chips, resource_min=1,
                       resource_max=gang_chips, seed=seed),
        searchspace=Searchspace(lr=("DOUBLE", [0.05, 0.2])),
        direction="max", num_workers=workers, pool="thread",
        hb_interval=0.05, seed=seed, es_policy="none",
        chips_per_budget=chips_map, experiment_dir=base_dir)
    result = experiment.lagom(gang_train_fn, config)
    exp_dirs = sorted(d for d in glob.glob(os.path.join(base_dir, "*")) if os.path.isdir(d))
    journal = os.path.join(exp_dirs[-1], JOURNAL_NAME)
    events = read_events(journal)
    pack = replay_pack(events)
    parity = []
    for td in glob.glob(os.path.join(exp_dirs[-1], "*", "trial.json")):
        with open(td) as f:
            d = _json.load(f)
        budget = (d.get("params") or {}).get("budget")
        spec = chips_map.get(budget)
        if d.get("final_metric") is None or spec is None or spec.chips <= 1:
            continue
        ref = reference_gang_loss(d["params"]["lr"], spec.to_dict())
        parity.append({"trial": d.get("id"), "metric": d["final_metric"], "reference": ref,
                       "abs_err": abs(d["final_metric"] - ref)})
    violations: List[str] = []
    if not result.get("num_trials"):
        violations.append("sweep finalized zero trials")
    util = pack.get("chip_seconds_utilization")
    if util is None or util < utilization_gate:
        violations.append("chip-seconds utilization {} below the {} gate".format(
            util, utilization_gate))
    for p in parity:
        if p["abs_err"] > 1e-4:
            violations.append("gang/reference divergence on {}: |{} - {}| = {}".format(
                p["trial"], p["metric"], p["reference"], p["abs_err"]))
    if pack.get("gangs_assembled", 0) < 1:
        violations.append("no gang trial ever assembled")
    if not parity:
        violations.append("no finalized gang trial to parity-check")
    return {"ok": not violations, "violations": violations, "pack": pack,
            "parity": parity, "journal": journal,
            "result": {"num_trials": result.get("num_trials"),
                       "best_val": result.get("best_val")}}
