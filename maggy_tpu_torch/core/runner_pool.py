"""Runner pools: the fan-out substrate replacing Spark executors.

The pools of ``maggy_tpu/core/runner_pool.py:130-330`` that one host runs:
``ThreadRunnerPool`` (N in-process runner threads sharing the process's CUDA
device), ``ProcessRunnerPool`` (one spawned OS process per runner, each with
its own interpreter and CUDA context; a lost runner is SIGKILLed) and
``GPURunnerPool`` (processes pinned to disjoint CUDA devices through
CUDA_VISIBLE_DEVICES, the counterpart of the JAX package's TPU-pinned pool)
and ``RemoteRunnerPool`` (agents started apart, ``python -m
maggy_tpu_torch.runner``, that JOIN through a ticket; ``maggy_tpu/core/
runner_pool.py:518-601``), and ``ElasticRunnerPool`` (``maggy_tpu/core/
runner_pool.py:329-517``): ephemeral pinned processes leased chips out of
``total_chips`` and respawned at another size on the driver's RESIZE. Each
pool exposes
``kill_worker`` and ``stall_worker`` (``maggy_tpu/core/runner_pool.py:150-163,
268-279``), through which the chaos engine's ``kill_runner`` and
``stall_runner`` faults act: process pools SIGKILL, and SIGSTOP then SIGCONT;
thread pools can do neither and return False, and the engine falls back to
its cooperative kill and stall in the RPC client.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import threading
import time
import traceback
from abc import ABC, abstractmethod
from typing import Callable, Dict, List, Optional

import torch

#: Seconds a runner process gets to exit after ``terminate`` before SIGKILL.
TERMINATE_GRACE_S = 5.0


def resolve_num_workers(config) -> int:
    """``num_workers="auto"``: one runner per visible CUDA device (for the
    "gpu" pool, per ``chips_per_trial`` devices)."""
    nw = getattr(config, "num_workers", 1)
    if nw != "auto":
        return int(nw)
    if getattr(config, "pool", "thread") == "remote":
        raise ValueError(
            "num_workers='auto' is for local pools; remote agents join "
            "dynamically — set the admission cap explicitly.")
    count = torch.cuda.device_count()
    if count == 0:
        raise ValueError("num_workers='auto' found no CUDA device; pass an "
                         "explicit count")
    if getattr(config, "pool", "thread") in ("gpu", "elastic"):
        return max(1, count // max(1, config.chips_per_trial))
    return count


class RunnerPool(ABC):
    def __init__(self, num_workers: int):
        self.num_workers = num_workers

    @abstractmethod
    def run(self, worker_fn: Callable[[int], None]) -> List[BaseException]:
        """Run ``worker_fn(partition_id)`` on every runner and block until
        all return. Returns the runner failures (exceptions, or
        RuntimeErrors for dead processes) instead of raising: a dead runner
        is survivable once its trial is requeued onto the survivors, and the
        driver decides whether the failures are fatal."""

    def terminate(self) -> None:
        """Force-stop every runner (best effort); threads cannot be
        stopped, so only process pools act on it."""

    def kill_worker(self, partition_id: int) -> bool:
        """Kill ONE runner that heartbeat-loss detection declared lost,
        leaving the rest running: a runner wedged in a native call never
        returns and would block the pool's join. True if a runner was
        killed; thread pools cannot kill a thread and return False."""
        return False

    def stall_worker(self, partition_id: int, duration_s: float) -> bool:
        """Freeze ONE runner for ``duration_s`` seconds (chaos
        ``stall_runner``). True if the pool froze it; thread pools return
        False and the chaos engine stalls the runner's RPC calls instead."""
        return False


class ThreadRunnerPool(RunnerPool):
    def run(self, worker_fn: Callable[[int], None]) -> List[BaseException]:
        errors: List[BaseException] = []
        lock = threading.Lock()

        def target(pid: int):
            try:
                worker_fn(pid)
            except BaseException as e:  # noqa: BLE001 - reported to the driver
                with lock:
                    errors.append(e)
                traceback.print_exc()

        # Daemon threads: a runner that never returns (a test whose sweep
        # was cut by its time limit, a wedged native call) must not hold
        # its process open at exit. run() still waits for every runner.
        threads = [threading.Thread(target=target, args=(i,), name="runner-{}".format(i),
                                    daemon=True)
                   for i in range(self.num_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return errors


def device_env(index: int, chips_per_trial: int = 1) -> Dict[str, str]:
    """Env pinning runner ``index`` to CUDA devices [index*k, (index+1)*k)
    of those this process sees (``chip_env`` of ``maggy_tpu/core/
    runner_pool.py:196-214``). The CUDA runtime reads CUDA_VISIBLE_DEVICES
    when the child first touches the card, so the child sees its devices as
    0..k-1. Indices go through the parent's own CUDA_VISIBLE_DEVICES when it
    has one."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [v.strip() for v in visible.split(",") if v.strip()] if visible else None
    chosen = range(index * chips_per_trial, (index + 1) * chips_per_trial)
    if ids is not None and chosen[-1] >= len(ids):
        raise ValueError("runner {} needs devices {}..{} but CUDA_VISIBLE_DEVICES lists "
                         "{}".format(index, chosen[0], chosen[-1], len(ids)))
    return {"CUDA_VISIBLE_DEVICES": ",".join(ids[i] if ids else str(i) for i in chosen)}


def _stall_process(p, duration_s: float) -> bool:
    """SIGSTOP ``p`` now and SIGCONT it from a daemon timer after
    ``duration_s``. A process that exits meanwhile is simply not resumed."""
    if not (p.is_alive() and p.pid):
        return False
    try:
        os.kill(p.pid, signal.SIGSTOP)
    except OSError:
        return False

    def resume():
        try:
            if p.is_alive():
                os.kill(p.pid, signal.SIGCONT)
        except OSError:
            pass

    timer = threading.Timer(duration_s, resume)
    timer.daemon = True
    timer.start()
    return True


def _process_entry(worker_fn, pid: int, env: Dict[str, str]) -> None:
    # Device pinning must precede the child's first CUDA call; spawn starts
    # the child from a fresh interpreter, so no context exists yet.
    os.environ.update(env)
    worker_fn(pid)


class ProcessRunnerPool(RunnerPool):
    """One spawned OS process per runner (``maggy_tpu/core/runner_pool.py:
    252-301``). Spawn only: a process that has touched CUDA cannot fork a
    child that uses it. ``train_fn`` must therefore be picklable: a
    module-level function (or a ``functools.partial`` of one)."""

    def __init__(self, num_workers: int,
                 env_fn: Optional[Callable[[int], Dict[str, str]]] = None):
        super().__init__(num_workers)
        self.env_fn = env_fn
        self._procs: list = []
        # When terminate() was asked (monotonic), else None: run() escalates
        # to SIGKILL for a process that outlives the grace period.
        self._terminated_at: Optional[float] = None

    def terminate(self) -> None:
        """SIGTERM every runner process; one still alive TERMINATE_GRACE_S
        later is SIGKILLed by ``run`` (a rank blocked in a collective of a
        native library must not outlive its world)."""
        self._terminated_at = time.monotonic()
        for p in self._procs:
            if p.is_alive():
                p.terminate()

    def kill_worker(self, partition_id: int) -> bool:
        # SIGKILL: a SIGSTOPped or natively wedged process never runs a
        # SIGTERM handler, while SIGKILL reaps it unconditionally.
        if 0 <= partition_id < len(self._procs):
            p = self._procs[partition_id]
            if p.is_alive():
                p.kill()
                return True
        return False

    def stall_worker(self, partition_id: int, duration_s: float) -> bool:
        if 0 <= partition_id < len(self._procs):
            return _stall_process(self._procs[partition_id], duration_s)
        return False

    def run(self, worker_fn: Callable[[int], None]) -> List[BaseException]:
        ctx = mp.get_context("spawn")
        envs = [self.env_fn(i) if self.env_fn else {} for i in range(self.num_workers)]
        self._procs = [ctx.Process(target=_process_entry, args=(worker_fn, i, envs[i]),
                                   name="runner-{}".format(i))
                       for i in range(self.num_workers)]
        for p in self._procs:
            p.start()
        failures: List[BaseException] = []
        for p in self._procs:
            while p.is_alive():
                p.join(timeout=0.5)
                t_term = self._terminated_at
                if t_term is not None and time.monotonic() - t_term > TERMINATE_GRACE_S:
                    p.kill()
            p.join()
            if p.exitcode != 0:
                failures.append(RuntimeError("Runner process {} died (exit code {}).".format(
                    p.name, p.exitcode)))
        return failures


class GPURunnerPool(ProcessRunnerPool):
    """Runner processes pinned to disjoint CUDA devices: runner i sees
    devices [i*k, (i+1)*k) as its 0..k-1, k = ``chips_per_trial``. Raises
    when the pool needs more devices than this process sees."""

    def __init__(self, num_workers: int, chips_per_trial: int = 1,
                 visible_devices: Optional[int] = None):
        visible = torch.cuda.device_count() if visible_devices is None else visible_devices
        if num_workers * chips_per_trial > visible:
            raise ValueError("{} workers x {} devices per trial exceeds the {} visible "
                             "CUDA devices".format(num_workers, chips_per_trial, visible))
        super().__init__(num_workers, env_fn=lambda i: device_env(i, chips_per_trial))
        self.chips_per_trial = chips_per_trial


#: The variables an elastic runner reads its lease from (the counterparts of
#: the JAX pool's TPU_VISIBLE_CHIPS and MAGGY_TPU_CAPACITY): the logical
#: chips of its lease and their count. Its CUDA_VISIBLE_DEVICES lists the
#: distinct physical devices they run on (chip c on device c % count).
LEASE_CHIPS_ENV = "MAGGY_TPU_TORCH_LEASE_CHIPS"
CAPACITY_ENV = "MAGGY_TPU_TORCH_CAPACITY"
RESIZE_FILE_ENV = "MAGGY_TPU_TORCH_RESIZE_FILE"


def lease_env(chips, device_count: Optional[int] = None) -> Dict[str, str]:
    """An elastic runner's pinning env for a lease of logical ``chips``:
    CUDA_VISIBLE_DEVICES lists the distinct physical devices the chips map
    to (through this process's own CUDA_VISIBLE_DEVICES when it has one);
    the lease itself rides in variables of its own."""
    chips = sorted(int(c) for c in chips)
    count = torch.cuda.device_count() if device_count is None else device_count
    env = {LEASE_CHIPS_ENV: ",".join(str(c) for c in chips), CAPACITY_ENV: str(len(chips))}
    if count > 0:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        ids = [v.strip() for v in visible.split(",") if v.strip()] if visible else None
        devices = sorted({c % count for c in chips})
        env["CUDA_VISIBLE_DEVICES"] = ",".join(ids[d] if ids else str(d) for d in devices)
    return env


def lease_chips() -> List[int]:
    """The logical chips of this elastic runner's lease (empty outside one)."""
    raw = os.environ.get(LEASE_CHIPS_ENV, "")
    return [int(c) for c in raw.split(",") if c.strip()]


class ElasticRunnerPool(RunnerPool):
    """Budget-sized chip leases (JAX ``ElasticTPURunnerPool``). Each runner
    is an ephemeral pinned process; when the driver finds a runner's
    capacity no longer matches the schedule's needs (chips_per_budget), the
    runner exits with a resize request and this pool respawns it pinned to
    the new chip count (the pin precedes the child's first CUDA call, so a
    resize is an exit and a respawn). A chip free list keeps sum(leases) <=
    total_chips; a respawn waits until enough chips are free (the driver
    resizes idle runners toward parked work, so chips migrate). With
    ``telemetry`` every lease's start and end is journaled as a ``lease``
    event (partition, chips, capacity)."""

    def __init__(self, num_workers: int, total_chips: int, chips_per_trial: int = 1,
                 should_stop: Optional[Callable[[], bool]] = None, telemetry=None):
        super().__init__(num_workers)
        if num_workers * chips_per_trial > total_chips:
            raise ValueError("{} workers x {} chips exceeds the {}-chip lease budget".format(
                num_workers, chips_per_trial, total_chips))
        self.total_chips = total_chips
        self.chips_per_trial = chips_per_trial
        self.should_stop = should_stop or (lambda: False)
        self.telemetry = telemetry
        import tempfile

        self.resize_dir = tempfile.mkdtemp(prefix="maggy_resize_")
        self._procs: dict = {}  # guarded-by: _lock  # pid -> (process, chips)
        self._spawn_time: dict = {}  # guarded-by: _lock
        self._free: set = set()  # guarded-by: _lock
        # Respawns queued for chips: [(partition_id, chips_needed)], so the
        # driver's watchdog tells "queued" from "died before registering".
        self._pending_respawns: list = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def spawn_stamp(self, partition_id: int):
        """Monotonic spawn time of the partition's current process, or None
        when none exists (its respawn is queued for chips)."""
        with self._lock:
            if partition_id not in self._procs:
                return None
            return self._spawn_time.get(partition_id)

    def spawn_age(self, partition_id: int):
        """Seconds since the partition's current process was spawned."""
        t0 = self.spawn_stamp(partition_id)
        return None if t0 is None else time.monotonic() - t0

    def pending_respawn(self, partition_id: int) -> bool:
        """True while the partition has a future: its respawn is queued for
        chips, or a process exists now. False is terminal."""
        with self._lock:
            if partition_id in self._procs:
                return True
            return any(pid == partition_id for pid, _ in self._pending_respawns)

    def _resize_file(self, partition_id: int) -> str:
        return os.path.join(self.resize_dir, "{}.resize".format(partition_id))

    # locked-by: _lock
    def _spawn_locked(self, ctx, worker_fn, partition_id: int, chips: set) -> None:
        env = lease_env(chips)
        env[RESIZE_FILE_ENV] = self._resize_file(partition_id)
        p = ctx.Process(target=_process_entry, args=(worker_fn, partition_id, env),
                        name="runner-{}".format(partition_id))
        p.start()
        self._procs[partition_id] = (p, chips)
        self._spawn_time[partition_id] = time.monotonic()
        self._lease_event_locked("start", partition_id, chips)

    # locked-by: _lock
    def _lease_event_locked(self, phase: str, partition_id: int, chips: set) -> None:
        if self.telemetry is not None:
            extra = {} if phase == "start" else {"reason": "released"}
            self.telemetry.event("lease", phase=phase, partition=int(partition_id),
                                 chips=sorted(chips), capacity=len(chips), **extra)

    def kill_worker(self, partition_id: int) -> bool:
        with self._lock:
            entry = self._procs.get(partition_id)
            if entry and entry[0].is_alive():
                entry[0].kill()
                return True
        return False

    def stall_worker(self, partition_id: int, duration_s: float) -> bool:
        with self._lock:
            entry = self._procs.get(partition_id)
        return bool(entry) and _stall_process(entry[0], duration_s)

    def terminate(self) -> None:
        with self._lock:
            for p, _ in self._procs.values():
                if p.is_alive():
                    p.terminate()

    def run(self, worker_fn: Callable[[int], None]) -> List[BaseException]:
        import json

        ctx = mp.get_context("spawn")
        chip_ids = list(range(self.total_chips))
        with self._lock:
            for i in range(self.num_workers):
                lease = set(chip_ids[i * self.chips_per_trial:(i + 1) * self.chips_per_trial])
                self._spawn_locked(ctx, worker_fn, i, lease)
            self._free = set(chip_ids[self.num_workers * self.chips_per_trial:])
        failures: List[BaseException] = []
        while True:
            with self._lock:
                exited = [(pid, p, chips) for pid, (p, chips) in self._procs.items()
                          if not p.is_alive()]
            for pid, p, chips in exited:
                p.join()
                # Read the resize request before the slot is released, so
                # the watchdog never sees a queued respawn as a dead one.
                resize = None
                rf = self._resize_file(pid)
                if os.path.exists(rf):
                    try:
                        with open(rf) as f:
                            resize = int(json.load(f)["chips"])
                    except (ValueError, KeyError, OSError):
                        pass
                    try:
                        os.unlink(rf)
                    except OSError:
                        pass
                with self._lock:
                    self._procs.pop(pid, None)
                    self._free |= chips
                    self._lease_event_locked("end", pid, chips)
                    if p.exitcode == 0 and resize:
                        # resize 0 = retire: the chips free, no respawn.
                        self._pending_respawns.append((pid, resize))
                if p.exitcode != 0:
                    failures.append(RuntimeError("Runner process {} died (exit code {}).".format(
                        p.name, p.exitcode)))
            with self._lock:
                still_pending = []
                for pid, k in self._pending_respawns:
                    if k > self.total_chips:
                        failures.append(RuntimeError(
                            "Runner {} asked for {} chips but the lease budget is {} (check "
                            "chips_per_budget).".format(pid, k, self.total_chips)))
                        continue
                    if self.should_stop():
                        continue  # the experiment is over: no respawn
                    if len(self._free) >= k:
                        lease = set(sorted(self._free)[:k])
                        self._free -= lease
                        self._spawn_locked(ctx, worker_fn, pid, lease)
                    else:
                        still_pending.append((pid, k))
                self._pending_respawns = still_pending
                alive = any(p.is_alive() for p, _ in self._procs.values())
            if not alive and (not still_pending or self.should_stop()):
                break
            time.sleep(0.05)
        return failures


class RemoteRunnerPool(RunnerPool):
    """Runners are agent processes started apart (``python -m
    maggy_tpu_torch.runner``), on this host or another that reaches the
    driver, which dial the driver's control plane and JOIN. They belong to
    this experiment and exit with it.

    The pool spawns nothing: it writes a join ticket (address and secret)
    to ``<exp_dir>/runner_ticket.json`` and waits for the experiment. Agents
    may join at any time up to ``num_workers``; the schedule completes with
    however many joined (heartbeat-loss recovery covers an agent that dies
    mid-trial). It fails instead of hanging when no agent registers within
    ``constants.REGISTRATION_TIMEOUT_S``, or when every agent that did has
    gone silent past the loss bound with the experiment unfinished."""

    TICKET_NAME = "runner_ticket.json"

    def __init__(self, driver):
        super().__init__(driver.num_executors)
        self.driver = driver

    def ticket(self) -> dict:
        drv = self.driver
        host, port = drv.server_addr
        if host in ("0.0.0.0", "", "::"):
            from maggy_tpu_torch.util import host_address

            host = host_address()
        return {"host": host, "port": port, "secret": drv.secret_for_clients(),
                "app_id": drv.app_id, "run_id": drv.run_id, "num_workers": self.num_workers}

    def run(self, worker_fn: Callable[[int], None]) -> List[BaseException]:
        import json
        import time

        from maggy_tpu_torch import constants

        drv = self.driver
        path = drv.exp_dir + "/" + self.TICKET_NAME
        drv.env.dump(json.dumps(self.ticket(), indent=2), path)
        timeout = constants.REGISTRATION_TIMEOUT_S
        deadline = time.monotonic() + timeout
        while not drv.experiment_done and not drv.server.reservations.all():
            if time.monotonic() > deadline:
                raise TimeoutError("no remote runner registered within {}s; ticket at "
                                   "{}".format(timeout, path))
            time.sleep(0.2)
        # With every admitted agent silent past the loss bound nobody is
        # left to take the requeued trials: fail with that cause.
        while not drv.experiment_done:
            time.sleep(0.2)
            bound = drv.server.hb_loss_timeout
            if bound is None:
                continue
            registered = drv.server.reservations.all()
            active = {pid for pid, rec in registered.items() if not rec.get("released")}
            if active and active <= set(drv.server.reservations.silent(bound)):
                return [RuntimeError(
                    "all {} remote agent(s) silent for > {:.0f}s with the experiment "
                    "incomplete; presumed dead (partitions {})".format(
                        len(active), bound, sorted(active)))]
        # Let agents read their GSTOP before the driver stops the server;
        # a dead agent never acks, so the wait is capped.
        ack_deadline = time.monotonic() + 10.0
        while not drv.server.reservations.all_released() and time.monotonic() < ack_deadline:
            time.sleep(0.1)
        return []
