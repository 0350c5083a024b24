"""Distributed-training executor: one rank of the training world.

Counterpart of ``maggy_tpu/core/executors/dist_executor.py:30-156``
(reference `maggy/core/executors/dist_executor.py:40-224`): register with the
coordinator endpoint, heartbeat, the registration barrier, the coordinator
rendezvous (DIST_CONFIG), process-group init, the train function, and the
FINAL metric carrying the worker-measured ``rendezvous_ms``.

JAX's ``jax.distributed.initialize`` becomes ``torch.distributed.
init_process_group``: worker 0 hosts the rendezvous store (a ``TCPStore``
bound to a free port before its REG, so the endpoint it advertises is
already listening; a remote agent advertises the address it reaches the
driver from), the others join it. Each rank runs on one device:
``cuda:(rank % device count)``, with NCCL when every rank has a card of its
own and gloo when ranks share one (NCCL refuses two ranks on one device) or
run on the CPU (``config.device="cpu"``). The group's timeout is the
heartbeat-loss bound. A rank asked for the card that finds none raises.
Workers of ``backend="thread"`` share one process, which holds one default
group, so they rendezvous and average like ranks but train on world-1
meshes without a group. Seeding follows the reference's determinism setup
(`dist_executor.py:208-214`): every rank seeds torch with 0.
"""

from __future__ import annotations

import inspect
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.core.rpc import Client
from maggy_tpu_torch.parallel.mesh import ShardingEnv, make_mesh, resolve_mesh_shape
from maggy_tpu_torch.telemetry import profiling
from maggy_tpu_torch.telemetry.runnerstats import RunnerStats

#: The seed every rank starts from.
DIST_SEED = 0
#: Where a local world's rendezvous store listens.
COORD_HOST = "127.0.0.1"


def rank_device(device: str, index: int) -> torch.device:
    """The device of rank (or gang chip) ``index``: the CPU, or CUDA device
    index % count (raising without a card)."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("rank {}: device 'cuda' asked but this process finds no CUDA "
                           "device".format(index))
    return torch.device("cuda", index % torch.cuda.device_count())


def process_backend(device: torch.device, world: int) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, else gloo."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def join_world(store, rank: int, world: int, device: torch.device,
               timeout: timedelta) -> str:
    """``init_process_group`` for this process as ``rank`` of ``world`` at
    ``store``, on ``device``; returns the backend (``process_backend``)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = process_backend(device, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout)
    return backend


class DistExecutor:
    """The worker each rank runs; picklable when ``train_fn`` is."""

    def __init__(self, server_addr: Tuple[str, int], secret: str, hb_interval: float,
                 exp_dir: str, train_fn: Callable, config, num_workers: int,
                 shared_process: bool, coord_host: str = COORD_HOST):
        self.server_addr = server_addr
        self.secret = secret
        self.hb_interval = hb_interval
        self.exp_dir = exp_dir
        self.train_fn = train_fn
        self.config = config
        self.num_workers = num_workers
        #: Workers are threads of one process (backend="thread", more than
        #: one): no process group, world-1 meshes.
        self.shared_process = shared_process
        #: Where worker 0's rendezvous store is advertised.
        self.coord_host = coord_host

    def __call__(self, partition_id: int) -> None:
        reporter = Reporter(log_file="{}/worker_{}.log".format(self.exp_dir, partition_id))
        reporter.reset(trial_id="dist")
        client = Client(self.server_addr, partition_id, self.hb_interval, self.secret)
        # The whole job is one "trial" to the runner stats.
        stats = RunnerStats()
        stats.trial_start("dist")
        reporter.stats = stats
        client.runner_stats = stats
        grouped = False
        try:
            device = rank_device(self.config.device, partition_id)
            timeout = timedelta(seconds=self.config.resolved_hb_loss_timeout())
            store, host_port = None, None
            if partition_id == 0 and not self.shared_process:
                store = dist.TCPStore(self.coord_host, 0, self.num_workers, is_master=True,
                                      timeout=timeout, wait_for_workers=False)
                host_port = "{}:{}".format(self.coord_host, store.port)
            client.register(host_port=host_port)
            client.start_heartbeat(reporter)
            t_barrier = time.monotonic()
            client.await_reservations()
            dist_config = client.get_dist_config()
            # Registration barrier plus rendezvous, as this worker saw it.
            rendezvous_ms = (time.monotonic() - t_barrier) * 1e3
            torch.manual_seed(DIST_SEED)
            if self.shared_process:
                sharding_env = self._world_of_one(partition_id, device)
            else:
                sharding_env = self._init_cluster(dist_config, partition_id, device, store,
                                                  timeout, reporter)
                grouped = True
            if self.config.profile:
                # A profiled rank's trace goes where the JAX package's goes
                # (``dist_executor.py:91-95``).
                with profiling.trial_profile("{}/tensorboard_worker{}".format(
                        self.exp_dir, partition_id)):
                    metric = self._run_train_fn(sharding_env, reporter)
            else:
                metric = self._run_train_fn(sharding_env, reporter)
            client.finalize_metric(metric, reporter,
                                   extra={"telem": {"rendezvous_ms": round(rendezvous_ms, 3)}})
        except Exception:  # noqa: BLE001 - reported to the driver, then re-raised
            reporter.log("Distributed worker {} failed:\n{}".format(
                partition_id, traceback.format_exc()))
            with reporter.lock:
                client._request({"type": "FINAL", "trial_id": "dist", "value": None,
                                 "error": True, "logs": reporter.get_data()["logs"]})
                reporter.reset()
            raise
        finally:
            if grouped and dist.is_initialized():
                dist.destroy_process_group()
            client.stop()

    def _world_of_one(self, partition_id: int, device: torch.device) -> ShardingEnv:
        """A thread worker's env: the config's axes, each of size 1."""
        if device.type == "cuda":
            torch.cuda.set_device(device)
        names = resolve_mesh_shape(self.config.mesh_shape, self.num_workers)
        return ShardingEnv(mesh=make_mesh({a: 1 for a in names}, device_type=device.type),
                           process_index=partition_id, process_count=self.num_workers,
                           device=device)

    def _init_cluster(self, dist_config, partition_id: int, device: torch.device, store,
                      timeout: timedelta, reporter) -> ShardingEnv:
        """Join the world's process group at the coordinator and build the
        mesh (the reference's NCCL setup, `dist_executor.py:197-223`)."""
        world = int(dist_config["num_processes"])
        if store is None:
            host, port = dist_config["coordinator_address"].rsplit(":", 1)
            store = dist.TCPStore(host, int(port), world, is_master=False, timeout=timeout)
        backend = join_world(store, partition_id, world, device, timeout)
        reporter.log("torch.distributed initialized: rank {}/{} ({}, {}) at {}".format(
            partition_id, world, backend, device, dist_config["coordinator_address"]))
        return ShardingEnv(mesh=make_mesh(self.config.mesh_shape, device_type=device.type),
                           process_index=partition_id, process_count=world, device=device)

    def _run_train_fn(self, sharding_env: ShardingEnv, reporter) -> Optional[float]:
        kwargs = {}
        sig = inspect.signature(self.train_fn).parameters
        for name in ("model", "train_set", "test_set"):
            if name in sig:
                kwargs[name] = getattr(self.config, name)
        if "sharding_env" in sig:
            kwargs["sharding_env"] = sharding_env
        if "reporter" in sig:
            kwargs["reporter"] = reporter
        retval = self.train_fn(**kwargs)
        if isinstance(retval, dict):
            return float(retval.get("metric", next(iter(retval.values()))))
        return float(retval) if retval is not None else None
