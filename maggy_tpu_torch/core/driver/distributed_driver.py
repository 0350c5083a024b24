"""Distributed-training driver.

Counterpart of ``maggy_tpu/core/driver/distributed_driver.py:22-152``
(reference `maggy/core/experiment_driver/distributed_driver.py:23-73`): a
`DistributedServer`, per-worker FINAL metrics collected into ``results``,
and the experiment's result their average with ``per_worker`` and
``num_workers``. A worker whose FINAL carries an error, or who goes silent
past the heartbeat-loss bound (DEAD_WORKER), fails the experiment at once,
and the driver kills the world's other rank processes: a rank left waiting
in a collective would otherwise hang until its group times out. The run
writes its journal like any sweep (``worker`` registered/finalized events,
the ``dist.rendezvous_ms`` histogram, ``dist.finals.ok|error`` counters).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List

from maggy_tpu_torch.config import DistributedConfig
from maggy_tpu_torch.core.driver.driver import Driver
from maggy_tpu_torch.core.executors.dist_executor import DistExecutor
from maggy_tpu_torch.core.rpc import DistributedServer
from maggy_tpu_torch.core.runner_pool import ProcessRunnerPool, ThreadRunnerPool

#: How long the verdict waits for the driver's worker to reach the messages
#: queued before the runners returned.
DRAIN_TIMEOUT_S = 10.0


class DistributedDriver(Driver):
    def __init__(self, config: DistributedConfig, app_id: str, run_id: int):
        self.num_workers = config.num_workers
        self.num_executors = config.num_workers
        super().__init__(config, app_id, run_id)
        self.results: List[float] = []  # guarded-by: _results_lock
        self._finals = 0  # guarded-by: _results_lock
        self._worker_errors = 0  # guarded-by: _results_lock
        self._results_lock = threading.Lock()
        self._drained = threading.Event()
        self.job_start = None
        # A silent worker deadlocks the world's collectives: heartbeat loss
        # surfaces it as a failed experiment rather than a hang.
        self.server.hb_loss_timeout = config.resolved_hb_loss_timeout()

    @property
    def _shared_process(self) -> bool:
        return self.config.backend == "thread" and self.num_workers > 1

    def _make_server(self):
        return DistributedServer(self.num_workers, secret=self.secret)

    def _make_runner_pool(self):
        if self.config.backend == "remote":
            from maggy_tpu_torch.core.runner_pool import RemoteRunnerPool

            # Each rank is an agent started apart: JOIN admits it and hands
            # it what its DistExecutor needs (JAX `distributed_driver.py:41-58`).
            cfg = self.config
            self.server.join_info = {
                "hb_interval": self.hb_interval, "exp_dir": self.exp_dir,
                "optimization_key": "metric", "trial_type": "distributed",
                "num_workers": self.num_workers, "mesh_shape": dict(cfg.mesh_shape or {}),
                "strategy": cfg.strategy, "device": cfg.device,
                "hb_loss_timeout": cfg.resolved_hb_loss_timeout(), "profile": cfg.profile}
            return RemoteRunnerPool(self)
        # One rank a process; a single worker (or thread mode) runs in
        # threads of this process.
        if self.num_workers == 1 or self.config.backend == "thread":
            return ThreadRunnerPool(self.num_workers)
        return ProcessRunnerPool(self.num_workers)

    def _executor_fn(self, train_fn):
        return DistExecutor(
            server_addr=self.server_addr, secret=self.server.secret_hex,
            hb_interval=self.hb_interval, exp_dir=self.exp_dir, train_fn=train_fn,
            config=self.config, num_workers=self.num_workers,
            shared_process=self._shared_process)

    def _register_msg_callbacks(self) -> None:
        self.message_callbacks.update(
            METRIC=self._log_msg_callback,
            FINAL=self._final_msg_callback,
            DEAD_WORKER=self._dead_worker_msg_callback,
            DRAINED=lambda msg: self._drained.set(),
        )

    def _dead_worker_msg_callback(self, msg) -> None:
        self.exception = RuntimeError(
            "Distributed worker {} stopped heartbeating; a dead rank wedges the world, "
            "aborting the experiment.".format(msg["partition_id"]))
        self.experiment_done = True
        self._terminate_active_pool()

    def _terminate_active_pool(self) -> None:
        """Kill the world's rank processes: survivors of a failed or dead
        rank may be waiting in a collective and would block the pool."""
        pool = self._active_pool
        if pool is not None:
            pool.terminate()

    def _log_msg_callback(self, msg) -> None:
        self.add_executor_logs(msg.get("logs"))

    def _final_msg_callback(self, msg) -> None:
        self.add_executor_logs(msg.get("logs"))
        self.telemetry.metrics.counter(
            "dist.finals.error" if msg.get("error") else "dist.finals.ok").inc()
        with self._results_lock:
            self._finals += 1
            # The first errored rank dooms the world: no waiting for the
            # rest, who may be stuck in a collective.
            done = self._finals >= self.num_workers or bool(msg.get("error"))
            if msg.get("error"):
                self._worker_errors += 1
            elif msg.get("value") is not None:
                self.results.append(float(msg["value"]))
        if done:
            self.experiment_done = True
        if msg.get("error"):
            self._terminate_active_pool()

    def _exp_startup_callback(self) -> None:
        self.job_start = time.time()

    def _after_runners(self) -> None:
        """Let the driver's worker handle every message queued before the
        runners returned (a failed rank's FINAL is queued before its
        process exits), so the verdict sees it."""
        self.enqueue({"type": "DRAINED"})
        self._drained.wait(DRAIN_TIMEOUT_S)

    def _exp_final_callback(self, job_end: float) -> Dict[str, Any]:
        with self._results_lock:
            if self._worker_errors:
                # The "average" of a partial world is a failed experiment.
                raise RuntimeError(
                    "{} of {} distributed workers failed (see worker logs in {}).".format(
                        self._worker_errors, self.num_workers, self.exp_dir))
            avg = sum(self.results) / len(self.results) if self.results else None
            per_worker = list(self.results)
        result = {"average_metric": avg, "per_worker": per_worker,
                  "num_workers": self.num_workers,
                  "duration_s": job_end - (self.job_start or job_end)}
        self.env.dump(json.dumps(result, indent=2), self.exp_dir + "/result.json")
        self.env.finalize_experiment(self.exp_dir, "FINISHED", {"result": result})
        return result

    def _exp_exception_callback(self, exc) -> None:
        self.env.finalize_experiment(self.exp_dir, "FAILED", {"error": repr(exc)})
        raise exc

    def progress_snapshot(self) -> Dict[str, Any]:
        with self._results_lock:
            return {"workers_done": self._finals, "num_workers": self.num_workers}
