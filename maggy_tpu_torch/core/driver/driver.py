"""Experiment driver base: the control-plane kernel.

The lean counterpart of ``maggy_tpu/core/driver/driver.py`` (parity:
reference `maggy/core/experiment_driver/driver.py` — RPC server +
per-experiment secret (:54-57,74-79), a message queue consumed by a daemon
worker thread dispatching to registered callbacks (:59-61,140-158), and the
lifecycle startup -> register -> serve -> fan out runners -> finalize ->
stop (:81-117)). Runner deaths are survivable once the survivors have
finished the schedule (their trials requeue through heartbeat-loss
detection, ``maggy_tpu/core/driver/driver.py:281-292``). The driver owns
the experiment's telemetry (JAX `driver.py:95-133, :404-423`): the journal
``<exp_dir>/telemetry.jsonl``, attached to the RPC server, with the
``driver_epoch`` and ``experiment`` start/end events, closed on stop.
Chaos, health, observability, fleet leasing and crash recovery (and with
it the journal's resume) of the JAX package are not ported yet.
"""

from __future__ import annotations

import queue
import secrets as pysecrets
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.telemetry import JOURNAL_NAME, Telemetry


class Driver:
    def __init__(self, config, app_id: str, run_id: int):
        self.config = config
        self.app_id = app_id
        self.run_id = run_id
        self.name = config.name
        self.hb_interval = config.hb_interval
        self.env = EnvSing.get_instance()
        self.secret = pysecrets.token_hex(16)
        self.server = self._make_server()
        self.server.attach_driver(self)
        self.server_addr: Optional[tuple] = None
        self._message_q: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self.message_callbacks: Dict[str, Callable[[Dict[str, Any]], None]] = {}
        self.worker_done = False
        # unguarded-ok: monotonic completion latch, polled lock-free by design
        self.experiment_done = False
        self._worker_thread: Optional[threading.Thread] = None
        # The pool running this experiment's runners: heartbeat-loss
        # recovery kills a lost runner through it.
        self._active_pool = None
        self.executor_logs: list = []  # guarded-by: _log_lock
        self._log_lock = threading.Lock()
        self.exception: Optional[BaseException] = None
        self.exp_dir = self.env.register_experiment(
            app_id, run_id, {"name": self.name, "type": type(self).__name__},
            base_dir=config.experiment_dir)
        # Record paths are buffer-only (the journal flushes on its own
        # daemon thread): attaching it costs the message hot path no I/O.
        self.telemetry = Telemetry(env=self.env, journal_path=self.exp_dir + "/" + JOURNAL_NAME,
                                   enabled=config.telemetry)
        self.server.telemetry = self.telemetry
        # The first incarnation, 1-based as in the JAX package: the port has
        # no driver recovery, so it is the only one.
        self.telemetry.event("driver_epoch", epoch=1)
        self.telemetry.event("experiment", phase="start", name=self.name,
                             driver=type(self).__name__, app_id=app_id, run_id=run_id)
        self._register_msg_callbacks()

    # ------------------------------------------------------------- template

    def _make_server(self):
        raise NotImplementedError

    def _make_runner_pool(self):
        raise NotImplementedError

    def _executor_fn(self, train_fn) -> Callable:
        """The worker closure each runner executes (the reference's
        `_patching_fn`, `driver.py:160-162`)."""
        raise NotImplementedError

    def _register_msg_callbacks(self) -> None:
        raise NotImplementedError

    def _exp_startup_callback(self) -> None:
        pass

    def _exp_final_callback(self, job_end: float) -> Any:
        return None

    def _exp_exception_callback(self, exc: BaseException) -> None:
        raise exc

    # ------------------------------------------------------------ lifecycle

    def run_experiment(self, train_fn: Callable) -> Any:
        try:
            self._exp_startup_callback()
            self.server_addr = self.env.connect_host(self.server)
            self._start_worker()
            self._active_pool = self._make_runner_pool()
            # Blocks until every runner returns (foreachPartition semantics).
            failures = self._active_pool.run(self._executor_fn(train_fn))
            job_end = time.time()
            # A callback failure must surface BEFORE finalization, or the
            # experiment would be marked FINISHED with a bogus result.
            if self.exception is not None:
                raise self.exception
            # Dead runners are survivable if the survivors completed the
            # schedule (the dead ones' trials were requeued); otherwise fatal.
            if failures:
                if not self.experiment_done:
                    raise RuntimeError(
                        "{} runner(s) failed and the experiment did not complete: "
                        "{}".format(len(failures), failures)) from failures[0]
                self._log("{} runner(s) died but the experiment completed: {}".format(
                    len(failures), failures))
            return self._exp_final_callback(job_end)
        except BaseException as exc:  # noqa: BLE001 - the driver always cleans up
            self._exp_exception_callback(exc)
        finally:
            self.stop()

    def _start_worker(self) -> None:
        def worker():
            while not self.worker_done:
                try:
                    msg = self._message_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                callback = self.message_callbacks.get(msg.get("type"))
                if callback is None:
                    continue
                try:
                    callback(msg)
                except Exception as exc:  # noqa: BLE001 - surfaced by run_experiment
                    self.fail(exc)

        self._worker_thread = threading.Thread(target=worker, daemon=True, name="driver-worker")
        self._worker_thread.start()

    def fail(self, exc: BaseException) -> None:
        """Record a control-plane failure and end the experiment; the flags
        go up before the (slow) traceback log."""
        self.exception = exc
        self.experiment_done = True
        self._log("driver error: {}".format(traceback.format_exc()))

    def stop(self) -> None:
        self.worker_done = True
        self.experiment_done = True
        if self._worker_thread is not None:
            self._worker_thread.join(timeout=5)
        self.server.stop()
        self.telemetry.event("experiment", phase="end")
        self.telemetry.close()

    # ------------------------------------------------------------- services

    def enqueue(self, msg: Dict[str, Any]) -> None:
        self._message_q.put(msg)

    def get_trial(self, trial_id: str):
        return None

    def progress_snapshot(self) -> Dict[str, Any]:
        return {}

    def _log(self, msg: str) -> None:
        line = "{} ({}/{}): {}".format(
            time.strftime("%Y-%m-%d %H:%M:%S"), self.app_id, self.run_id, msg)
        with self._log_lock:
            try:
                with self.env.open_file(self.exp_dir + "/maggy.log", "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass

    def add_executor_logs(self, logs) -> None:
        if logs:
            with self._log_lock:
                self.executor_logs.extend(logs)
