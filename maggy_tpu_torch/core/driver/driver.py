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

Crash-only recovery (JAX `driver.py:31-36, 50-135, 298-350`): each driver
claims the next incarnation of its run dir (``.driver_epoch.N``, exclusive,
before anything else touches the dir) and journals that epoch. A resumed
driver (``config.resume``) reads the dead incarnation's
``driver_state.json`` and comes back on its secret and its port, so runners
that outlived it keep authenticating and reconnecting; it reloads the
journal (dropping a torn tail line on its next flush), rebuilds the trial
spans from it and journals ``experiment`` ``resumed``. A pre-crash port
still bound means the previous incarnation is alive: the resume refuses
with ``RunAdoptionError``.

Fault injection, health and observability (JAX `driver.py:136-222,
395-459`): a plan named by ``config.chaos`` or MAGGY_TPU_CHAOS arms a
``ChaosEngine`` (telemetry required), which the driver attaches to the
reservations, itself and, once built, the runner pool; the ``chaos_armed``
event opens the run and ``chaos_summary`` closes it. The live health engine
(``config.health``, on by default) starts on the reservations. With
``config.obs_port`` (or MAGGY_TPU_OBS_PORT) the experiment registers with the
process obs server (``obs_started`` names its address), and the health
engine's first straggler or hang flag per partition captures a
torch.profiler trace (the profiler is started and stopped once first, so
that capture does not pay its one-time start-up while runners step).

Fleet mode (``config.fleet``, JAX `driver.py:255-306`): the driver publishes
its server on the fleet's shared listener instead of binding its own, and
leases its runners from the fleet's scheduler (``binding.lease_pool``)
instead of owning a pool.
"""

from __future__ import annotations

import json
import os
import queue
import secrets as pysecrets
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from maggy_tpu_torch import util
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.exceptions import RunAdoptionError
from maggy_tpu_torch.telemetry import JOURNAL_NAME, Telemetry

#: The run's control-plane identity, written into the experiment dir once
#: the server is bound: its secret and (host, port). A resumed driver reads
#: it to come back on the same secret and address.
DRIVER_STATE_FILE = "driver_state.json"


class Driver:
    def __init__(self, config, app_id: str, run_id: int):
        self.config = config
        self.app_id = app_id
        self.run_id = run_id
        self.name = config.name
        self.description = config.description
        self.hb_interval = config.hb_interval
        self.env = EnvSing.get_instance()
        # The incarnation claim comes before anything touches the run dir:
        # the loser of a race between two resuming drivers exits here,
        # before it could overwrite the interrupted run's metadata.
        base = config.experiment_dir or self.env.experiment_base_dir()
        run_dir = "{}/{}_{}".format(base.rstrip("/"), app_id, run_id)
        self.driver_epoch = util.claim_driver_epoch(run_dir, self.env)
        resume = bool(getattr(config, "resume", False))
        # The interrupted incarnation's identity: its secret keeps live
        # runners' frames verifying against this server.
        self.driver_state: Optional[Dict[str, Any]] = None
        state_path = run_dir + "/" + DRIVER_STATE_FILE
        if resume and self.env.exists(state_path):
            try:
                self.driver_state = json.loads(self.env.load(state_path))
            except ValueError:
                self.driver_state = None  # torn write: a fresh identity
        self.secret = (self.driver_state or {}).get("secret") or pysecrets.token_hex(16)
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
        # maggy.log's lines on an environment without append (object
        # stores), loaded at the first line.
        self._store_log: Optional[list] = None  # guarded-by: _log_lock
        self.exception: Optional[BaseException] = None
        self.exp_dir = self.env.register_experiment(
            app_id, run_id, {"name": self.name, "description": self.description,
                             "type": type(self).__name__},
            base_dir=config.experiment_dir)
        # Record paths are buffer-only (the journal flushes on its own
        # daemon thread): attaching it costs the message hot path no I/O.
        # A fleet tenant with ``config.sink`` ships its journal to the
        # fleet's journal sink as source <tenant name>; the local path is
        # then the shipper's fallback (JAX `driver.py:101-115`).
        sink_binding = sink_source = None
        fleet_binding = getattr(config, "fleet", None)
        if fleet_binding is not None and getattr(config, "sink", False):
            sink_binding = fleet_binding.fleet.sink_binding()
            sink_source = fleet_binding.entry.name
        self.telemetry = Telemetry(env=self.env, journal_path=self.exp_dir + "/" + JOURNAL_NAME,
                                   enabled=config.telemetry, sink=sink_binding,
                                   sink_source=sink_source)
        self.server.telemetry = self.telemetry
        if resume:
            # One journal across interruptions: its replay covers the whole
            # logical experiment. Restored trials keep their pre-crash span
            # ids, so later phase events continue the same spans.
            restored = 0
            if self.telemetry.journal is not None:
                restored = self.telemetry.journal.load_existing()
            self.telemetry.restore_spans()
            self.telemetry.event("experiment", phase="resumed", restored_events=restored)
        # The incarnation boundary recovery splits a journal on.
        self.telemetry.event("driver_epoch", epoch=self.driver_epoch)
        self.telemetry.event("experiment", phase="start", name=self.name,
                             driver=type(self).__name__, app_id=app_id, run_id=run_id)
        self.chaos = self._arm_chaos(config)
        self.health = None
        if self.telemetry.enabled and config.health:
            from maggy_tpu_torch.telemetry.health import HealthEngine

            self.health = HealthEngine(self.telemetry, hb_interval=self.hb_interval,
                                       interval_s=config.health_interval_s,
                                       hang_factor=config.health_hang_factor)
            self.health.attach(reservations=self.server.reservations)
            self.telemetry.health = self.health
            self.health.start()
        self.obs_registration = None
        self.profiler = None
        obs_port = config.resolved_obs_port()
        if obs_port is not None and self.telemetry.enabled:
            self._register_obs(obs_port, config.obs_host)
        self._register_msg_callbacks()

    def _arm_chaos(self, config):
        """The armed ChaosEngine of the plan named by ``config.chaos`` (a
        FaultPlan or a plan-JSON path) or MAGGY_TPU_CHAOS, else None."""
        plan_src = config.chaos or os.environ.get("MAGGY_TPU_CHAOS")
        if not plan_src:
            return None
        from maggy_tpu_torch.chaos import ChaosEngine, FaultPlan, arm

        if not self.telemetry.enabled:
            # No phase events to trigger on and no journal for the
            # injections: the plan would be a silent no-op.
            raise ValueError(
                "chaos fault injection requires telemetry=True: on_phase triggers ride "
                "trial-span events and every injection must be journaled for the "
                "recovery invariants to be checkable")
        plan = plan_src if isinstance(plan_src, FaultPlan) \
            else FaultPlan.load(plan_src, env=self.env)
        engine = ChaosEngine(plan, telemetry=self.telemetry)
        engine.attach(reservations=self.server.reservations, driver=self)
        self.telemetry.chaos_hook = engine.on_trial_phase
        arm(engine)
        self.telemetry.event("chaos_armed", seed=plan.seed, specs=len(plan.specs))
        return engine

    def _register_obs(self, port: int, host: str) -> None:
        """Join the process obs server; the health engine gains the
        auto-capture hook."""
        from maggy_tpu_torch.telemetry import obs as obs_mod
        from maggy_tpu_torch.telemetry.profiling import ProfileCapturer

        self.profiler = ProfileCapturer(self.telemetry, profile_dir=self.exp_dir + "/profiles")
        primed_s = self.profiler.prime()
        if self.health is not None:
            self.health.attach(profiler=self.profiler)
        run = "{}/{}".format(self.app_id, self.run_id)
        self.obs_registration = obs_mod.ObsRegistration(
            key=run, labels={"experiment": self.name, "run": run}, telemetry=self.telemetry,
            status_fn=self.obs_status, health=self.health, profiler=self.profiler)
        server = obs_mod.register(self.obs_registration, port=port, host=host)
        # Port 0 binds an ephemeral port: the journal is where tools learn
        # the real address.
        self.telemetry.event("obs_started", host=server.address[0], port=server.address[1],
                             experiment=self.name, app_id=self.app_id, run_id=self.run_id,
                             profiler_primed_s=primed_s)

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

    def _after_runners(self) -> None:
        """Called once every runner has returned, before the outcome is
        judged."""

    def _exp_final_callback(self, job_end: float) -> Any:
        return None

    def _exp_exception_callback(self, exc: BaseException) -> None:
        raise exc

    # ------------------------------------------------------------ lifecycle

    def _start_progress_printer(self) -> None:
        """``verbose``: a live progress line on stdout, printed when it
        changes, once a second (JAX `driver.py:356-371`)."""
        from maggy_tpu_torch import monitor

        def printer():
            last = None
            while not self.worker_done:
                line = monitor.render(self.progress_snapshot())
                if line != last:
                    print("[{}] {}".format(self.name, line), flush=True)
                    last = line
                time.sleep(1.0)

        threading.Thread(target=printer, daemon=True, name="progress-printer").start()

    def run_experiment(self, train_fn: Callable) -> Any:
        try:
            self._exp_startup_callback()
            self._bind()
            self._start_worker()
            if self.config.verbose:
                self._start_progress_printer()
            # A fleet tenant leases runners from the fleet's scheduler; the
            # leased pool blocks until the experiment completes, as a
            # pool's run does.
            binding = getattr(self.config, "fleet", None)
            self._active_pool = binding.lease_pool(self) if binding is not None \
                else self._make_runner_pool()
            if self.chaos is not None:
                # Kill and stall faults act through the pool.
                self.chaos.attach(pool=self._active_pool)
            # Blocks until every runner returns (foreachPartition semantics).
            failures = self._active_pool.run(self._executor_fn(train_fn))
            job_end = time.time()
            self._after_runners()
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

    def _bind(self) -> None:
        """Bind the control-plane server (a resumed driver on the pre-crash
        port, so that runners' reconnect loops land on it), then persist
        the identity a later incarnation needs."""
        prev_port = int((self.driver_state or {}).get("port") or 0)
        binding = getattr(self.config, "fleet", None)
        try:
            if binding is not None:
                # A fleet tenant's traffic shares the fleet's one listener,
                # routed by the secret that authenticates each frame.
                self.server_addr = binding.attach_server(self.server)
            else:
                self.server_addr = self.env.connect_host(
                    self.server, host=getattr(self.config, "bind_host", None), port=prev_port)
        except OSError as e:
            if prev_port == 0:
                raise
            # The epoch marker arbitrates racing adopters; a still-bound
            # port is a predecessor that claimed earlier and never exited.
            raise RunAdoptionError(
                "cannot adopt run {}: the pre-crash control-plane port {} is still bound "
                "({}) — the prior driver incarnation appears to be alive. If an unrelated "
                "process holds the port, delete {}/{} and resume on a fresh port".format(
                    self.exp_dir, prev_port, e, self.exp_dir, DRIVER_STATE_FILE)) from e
        try:
            self.env.dump(json.dumps({
                "secret": self.secret, "host": self.server_addr[0],
                "port": int(self.server_addr[1]), "driver_epoch": self.driver_epoch,
                "os_pid": os.getpid()}), self.exp_dir + "/" + DRIVER_STATE_FILE)
        except Exception:  # noqa: BLE001 - the identity mirror must not kill a run
            pass

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
        if self.obs_registration is not None:
            # Before the telemetry closes: a scrape landing mid-stop must
            # not read a closing journal.
            from maggy_tpu_torch.telemetry import obs as obs_mod

            obs_mod.deregister(self.obs_registration)
            self.obs_registration = None
        if self.health is not None:
            self.health.close()
        if self.profiler is not None:
            # A capture the last flag started ends before the journal does.
            self.profiler.join()
        self.server.stop()
        if self.chaos is not None:
            from maggy_tpu_torch.chaos import disarm

            self.telemetry.event("chaos_summary", **self.chaos.summary())
            # Only if this engine is the armed one.
            disarm(self.chaos)
        self.telemetry.event("experiment", phase="end")
        self.telemetry.close()

    # ------------------------------------------------------------- services

    def enqueue(self, msg: Dict[str, Any]) -> None:
        self._message_q.put(msg)

    def secret_for_clients(self) -> str:
        """The secret runners authenticate with: what a join ticket carries."""
        return self.server.secret_hex

    def get_trial(self, trial_id: str):
        return None

    def progress_snapshot(self) -> Dict[str, Any]:
        return {}

    def obs_status(self) -> Dict[str, Any]:
        """Live control-plane state for the obs /status route (JAX
        `driver.py:439-459`): progress and the reservation table. Read-only
        and lock-brief: it runs on an obs handler thread."""
        progress = {k: v for k, v in self.progress_snapshot().items()
                    if k not in ("log_tail", "log_total")}
        reservations = {pid: {"trial": rec.get("trial_id"), "released": bool(rec.get("released")),
                              "capacity": rec.get("capacity")}
                        for pid, rec in self.server.reservations.all().items()}
        return {"experiment": self.name, "app_id": self.app_id, "run_id": self.run_id,
                "driver": type(self).__name__, "done": self.experiment_done,
                "progress": progress, "reservations": reservations}

    def _log(self, msg: str) -> None:
        line = "{} ({}/{}): {}\n".format(
            time.strftime("%Y-%m-%d %H:%M:%S"), self.app_id, self.run_id, msg)
        path = self.exp_dir + "/maggy.log"
        with self._log_lock:
            try:
                if self.env.FAST_LOCAL_WRITES:
                    with self.env.open_file(path, "a") as f:
                        f.write(line)
                    return
                # An object store has no append (GCSEnv refuses it): the
                # log, a resumed run's earlier lines first, is rewritten
                # whole.
                if self._store_log is None:
                    self._store_log = [self.env.load(path)] if self.env.exists(path) else []
                self._store_log.append(line)
                self.env.dump("".join(self._store_log), path)
            except OSError:
                pass

    def add_executor_logs(self, logs) -> None:
        if logs:
            with self._log_lock:
                self.executor_logs.extend(logs)
