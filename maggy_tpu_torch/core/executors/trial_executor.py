"""Trial-runner executor loop for HPO experiments.

The scalar-trial loop of ``maggy_tpu/core/executors/trial_executor.py``
(parity: reference `maggy/core/executors/trial_executor.py:32-171`):
connect -> register -> start heartbeat -> loop {get_suggestion -> trial dir
+ .hparams.json -> train_fn(**params[, reporter]) -> persist the return ->
on EarlyStopException use its carried metric -> FINAL} until GSTOP. The
FINAL reply usually carries the next assignment, so the get_suggestion at
the top of the loop is wire-free, and every FINAL echoes the run epoch of
its assignment, so the driver can drop a FINAL of a run it requeued. A
``BaseException`` from ``train_fn`` ends the runner: its heartbeats stop,
and the driver's heartbeat-loss scan requeues the trial onto a survivor.
Each executor owns one ``RunnerStats`` (JAX `trial_executor.py:136-200`):
the reporter counts broadcasts into it, the client ships its deltas on the
heartbeats, and each trial runs inside ``warm.trial_scope`` between
``trial_start`` and ``trial_end``.
"""

from __future__ import annotations

import inspect
import traceback
from typing import Callable, Tuple

from maggy_tpu_torch import util
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.core.rpc import Client
from maggy_tpu_torch.exceptions import EarlyStopException
from maggy_tpu_torch.telemetry.runnerstats import RunnerStats
from maggy_tpu_torch.train import warm


class TrialExecutor:
    """The worker each runner (thread or process) executes; picklable when
    ``train_fn`` is, so process pools can send it to a spawned child."""

    def __init__(self, server_addr: Tuple[str, int], secret: str, hb_interval: float,
                 exp_dir: str, optimization_key: str, train_fn: Callable):
        self.server_addr = server_addr
        self.secret = secret
        self.hb_interval = hb_interval
        self.exp_dir = exp_dir
        self.optimization_key = optimization_key
        self.train_fn = train_fn

    def __call__(self, partition_id: int) -> None:
        env = EnvSing.get_instance()
        reporter = Reporter(
            log_file="{}/executor_{}.log".format(self.exp_dir, partition_id))
        client = Client(self.server_addr, partition_id, self.hb_interval, self.secret)
        stats = RunnerStats()
        reporter.stats = stats
        client.runner_stats = stats
        try:
            client.register()
            client.start_heartbeat(reporter)
            wants_reporter = "reporter" in inspect.signature(self.train_fn).parameters
            while not client.done:
                trial_id, params = client.get_suggestion()
                if trial_id is None:
                    break
                trial_dir = "{}/{}".format(self.exp_dir, trial_id)
                env.mkdir(trial_dir)
                env.dump(util.json_dumps_safe(params), trial_dir + "/.hparams.json")
                # The driver-minted span rides the TRIAL info.
                reporter.reset(trial_id=trial_id, span=client.last_info.get("span"))
                stats.trial_start(trial_id)
                call_params = dict(params)
                if wants_reporter:
                    call_params["reporter"] = reporter
                try:
                    with warm.trial_scope(trial_id=trial_id, stats=stats):
                        retval = self.train_fn(**call_params)
                    metric = util.handle_return_val(retval, trial_dir,
                                                    self.optimization_key, env)
                    client.finalize_metric(metric, reporter)
                except EarlyStopException as e:
                    reporter.log("Trial {} early-stopped.".format(trial_id))
                    env.dump(util.json_dumps_safe({self.optimization_key: e.metric}),
                             trial_dir + "/.outputs.json")
                    client.finalize_metric(e.metric, reporter)
                except Exception:  # noqa: BLE001 - report the trial error, keep the runner
                    reporter.log("Trial {} failed:\n{}".format(trial_id, traceback.format_exc()))
                    client.finalize_error(trial_id, reporter)
                finally:
                    stats.trial_end(trial_id)
        finally:
            client.stop()


def trial_executor_fn(**kwargs) -> TrialExecutor:
    """Factory kept for parity with the reference's `trial_executor.py:32`."""
    return TrialExecutor(**kwargs)
