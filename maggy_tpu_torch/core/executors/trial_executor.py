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
``trial_start`` and ``trial_end``: armed by ``warm_start``
(``config.warm_start``, JAX `trial_executor.py:95-129, 246-256`), its
Trainers share warm slots and retire their units at scope exit.

Checkpoint forking and graceful preemption (JAX `trial_executor.py:152,
217-281, 317-360`): a ``train_fn`` that names ``ctx`` gets a
``TrialContext``; an assignment stamped ``forked_from`` has its parent's
checkpoint staged into the trial dir before the call (a vanished source
downgrades the trial to a from-scratch run), the staging time lands in the
stats as ``fork_load_ms``; and an ``EarlyStopException`` that a preempting
STOP raised is acked with the trial's last checkpoint step instead of being
finalized.
"""

from __future__ import annotations

import inspect
import time
import traceback
from typing import Callable, Tuple

from maggy_tpu_torch import util
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.core.executors.context import TrialContext, info_needs_fresh_state
from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.core.rpc import Client
from maggy_tpu_torch.exceptions import EarlyStopException
from maggy_tpu_torch.telemetry.runnerstats import RunnerStats
from maggy_tpu_torch.train import warm
from maggy_tpu_torch.train.checkpoint import fork_checkpoint, latest_checkpoint_step


class TrialExecutor:
    """The worker each runner (thread or process) executes; picklable when
    ``train_fn`` is, so process pools can send it to a spawned child."""

    def __init__(self, server_addr: Tuple[str, int], secret: str, hb_interval: float,
                 exp_dir: str, optimization_key: str, train_fn: Callable,
                 warm_start: bool = True):
        self.server_addr = server_addr
        self.secret = secret
        self.hb_interval = hb_interval
        self.exp_dir = exp_dir
        self.optimization_key = optimization_key
        self.train_fn = train_fn
        self.warm_start = warm_start

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
            sig_params = inspect.signature(self.train_fn).parameters
            wants_reporter, wants_ctx = "reporter" in sig_params, "ctx" in sig_params
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
                ctx = None
                try:
                    if wants_ctx:
                        ctx = TrialContext(trial_id, trial_dir, self.exp_dir, params,
                                           client.last_info)
                        call_params["ctx"] = ctx
                    if client.last_info.get("forked_from"):
                        self._stage_fork(ctx, trial_id, trial_dir, client, reporter, stats)
                    # Inside the scope the trial's Trainers take the warm
                    # path (config.warm_start) and note into this runner's
                    # stats; at its exit their units retire into their warm
                    # slots. A trial that continues saved state restores it
                    # from its checkpoint into fresh state.
                    with warm.trial_scope(trial_id=trial_id, enabled=self.warm_start,
                                          stats=stats,
                                          fresh_state=info_needs_fresh_state(client.last_info)):
                        retval = self.train_fn(**call_params)
                    metric = util.handle_return_val(retval, trial_dir,
                                                    self.optimization_key, env)
                    client.finalize_metric(metric, reporter)
                except EarlyStopException as e:
                    if reporter.take_preempt():
                        # A scheduler preemption, not an early-stop verdict:
                        # ack with the last checkpoint step, so the driver
                        # requeues the trial to resume there (none: from
                        # scratch).
                        step = latest_checkpoint_step(trial_dir)
                        reporter.log("Trial {} preempted{}.".format(
                            trial_id, " at checkpoint step {}".format(step) if step is not None
                            else " (no checkpoint; re-runs from scratch)"))
                        client.preempt_ack(trial_id, reporter, step=step)
                    else:
                        reporter.log("Trial {} early-stopped.".format(trial_id))
                        env.dump(util.json_dumps_safe({self.optimization_key: e.metric}),
                                 trial_dir + "/.outputs.json")
                        client.finalize_metric(e.metric, reporter)
                except Exception:  # noqa: BLE001 - report the trial error, keep the runner
                    reporter.log("Trial {} failed:\n{}".format(trial_id, traceback.format_exc()))
                    client.finalize_error(trial_id, reporter)
                finally:
                    stats.trial_end(trial_id)
                    if ctx is not None:
                        ctx.close()
        finally:
            client.stop()

    def _stage_fork(self, ctx, trial_id: str, trial_dir: str, client, reporter,
                    stats) -> None:
        """Stage a forked trial's parent checkpoint into its trial dir
        (idempotent: a requeued fork re-stages the same step). A parent
        checkpoint that is gone downgrades the trial to a from-scratch run:
        the fork keys leave the assignment info, so ``ctx.resume_step``
        reads None and the train function opens no checkpoint that is not
        there. Any other failure of the copy (a full disk, a permission)
        raises and fails the trial; the JAX executor
        (``maggy_tpu/core/executors/trial_executor.py:317-360``) downgrades
        on those too."""
        fork = dict(client.last_info.get("forked_from") or {})
        t0 = time.monotonic()
        staged = ctx.stage_fork() if ctx is not None else fork_checkpoint(
            EnvSing.get_instance(), self.exp_dir, fork.get("trial"), trial_dir,
            step=fork.get("step"))
        if staged is None:
            reporter.log("Trial {}: fork source {} step {} unavailable; running from "
                         "scratch.".format(trial_id, fork.get("trial"), fork.get("step")))
            for key in ("forked_from", "resume_step"):
                client.last_info.pop(key, None)
                if ctx is not None:
                    ctx.info.pop(key, None)
            return
        ms = (time.monotonic() - t0) * 1e3
        stats.note_compile(fork_load_ms=ms, forked=True)
        reporter.log("Trial {} forked from {} at checkpoint step {} ({}ms load).".format(
            trial_id, fork.get("trial"), staged, round(ms, 1)))


def trial_executor_fn(**kwargs) -> TrialExecutor:
    """Factory kept for parity with the reference's `trial_executor.py:32`."""
    return TrialExecutor(**kwargs)
