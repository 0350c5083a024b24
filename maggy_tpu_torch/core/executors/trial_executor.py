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

Ablation trials (``trial_type="ablation"``, JAX `trial_executor.py:92,
105, 212-216`): the assignment's declarative spec ({"ablated_feature",
"ablated_layer", "model_key"}) goes through ``ablation_resolver`` before
the call, so the train function receives ``dataset_function`` and
``model_function`` (``ablation/ablator/loco.py``).

Vectorized blocks (``config.vmap_lanes``; JAX `trial_executor.py:183-190,
361-545`): an assignment stamped ``vmap_block`` delivers K lane trials at
once. Each lane gets its own trial dir and ``.hparams.json``; a train
function that names ``lanes`` runs them as one ``LaneSet`` (one vmapped
step, ``train/vmap.py``) and returns a dict of metrics by lane trial id or
a sequence in lane order; one without it runs them one after another as
scalar trials. Either way every lane sends its own FINAL with its own run
epoch, and only the last releases the partition.

Gangs and elastic runners (JAX `trial_executor.py:110-113, 144-180,
550-585`): an assignment stamped ``gang`` of more than one chip without a
rendezvous block is an in-process gang, and this runner is its leader: the
trial runs in one rank process per chip (``gang.run_gang_ranks``), rank
0's result is this trial's FINAL. A gang of agents (``rendezvous``) runs
here, the agent being a rank; a member served ``gang_role="member"`` joins
the world, runs the program, discards the result and sends no FINAL. An
elastic runner registers its lease's capacity and, told to RESIZE, writes
the new size to its resize file and exits for the pool to respawn it.

Per-trial profiles and print shipping (JAX `trial_executor.py:34-70,
583-620`): with ``profile`` a trial runs inside ``profiling.trial_profile``
(a torch.profiler trace into ``<trial dir>/tensorboard/``, the trial's
TensorBoard logdir, one a process; a
trial that finds the profiler taken runs untraced and its runner stats
carry ``profile_skipped``, journaled as that trial event); with
``ship_prints`` the train function's ``print`` calls are teed into the
reporter log through a thread-scoped tee, so thread runners that share
``builtins.print`` ship only their own trial's lines. An in-process gang's
rank 0 runs its trial the same way, in its own process: traced into the
trial dir, its prints shipped through the leader's relay.
"""

from __future__ import annotations

import inspect
import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional, Tuple

from maggy_tpu_torch import gang as gang_mod
from maggy_tpu_torch import tensorboard, util
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.core.executors.context import (LaneSet, TrialContext,
                                                    info_needs_fresh_state)
from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.core.rpc import RESIZE, Client
from maggy_tpu_torch.core.runner_pool import CAPACITY_ENV, RESIZE_FILE_ENV
from maggy_tpu_torch.exceptions import EarlyStopException
from maggy_tpu_torch.telemetry import profiling
from maggy_tpu_torch.telemetry.runnerstats import RunnerStats
from maggy_tpu_torch.train import warm
from maggy_tpu_torch.train.checkpoint import fork_checkpoint, latest_checkpoint_step

# ship_prints: builtins.print is a process global shared by thread runners,
# so the tee dispatches through a thread-local; only a thread inside a
# shipping trial has a reporter set. Installed once, never removed (the
# pass-through costs nothing).
_print_ship = threading.local()
_print_tee_lock = threading.Lock()
_orig_print = None


def _install_print_tee() -> None:
    global _orig_print
    with _print_tee_lock:
        if _orig_print is not None:
            return
        import builtins

        _orig_print = builtins.print

        def tee_print(*args, **kwargs):
            _orig_print(*args, **kwargs)
            reporter = getattr(_print_ship, "reporter", None)
            if reporter is not None and kwargs.get("file") in (None, sys.stdout):
                try:
                    reporter.log(str(kwargs.get("sep", " ")).join(str(a) for a in args))
                except Exception:  # noqa: BLE001 - shipping must never break print
                    pass

        builtins.print = tee_print


def call_train_fn(train_fn: Callable, call_params: dict, trial_dir: str, reporter,
                  profile: bool = False, ship_prints: bool = False,
                  on_untraced: Optional[Callable[[], None]] = None):
    """Call the train function, with its prints teed into ``reporter``
    (``ship_prints``) and under a per-trial trace in ``trial_dir``
    (``profile``; ``on_untraced`` runs when the process's profiler is
    taken and the trial runs untraced). A runner's trial and an in-process
    gang's rank 0 (``gang.run_gang_ranks``) run through it."""
    if ship_prints:
        _install_print_tee()
        _print_ship.reporter = reporter
    try:
        if not profile:
            return train_fn(**call_params)
        with profiling.trial_profile(os.path.join(trial_dir, profiling.TRIAL_PROFILE_DIR)) \
                as path:
            if path is None:
                if on_untraced is not None:
                    on_untraced()
                reporter.log("profiler busy (another trial or capture holds it); "
                             "trial runs untraced")
            return train_fn(**call_params)
    finally:
        _print_ship.reporter = None


class TrialExecutor:
    """The worker each runner (thread or process) executes; picklable when
    ``train_fn`` is, so process pools can send it to a spawned child."""

    def __init__(self, server_addr: Tuple[str, int], secret: str, hb_interval: float,
                 exp_dir: str, optimization_key: str, train_fn: Callable,
                 warm_start: bool = True, trial_type: str = "optimization",
                 ablation_resolver: Optional[Callable] = None, profile: bool = False,
                 ship_prints: bool = False, host_port: Optional[str] = None):
        self.server_addr = server_addr
        self.secret = secret
        self.hb_interval = hb_interval
        self.exp_dir = exp_dir
        self.optimization_key = optimization_key
        self.train_fn = train_fn
        self.warm_start = warm_start
        self.trial_type = trial_type
        self.ablation_resolver = ablation_resolver
        self.profile = profile
        self.ship_prints = ship_prints
        #: The "host:port" this runner's gang world may be reached at (a
        #: fleet agent's reserved rendezvous address); None for runners of
        #: this process. Its presence in the REG record is how the driver
        #: tells a remote member from a thread runner.
        self.host_port = host_port

    def __call__(self, partition_id: int) -> None:
        env = EnvSing.get_instance()
        reporter = Reporter(
            log_file="{}/executor_{}.log".format(self.exp_dir, partition_id))
        client = Client(self.server_addr, partition_id, self.hb_interval, self.secret)
        stats = RunnerStats()
        reporter.stats = stats
        client.runner_stats = stats
        try:
            capacity = os.environ.get(CAPACITY_ENV)
            client.register(host_port=self.host_port,
                            capacity=int(capacity) if capacity else None)
            client.start_heartbeat(reporter)
            sig_params = inspect.signature(self.train_fn).parameters
            wants_reporter, wants_ctx = "reporter" in sig_params, "ctx" in sig_params
            while not client.done:
                trial_id, params = client.get_suggestion()
                if trial_id is None:
                    break
                if trial_id == RESIZE:
                    # The elastic pool respawns this partition pinned to
                    # params["chips"] chips (0: retired).
                    resize_file = os.environ.get(RESIZE_FILE_ENV)
                    if resize_file:
                        with open(resize_file, "w") as f:
                            json.dump({"chips": params["chips"]}, f)
                    reporter.log("resizing to {} chip(s); runner exiting for respawn".format(
                        params["chips"]))
                    break
                if client.last_info.get("gang_role") == "member":
                    self._run_gang_member(trial_id, params, client, reporter)
                    continue
                if client.last_info.get("vmap_block"):
                    self._run_vmap_block(trial_id, params, client, reporter, stats, env,
                                         sig_params)
                    continue
                trial_dir = "{}/{}".format(self.exp_dir, trial_id)
                env.mkdir(trial_dir)
                env.dump(util.json_dumps_safe(params), trial_dir + "/.hparams.json")
                # The driver-minted span rides the TRIAL info.
                reporter.reset(trial_id=trial_id, span=client.last_info.get("span"))
                stats.trial_start(trial_id)
                gang = client.last_info.get("gang")
                in_process_gang = bool(gang and len(gang.get("chips") or ()) > 1
                                       and not gang.get("rendezvous"))
                try:
                    # Per-trial TensorBoard logdir and hparams record (JAX
                    # `trial_executor.py:200-208`). An in-process gang's
                    # rank 0 writes its trial's session in its own process.
                    if in_process_gang:
                        tensorboard._close()
                    else:
                        tensorboard._register(os.path.join(trial_dir, "tensorboard"))
                        tensorboard.write_hparams(params)
                except Exception:  # noqa: BLE001 - TB must never kill a trial
                    pass
                call_params = dict(params)
                if self.trial_type == "ablation":
                    # Declarative spec -> the study's generators.
                    call_params = self.ablation_resolver(call_params)
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
                    if in_process_gang:
                        # An in-process gang: this runner leads its ranks.
                        retval = gang_mod.run_gang_ranks(
                            self.train_fn, dict(params), dict(client.last_info), reporter,
                            trial_id, trial_dir, self.exp_dir, wants_reporter, wants_ctx,
                            profile=self.profile, ship_prints=self.ship_prints)
                    else:
                        with warm.trial_scope(trial_id=trial_id, enabled=self.warm_start,
                                              stats=stats, fresh_state=info_needs_fresh_state(
                                                  client.last_info)):
                            retval = self._run_trial(call_params, trial_id, trial_dir,
                                                     reporter, stats)
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
            try:
                # Close the last trial's TensorBoard session: its session end
                # record, and the event file flushed (JAX
                # `trial_executor.py:305-314`).
                tensorboard._close()
            except Exception:  # noqa: BLE001
                pass
            client.stop()

    def _run_gang_member(self, trial_id: str, params: dict, client, reporter) -> None:
        """A remote gang member's side of a gang trial: every process of the
        world runs the same program, or the leader's collectives hang. It
        joins the world, runs the program with no reporter, discards the
        result and sends no FINAL (the leader sends the one FINAL). A
        failure is logged: the leader's world fails with it, and the
        driver's member-loss path owns the recovery."""
        trial_dir = "{}/{}".format(self.exp_dir, trial_id)
        try:
            ctx = TrialContext(trial_id, trial_dir, self.exp_dir, params, client.last_info)
            gang = ctx.gang
            if gang is None:
                return
            gang.ensure_rendezvous()
            call_params = dict(params)
            sig_params = inspect.signature(self.train_fn).parameters
            if "ctx" in sig_params:
                call_params["ctx"] = ctx
            if "reporter" in sig_params:
                call_params["reporter"] = None
            self.train_fn(**call_params)
        except Exception:  # noqa: BLE001 - a member's failure surfaces in the leader's world
            reporter.log("gang member program for {} failed:\n{}".format(
                trial_id, traceback.format_exc()))

    # ------------------------------------------------------ vectorized blocks

    def _run_vmap_block(self, leader_id: str, params: dict, client, reporter, stats, env,
                        sig_params) -> None:
        """Run a K-lane block: one delivery, K trials. A train function that
        names ``lanes`` trains them as one ``LaneSet``; otherwise they run
        one after another (``_run_block_sequential``). Each lane sends its
        own FINAL; the last (``last=True``) releases the partition and banks
        the piggybacked next assignment (JAX `:361-451`)."""
        info = client.last_info
        lane_descs = list((info.get("vmap_block") or {}).get("lanes") or ())
        if not lane_descs:
            client.finalize_error(leader_id, reporter)
            return
        for entry in lane_descs:
            lane_dir = "{}/{}".format(self.exp_dir, entry["trial_id"])
            env.mkdir(lane_dir)
            env.dump(util.json_dumps_safe(entry.get("params") or {}), lane_dir + "/.hparams.json")
        if "lanes" not in sig_params:
            self._run_block_sequential(leader_id, lane_descs, client, reporter, stats, env,
                                       sig_params)
            return
        reporter.reset_lanes(leader_id, info.get("span"), lane_descs)
        stats.trial_start(leader_id)
        finalized = []

        def finalize(entry, metric, last=False, error=False):
            if entry["trial_id"] in finalized:
                return
            finalized.append(entry["trial_id"])
            # A lane the function returned no metric for counts as failed.
            metric = None if metric is None else float(metric)
            error = error or metric is None
            if not error:
                lane_dir = "{}/{}".format(self.exp_dir, entry["trial_id"])
                env.dump(util.json_dumps_safe({self.optimization_key: metric}),
                         lane_dir + "/.outputs.json")
                env.dump(str(float(metric)), lane_dir + "/.metric")
            client.finalize_lane(entry["trial_id"], metric, reporter, lane=entry.get("lane", 0),
                                 block=leader_id, epoch=entry.get("epoch"), last=last,
                                 error=error)

        call_params = dict(params)
        call_params["lanes"] = LaneSet(lane_descs, reporter, finalize)
        if "reporter" in sig_params:
            call_params["reporter"] = reporter
        try:
            with warm.trial_scope(trial_id=leader_id, enabled=self.warm_start, stats=stats):
                retval = self._run_trial(call_params, leader_id,
                                         "{}/{}".format(self.exp_dir, leader_id), reporter,
                                         stats)
            metrics = self._lane_metrics(retval, lane_descs)
            remaining = [e for e in lane_descs if e["trial_id"] not in finalized]
            for i, entry in enumerate(remaining):
                finalize(entry, metrics.get(entry["trial_id"]), last=i == len(remaining) - 1)
            if not remaining:
                # Every lane retired mid-block: a release-shaped FINAL (the
                # leader's id again, which the driver drops as a duplicate)
                # frees the partition.
                client.finalize_lane(leader_id, None, reporter, lane=0, block=leader_id,
                                     epoch=lane_descs[0].get("epoch"), last=True)
        except EarlyStopException:
            if reporter.take_preempt():
                reporter.log("Block {} preempted; all lanes requeue.".format(leader_id))
                client.preempt_ack(leader_id, reporter, step=None)
            else:
                self._error_out_lanes(leader_id, lane_descs, finalized, client, reporter)
        except Exception:  # noqa: BLE001 - report the block error, keep the runner
            reporter.log("Block {} failed:\n{}".format(leader_id, traceback.format_exc()))
            self._error_out_lanes(leader_id, lane_descs, finalized, client, reporter)
        finally:
            stats.trial_end(leader_id)

    def _lane_metrics(self, retval, lane_descs) -> dict:
        """A lanes train function's return as {trial_id: metric}: a dict by
        lane trial id, or a sequence in lane order."""
        if isinstance(retval, dict):
            return {e["trial_id"]: retval.get(e["trial_id"]) for e in lane_descs}
        if isinstance(retval, (list, tuple)) and len(retval) == len(lane_descs):
            return {e["trial_id"]: float(v) for e, v in zip(lane_descs, retval)}
        from maggy_tpu_torch.exceptions import ReturnTypeError

        raise ReturnTypeError(self.optimization_key, retval)

    def _error_out_lanes(self, leader_id, lane_descs, finalized, client, reporter) -> None:
        """FINAL every unfinalized lane as an error (the last releases the
        partition), or the release-shaped FINAL when none is left."""
        remaining = [e for e in lane_descs if e["trial_id"] not in finalized]
        for i, entry in enumerate(remaining):
            finalized.append(entry["trial_id"])
            client.finalize_lane(entry["trial_id"], None, reporter, lane=entry.get("lane", 0),
                                 block=leader_id, epoch=entry.get("epoch"),
                                 last=i == len(remaining) - 1, error=True)
        if not remaining:
            client.finalize_lane(leader_id, None, reporter, lane=0, block=leader_id,
                                 epoch=lane_descs[0].get("epoch"), last=True)

    def _run_block_sequential(self, leader_id: str, lane_descs, client, reporter, stats, env,
                              sig_params) -> None:
        """A block whose train function takes no ``lanes``: each lane runs as
        an ordinary scalar trial on this runner, back to back, with its own
        reporter reset and FINAL (JAX `:490-545`)."""
        for i, entry in enumerate(lane_descs):
            tid = entry["trial_id"]
            last = i == len(lane_descs) - 1
            lane = entry.get("lane", i)
            lane_dir = "{}/{}".format(self.exp_dir, tid)
            reporter.reset(trial_id=tid, span=entry.get("span"))
            stats.trial_start(tid)
            call_params = dict(entry.get("params") or {})
            if "reporter" in sig_params:
                call_params["reporter"] = reporter
            try:
                with warm.trial_scope(trial_id=tid, enabled=self.warm_start, stats=stats):
                    retval = self._run_trial(call_params, tid, lane_dir, reporter, stats)
                metric = util.handle_return_val(retval, lane_dir, self.optimization_key, env)
                client.finalize_lane(tid, metric, reporter, lane=lane, block=leader_id,
                                     epoch=entry.get("epoch"), last=last)
            except EarlyStopException as e:
                if reporter.take_preempt():
                    client.preempt_ack(leader_id, reporter, step=None)
                    return
                env.dump(util.json_dumps_safe({self.optimization_key: e.metric}),
                         lane_dir + "/.outputs.json")
                client.finalize_lane(tid, e.metric, reporter, lane=lane, block=leader_id,
                                     epoch=entry.get("epoch"), last=last)
            except Exception:  # noqa: BLE001 - report the lane error, run the rest
                reporter.log("Lane trial {} failed:\n{}".format(tid, traceback.format_exc()))
                client.finalize_lane(tid, None, reporter, lane=lane, block=leader_id,
                                     epoch=entry.get("epoch"), last=last, error=True)
            finally:
                stats.trial_end(tid)

    def _run_trial(self, call_params: dict, trial_id: str, trial_dir: str, reporter,
                   stats):
        """``call_train_fn`` with this executor's ``profile`` and
        ``ship_prints``."""
        return call_train_fn(self.train_fn, call_params, trial_dir, reporter,
                             profile=self.profile, ship_prints=self.ship_prints,
                             on_untraced=lambda: stats.note_profile_skipped(trial_id))

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
