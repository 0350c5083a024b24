"""Chaos soak harness: run a lagom experiment under a fault plan, then
replay the telemetry journal and check the recovery invariants.

The port's copy of ``maggy_tpu/chaos/harness.py``. ``check_invariants`` is
ported whole (``maggy_tpu/chaos/harness.py:943-1541``): a pure function over
journal events, so it reads a journal of either package, the gang, fleet and
driver-failover invariants included. The invariants, stated in full in the
JAX module's docstring:

1.  no trial lost: every queued trial finalizes;
2.  no duplicate FINAL;
3.  bounded requeue: a runner-death fault's trial requeues within the bound;
4.  the experiment completes;
5.  a stall is flagged: every ``stall_runner`` fault draws a health
    ``hang``/``straggler`` flag for its partition within the bound (when the
    journal says a health engine ran);
6.  exactly-once requeue: N runner-death faults on a trial, at most N
    requeues (the piggybacked hand-off's window included);
7.  a graceful preemption resumes from the acked checkpoint step;
8.  a gang revocation is whole and exactly-once (``run_gang_soak``);
9.  the observability plane survives the faults: the endpoints answer
    throughout, /healthz reads 503 during a flagged stall, and the first
    flag per stalled partition yields exactly one ``profile_captured``;
11. an agent killed mid-lease has its lease revoked and its trial requeued
    exactly once (``fleet/soak.py``'s ``run_agent_soak``);
12. the journal sink degrades without losing or doubling an event
    (``fleet/soak.py``'s ``run_sink_soak``);
13. driver failover is lossless (``chaos/driver_soak.py``: the driver is
    SIGKILLed and resumed while its remote runners survive);
14. a checkpoint fork whose runner dies requeues once and resumes from the
    same fork point, lineage intact;
15. rework chip-time lands exactly on the seamed trials, and a fault-free
    soak books none and leaves at most 5% unaccounted;
16. a vectorized block dies as a unit and recovers as individuals.

The soaks: ``run_soak`` (any plan; ``default_plan``, ``piggyback_plan``,
``stall_plan``, ``preempt_plan`` with ``ckpt_train_fn``), ``run_gang_soak``
(``gang_plan``: the pack soak's mixed sweep with one gang member killed),
``run_fork_soak``
(``fork_plan``, then one fork across ``lagom(..., resume=True)``),
``run_goodput_soak`` (fault-free) and ``run_vmap_soak`` (``vmap_plan``);
the agent, sink and driver soaks own their topology and live beside the
fleet and in ``driver_soak.py``. Like
the JAX package's, their signatures name no device: the ``train_fn`` decides
where the work runs. The default trials are closed-form host loops;
``chip_smoke.py``'s ``slice_chaos`` phase passes trials that train on the
card. Every soak takes ``lock_witness`` as the JAX soaks do (None defers to
``MAGGY_TPU_TORCH_LOCK_WITNESS``): armed, it runs under the port's
lock-order witness (``maggy_tpu_torch/analysis/witness.py``), the report
carries a ``witness`` block and a forbidden edge is a violation.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, List, Optional

from maggy_tpu_torch.chaos.plan import FaultPlan, FaultSpec

#: Fault kinds that imply the affected trial must be requeued (a graceful
#: preempt_trial through its preempted-FINAL ack, unless the trial outran
#: the STOP; ``kill_agent`` and ``kill_gang_member`` come from the JAX
#: package's fleet and gang soaks, whose journals this checker reads too).
_REQUEUE_KINDS = ("kill_runner", "fake_preemption", "preempt_trial",
                  "kill_gang_member", "kill_agent", "kill_fork")


def _obs_scrape_loop(stop_evt, stats: Dict[str, Any]) -> None:
    """Soak-side scraper (invariant 9): poll every obs route until the
    soak ends, recording latency, failures, and whether /healthz ever
    reported unhealthy (with the time of each reading, so a caller can
    place them against the stall). A failure only counts while the process
    obs server is still up: the teardown race at experiment end is not a
    responsiveness violation."""
    import json as _json
    import time as _time
    import urllib.error
    import urllib.request

    from maggy_tpu_torch.telemetry import obs as obs_mod

    base = None
    while not stop_evt.is_set():
        server = obs_mod.active_server()
        if server is None:
            if base is not None:
                return  # server came and went: the experiment is over
            _time.sleep(0.01)
            continue
        if base is None:
            base = "http://{}:{}".format(*server.address)
        t0 = _time.monotonic()
        try:
            urllib.request.urlopen(base + "/metrics", timeout=5).read()
            body = urllib.request.urlopen(base + "/status", timeout=5).read()
            stats["last_status"] = _json.loads(body)
            try:
                urllib.request.urlopen(base + "/healthz", timeout=5).read()
                stats["healthz"].append((_time.time(), 200))
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    stats["unhealthy_seen"] += 1
                    stats["healthz"].append((_time.time(), 503))
                else:
                    raise
            stats["scrape_ms"].append((_time.monotonic() - t0) * 1e3)
            stats["scrapes"] += 1
        except Exception as e:  # noqa: BLE001 - every failure mode is the finding
            if obs_mod.active_server() is not None:
                stats["failures"].append(repr(e))
        _time.sleep(0.03)


def default_plan(seed: int = 7) -> FaultPlan:
    """The standard soak: one runner killed mid-trial, one runner falsely
    preempted (alive but declared lost: the duplicate-FINAL race), 5% of
    METRIC heartbeats dropped, and every 5th FINAL's reply withheld
    (at-least-once delivery). The kill fires on the 2nd trial to reach
    ``running``, so the schedule is already warm."""
    return FaultPlan([
        FaultSpec("kill_runner", trigger={"on_phase": "running", "nth": 2}),
        FaultSpec("fake_preemption", trigger={"on_phase": "first_metric",
                                              "nth": 6},
                  duration_s=2.0),
        FaultSpec("drop_msg", target={"verb": "METRIC"},
                  trigger={"probability": 0.05}),
        FaultSpec("sever_conn", target={"verb": "FINAL"},
                  trigger={"every_nth": 5}),
    ], seed=seed)


def piggyback_plan(seed: int = 7, nth: int = 4) -> FaultPlan:
    """A runner killed right after RECEIVING a piggybacked TRIAL, before the
    trial's first heartbeat: the ``running`` edge is journaled while the
    FINAL reply carrying the assignment is being written, so the kill lands
    in that window, and recovery must requeue the trial EXACTLY once
    (invariant 6). ``nth`` defaults past the initial registration GETs (3
    workers: edges 1-3 are REG-path)."""
    return FaultPlan([
        FaultSpec("kill_runner", trigger={"on_phase": "running",
                                          "nth": nth}),
    ], seed=seed)


def stall_plan(seed: int = 7, duration_s: float = 2.0) -> FaultPlan:
    """One runner frozen mid-trial for ``duration_s``: the straggler/hang
    soak. Pair with ``hb_loss_timeout`` ABOVE the stall, so the loss scan
    stays blind and the health engine's hang watchdog must catch it."""
    return FaultPlan([
        FaultSpec("stall_runner", trigger={"on_phase": "first_metric",
                                           "nth": 2},
                  duration_s=duration_s),
    ], seed=seed)


def preempt_plan(seed: int = 7, nth: int = 2) -> FaultPlan:
    """Graceful checkpoint-assisted preemption (invariant 7): the Nth trial
    to reach ``first_metric`` is preempted through the driver's
    ``preempt_partition``. Pair with a train function that checkpoints each
    step before it broadcasts (``ckpt_train_fn``), so the acked step is >= 1
    and the resume provably does not restart from step 0."""
    return FaultPlan([
        FaultSpec("preempt_trial", trigger={"on_phase": "first_metric",
                                            "nth": nth}),
    ], seed=seed)


def gang_plan(seed: int = 7, nth: int = 1) -> FaultPlan:
    """One non-leader member of the Nth assembled gang killed right after
    assembly (invariant 8): the driver must revoke the whole gang (the
    healthy members and the leader, through a preempting STOP, return to
    the pool) and requeue the trial with reason ``gang_member_lost``
    exactly once; it then reassembles around the dead chip."""
    return FaultPlan([FaultSpec("kill_gang_member",
                                trigger={"on_phase": "gang_assembled", "nth": nth})],
                     seed=seed)


def fork_plan(seed: int = 7, nth: int = 1) -> FaultPlan:
    """Checkpoint-forking soak (invariant 14): the runner the Nth FORKED
    trial is dispatched to is killed at its ``forked_from`` edge; the trial
    must requeue exactly once and resume from the SAME fork point."""
    return FaultPlan([
        FaultSpec("kill_fork", trigger={"on_phase": "forked_from",
                                        "nth": nth}),
    ], seed=seed)


def vmap_plan(seed: int = 7, nth: int = 4) -> FaultPlan:
    """Vectorized-block soak (invariant 16): the runner holding the first
    assembled K-lane block is killed at a lane's ``running`` edge. With 2
    workers, running edges 1-2 are each runner's scalar first dispatch, so
    edges 3+ are the first block's leader and lanes, and ``nth`` defaults
    onto a NON-leader lane: the chaos event names a lane while the
    reservation (and so the LOST scan) names the leader."""
    return FaultPlan([
        FaultSpec("kill_runner", trigger={"on_phase": "running",
                                          "nth": nth}),
    ], seed=seed)


def _checkpoint_step(ctx, step: int) -> None:
    """Write the closed-form trials' checkpoint of ``step`` in the trial
    checkpoint layout (``checkpoints/<step>/``), as a small JSON file."""
    import json as _json

    step_dir = os.path.join(ctx.trial_dir, "checkpoints", str(step))
    os.makedirs(step_dir, exist_ok=True)
    with open(os.path.join(step_dir, "state.json"), "w") as f:
        _json.dump({"step": step}, f)


def _resume_start(ctx) -> int:
    """The step after the checkpoint a resumed trial continues from."""
    import json as _json

    if ctx is None or ctx.resume_step is None:
        return 0
    with open(os.path.join(ctx.trial_dir, "checkpoints", str(ctx.resume_step),
                           "state.json")) as f:
        return int(_json.load(f)["step"]) + 1


def _soak_train_fn(lr, units, reporter=None):
    """Closed-form stand-in trial: long enough (~0.3 s) that faults land
    mid-trial, heartbeating every step."""
    import time as _time

    acc = 1.0 - ((lr - 0.1) ** 2 + ((units - 32) / 64.0) ** 2)
    for step in range(6):
        _time.sleep(0.05)
        if reporter is not None:
            reporter.broadcast(acc * (step + 1) / 6.0, step=step)
    return {"metric": acc}


def ckpt_train_fn(lr, units, reporter=None, ctx=None):
    """Soak trial that checkpoints each step and resumes from
    ``ctx.resume_step`` after a preemption: the cooperative half of
    checkpoint-assisted preemption."""
    import time as _time

    acc = 1.0 - ((lr - 0.1) ** 2 + ((units - 32) / 64.0) ** 2)
    for step in range(_resume_start(ctx), 8):
        _time.sleep(0.05)
        if ctx is not None:
            _checkpoint_step(ctx, step)
        if reporter is not None:
            reporter.broadcast(acc * (step + 1) / 8.0, step=step)
    return {"metric": acc}


def fork_step_metric(lr, step: int) -> float:
    """The fork soak trial's closed-form per-step metric: a function of
    (lr, step) alone, so a forked child's step-k metric equals what its
    parent would have produced at step k."""
    return 1.0 - (lr - 0.1) ** 2 * (1.0 + 1.0 / (1.0 + step))


def fork_ckpt_train_fn(lr, budget=1, reporter=None, ctx=None):
    """Forking-soak trial: ASHA budget-scaled, checkpointing every step,
    resuming from ``ctx.resume_step``, which for a promoted trial is the
    fork point the driver staged from its rung parent's checkpoint."""
    import time as _time

    steps = max(1, int(round(4 * budget)))
    metric = None
    for step in range(_resume_start(ctx), steps):
        _time.sleep(0.05)
        metric = fork_step_metric(lr, step)
        if ctx is not None:
            _checkpoint_step(ctx, step)
        if reporter is not None:
            reporter.broadcast(metric, step=step)
    if metric is None:
        metric = fork_step_metric(lr, steps - 1)
    return {"metric": metric}


def vmap_soak_train_fn(lr, lanes=None, reporter=None):
    """Vmap soak trial: a heartbeat-paced closed-form quadratic, ~1.5 s
    busy, lanes-capable. The scalar branch is mandatory: each runner's first
    dispatch precedes the prefetch queue, and every requeued lane re-runs
    scalar (the recovery path under test)."""
    import time as _time

    if lanes is None:
        for step in range(30):
            reporter.broadcast(1.0 - (lr - 0.1) ** 2 + 1e-3 * step,
                               step=step)
            _time.sleep(0.05)
        return 1.0 - (lr - 0.1) ** 2
    lrs = [h["lr"] for h in lanes.hparams]
    for step in range(30):
        vals = [1.0 - (l - 0.1) ** 2 + 1e-3 * step for l in lrs]
        reporter.broadcast_lanes(vals, step=step)
        for i in lanes.take_stopped():
            lanes.retire(i, float(vals[i]))
        _time.sleep(0.05)
    return {tid: 1.0 - (l - 0.1) ** 2
            for tid, l in zip(lanes.trial_ids, lrs)}


def run_soak(plan: Optional[FaultPlan] = None, seed: int = 7,
             train_fn: Optional[Callable] = None, num_trials: int = 12,
             workers: int = 3, pool: str = "thread",
             hb_interval: float = 0.05, hb_loss_timeout: float = 0.6,
             base_dir: Optional[str] = None,
             requeue_grace_s: float = 5.0,
             config_overrides: Optional[Dict[str, Any]] = None,
             lock_witness: Optional[bool] = None,
             obs: bool = False) -> Dict[str, Any]:
    """Execute one soak and return its report (see ``check_invariants``).

    The experiment runs under a private base dir; the journal is read back
    from disk (not from the live telemetry object), so the report derives
    from the same artifact an offline replay uses. ``config_overrides``
    merges extra OptimizationConfig fields (e.g. ``health_hang_factor`` to
    tighten the hang watchdog for a stall soak). ``obs`` arms invariant 9:
    the soak runs with the observability server on (an ephemeral port
    unless config_overrides says otherwise) and a concurrent scraper; the
    report gains an ``obs`` block, and an unresponsive endpoint, an
    untruthful /healthz, or a missing or duplicated health-triggered
    ``profile_captured`` artifact is a violation. The report's ``wall_s``
    is the experiment's wall time.

    ``lock_witness`` arms the runtime lock-order witness for the soak
    (JAX ``harness.py:660-668``): every acquired-while-holding edge the
    experiment takes is recorded, and an edge the static canonical order
    forbids is a violation. None defers to MAGGY_TPU_TORCH_LOCK_WITNESS.
    It is installed before the driver builds its locks, and uninstalled on
    the way out if this call installed it."""
    import json as _json
    import tempfile
    import threading
    import time as _time

    from maggy_tpu_torch.analysis.witness import SoakWitness

    wit = SoakWitness(lock_witness)

    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.core import rpc
    from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events
    from maggy_tpu_torch.telemetry.health import (DEFAULT_STARTUP_FACTOR,
                                                  default_interval_s)

    plan = plan if plan is not None else default_plan(seed)
    train_fn = train_fn or _soak_train_fn
    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_chaos_")
    kwargs = dict(
        name="chaos_soak", num_trials=num_trials, optimizer="randomsearch",
        searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2]),
                                units=("INTEGER", [8, 64])),
        direction="max", num_workers=workers, pool=pool,
        hb_interval=hb_interval, hb_loss_timeout=hb_loss_timeout,
        seed=seed, es_policy="none", experiment_dir=base_dir,
        chaos=plan,
    )
    if obs:
        kwargs["obs_port"] = 0
    kwargs.update(config_overrides or {})
    config = OptimizationConfig(**kwargs)
    obs_stats: Dict[str, Any] = {"scrapes": 0, "failures": [],
                                 "scrape_ms": [], "unhealthy_seen": 0,
                                 "healthz": [], "last_status": None}
    obs_stop = threading.Event()
    obs_thread = None
    if obs:
        obs_thread = threading.Thread(
            target=_obs_scrape_loop, args=(obs_stop, obs_stats),
            daemon=True, name="chaos-obs-scraper")
        obs_thread.start()
    # Bound for invariant 5 (stall -> health flag): the WORST-case hang
    # threshold (the startup window, in case the plan stalls a trial before
    # its first metric) + two health-check intervals + grace, from the
    # health module's own constants.
    hang_s = config.health_hang_factor * hb_interval
    health_interval = config.health_interval_s or default_interval_s(hb_interval)
    stall_flag_bound_s: Optional[float] = \
        DEFAULT_STARTUP_FACTOR * hang_s + 2 * health_interval + 3.0
    if not config.health:
        # No health engine, nothing can flag a stall: the invariant is
        # vacuous, not violated.
        stall_flag_bound_s = None
    retry0 = rpc.CLIENT_METRICS.counter("rpc.client.retries").value
    t0 = _time.perf_counter()
    try:
        result = experiment.lagom(train_fn, config)
    finally:
        if obs_thread is not None:
            obs_stop.set()
            obs_thread.join(timeout=5)
        wit.release()
    wall_s = _time.perf_counter() - t0
    retries = rpc.CLIENT_METRICS.counter("rpc.client.retries").value - retry0
    exp_dirs = sorted(d for d in glob.glob(os.path.join(base_dir, "*"))
                      if os.path.isdir(d))
    journal = os.path.join(exp_dirs[-1], JOURNAL_NAME)
    events = read_events(journal)
    report = check_invariants(
        events, requeue_bound_s=hb_loss_timeout + requeue_grace_s,
        stall_flag_bound_s=stall_flag_bound_s)
    # A soak that injected NOTHING verified nothing.
    if plan.specs and report["faults"]["injected"] == 0:
        report["violations"].append(
            "no faults injected: the plan has {} spec(s) but the journal "
            "records zero chaos events — the soak exercised "
            "nothing".format(len(plan.specs)))
        report["ok"] = False
    # Best-trial semantics survive the chaos: the reported best is the max
    # over the finalized trial artifacts on disk (direction=max).
    metrics = []
    for td in glob.glob(os.path.join(exp_dirs[-1], "*", "trial.json")):
        with open(td) as f:
            d = _json.load(f)
        if d.get("final_metric") is not None:
            metrics.append(float(d["final_metric"]))
    best = result.get("best_val")
    if metrics and (best is None or abs(max(metrics) - best) > 1e-9):
        report["violations"].append(
            "best-trial mismatch: result.best_val={} but max finalized "
            "trial metric on disk is {}".format(best, max(metrics)))
        report["ok"] = False
    if obs:
        # Invariant 9, live half: the endpoints answered throughout and
        # /healthz told the truth (the journal half is in check_invariants).
        from maggy_tpu_torch.telemetry.spans import _dist_stats

        report["obs"] = {
            "scrapes": obs_stats["scrapes"],
            "failures": obs_stats["failures"],
            "scrape_ms": _dist_stats(obs_stats["scrape_ms"]),
            "unhealthy_seen": obs_stats["unhealthy_seen"],
            "healthz": obs_stats["healthz"],
        }
        if obs_stats["scrapes"] == 0:
            report["violations"].append(
                "obs endpoints never answered: the soak scraped zero "
                "successful /metrics+/status+/healthz rounds")
        if obs_stats["failures"]:
            report["violations"].append(
                "obs endpoints unresponsive under faults: {} scrape "
                "failure(s), first: {}".format(
                    len(obs_stats["failures"]), obs_stats["failures"][0]))
        stalled = report["faults"]["by_kind"].get("stall_runner", 0)
        if stalled and report["health"]["raised"] > 0 \
                and obs_stats["unhealthy_seen"] == 0:
            report["violations"].append(
                "obs healthz untruthful: health flags were raised during "
                "the stall soak but /healthz never reported 503")
        report["ok"] = not report["violations"]
    report.update(
        journal=journal, wall_s=wall_s,
        result={"num_trials": result.get("num_trials"),
                "best_val": result.get("best_val"),
                "lost_runners": result.get("lost_runners", 0)},
        client_retries=retries,
        schedule_fingerprint=plan.fingerprint(),
    )
    reading = wit.reading()
    if reading is not None:
        report["witness"] = reading
        if reading["violations"]:
            report["violations"].extend(
                "lock-order witness: " + v for v in reading["violations"])
            report["ok"] = False
    return report


def gang_soak_train_fn(lr, budget=1, gang=None, reporter=None, ctx=None):
    """The gang soak's trial: the pack soak's MLP in paced steps, about
    1.6 s for a 1-chip trial and 4 s for a gang trial, so member-loss
    detection lands mid-gang-trial instead of racing its FINAL."""
    from maggy_tpu_torch.gang import reference_gang_loss

    del budget, gang
    g = None
    if ctx is not None and ctx.gang is not None:
        ctx.gang.ensure_rendezvous()
        g = ctx.gang.to_dict()
    chips = len(g["chips"]) if g and isinstance(g.get("chips"), list) else 1
    return {"metric": reference_gang_loss(lr, g, reporter=reporter,
                                          steps=100 if chips > 1 else 40)}


def run_gang_soak(seed: int = 7, num_trials: int = 10, workers: int = 8,
                  gang_chips: int = 4, base_dir: Optional[str] = None,
                  hb_loss_timeout: float = 1.0,
                  lock_witness: Optional[bool] = None) -> Dict[str, Any]:
    """The gang chaos soak (JAX ``harness.py:260-317``): the pack soak's
    mixed ASHA sweep (1-chip rung-0 trials and ``gang_chips``-chip fsdp
    promotions on ``workers`` thread runners) under ``gang_plan``. Checks
    invariant 8 with the standard suite, fails when the fault never
    produced a revocation (a soak that raced every FINAL verified nothing)
    and when a gang rank process outlived the soak. The gang ranks run on
    ``MAGGY_TPU_TORCH_DEVICE``'s kind; ``hb_loss_timeout`` stays under a
    gang trial's length, so the member's loss is detected mid-trial."""
    from maggy_tpu_torch import Searchspace
    from maggy_tpu_torch import gang as gang_mod
    from maggy_tpu_torch.optimizers import Asha

    plan = gang_plan(seed)
    report = run_soak(
        plan=plan, seed=seed, train_fn=gang_soak_train_fn,
        num_trials=num_trials, workers=workers, pool="thread",
        hb_interval=0.05, hb_loss_timeout=hb_loss_timeout, base_dir=base_dir,
        lock_witness=lock_witness,
        config_overrides=dict(
            optimizer=Asha(reduction_factor=gang_chips, resource_min=1,
                           resource_max=gang_chips, seed=seed),
            searchspace=Searchspace(lr=("DOUBLE", [0.05, 0.2])),
            chips_per_budget={1: gang_mod.GangSpec(1),
                              gang_chips: gang_mod.GangSpec(gang_chips, strategy="fsdp")}))
    revoked = [r for r in report.get("gang_revocations", []) if r.get("outcome") == "revoked"]
    if not revoked:
        report["violations"].append(
            "gang fault never produced a revocation: every kill_gang_member injection "
            "lost the race to the trial's FINAL — the soak exercised nothing (raise the "
            "trial length or lower hb_loss_timeout)")
        report["ok"] = False
    survivors = gang_mod.live_rank_pids()
    report["gang_rank_survivors"] = survivors
    if survivors:
        report["violations"].append("gang rank processes outlived the soak: {}".format(
            survivors))
        report["ok"] = False
    return report


def run_goodput_soak(seed: int = 7, num_trials: int = 12, workers: int = 3,
                     **soak_kwargs: Any) -> Dict[str, Any]:
    """Fault-free control soak for the chip-time ledger (invariant 15's
    other half): with NO faults injected, the goodput fold over the journal
    must book ~zero rework and an ``unaccounted`` residual at or under 5%
    of held chip-time. ``soak_kwargs`` go to ``run_soak`` (a card trial's
    ``train_fn`` and ``config_overrides``, ``lock_witness``)."""
    soak_kwargs.setdefault("hb_loss_timeout", 2.0)
    report = run_soak(plan=FaultPlan([], seed), seed=seed,
                      num_trials=num_trials, workers=workers, **soak_kwargs)
    gp = report.get("goodput") or {}
    rework_s = ((gp.get("buckets") or {}).get("rework") or 0.0)
    if rework_s > 1e-6:
        report["violations"].append(
            "rework in a fault-free soak: the ledger books {:.3f}s "
            "rework chip-time with zero faults injected (trials: "
            "{})".format(rework_s,
                         (report.get("rework") or {}).get("trials")))
    unaccounted = gp.get("unaccounted_fraction")
    if not gp:
        report["violations"].append(
            "no goodput ledger: the fold over the soak journal came "
            "back empty")
    elif unaccounted is None or unaccounted > 0.05:
        report["violations"].append(
            "unaccounted chip-time {} exceeds the 5% bound in a "
            "fault-free soak: the taxonomy leaks".format(unaccounted))
    report["ok"] = not report["violations"]
    return report


def run_fork_soak(seed: int = 7, num_trials: int = 4, workers: int = 2,
                  base_dir: Optional[str] = None,
                  train_fn: Optional[Callable] = None,
                  hb_interval: float = 0.05, hb_loss_timeout: float = 0.6,
                  lock_witness: Optional[bool] = None) -> Dict[str, Any]:
    """The checkpoint-forking chaos soak (invariant 14), two halves:

    1. **Runner death mid-fork**: an ASHA sweep whose promotions FORK their
       rung parents' checkpoints runs under ``fork_plan``: the runner the
       first forked trial lands on is killed, and the trial must requeue
       exactly once and resume from the SAME fork point, its once-per-span
       ``forked_from`` edge intact. ``train_fn`` (lr, budget, reporter,
       ctx) defaults to ``fork_ckpt_train_fn``.
    2. **Driver failover mid-fork**: a synthetically interrupted run whose
       journal holds an in-flight FORKED promotion is resumed through
       ``lagom(..., resume=True)``; the replayed journal must rebuild
       ``forked_from`` and ``resume_step`` from the queued edge and the fork
       must complete from the same point."""
    from maggy_tpu_torch import Searchspace
    from maggy_tpu_torch.optimizers import Asha

    report = run_soak(
        plan=fork_plan(seed), seed=seed, train_fn=train_fn or fork_ckpt_train_fn,
        num_trials=num_trials, workers=workers, pool="thread",
        hb_interval=hb_interval, hb_loss_timeout=hb_loss_timeout, base_dir=base_dir,
        lock_witness=lock_witness,
        config_overrides=dict(
            optimizer=Asha(reduction_factor=2, resource_min=1,
                           resource_max=2, seed=seed),
            searchspace=Searchspace(lr=("DOUBLE", [0.05, 0.2])),
        ))
    if not _chaos_of(report, "kill_fork"):
        report["violations"].append(
            "fork fault never fired: the sweep produced no forked_from "
            "dispatch to kill — the soak exercised nothing")
    failover = _run_fork_failover_half(seed)
    report["fork_failover"] = failover
    report["violations"].extend(
        "fork failover: " + v for v in failover["violations"])
    report["ok"] = not report["violations"]
    return report


def _chaos_of(report: Dict[str, Any], kind: str) -> List[Dict[str, Any]]:
    return [r for r in report.get("recoveries", [])
            if r.get("kind") == kind]


def _run_fork_failover_half(seed: int) -> Dict[str, Any]:
    """Half 2 of the fork soak: one fork across ``lagom(...,
    resume=True)``. Builds what a crashed forking driver leaves on disk
    (two finalized rung-0 trials with artifacts and checkpoints, and one
    IN-FLIGHT forked promotion whose queued edge carries ``forked_from`` and
    ``resume_step``), resumes through lagom and checks the journal: the fork
    completed exactly once, from the same fork point, lineage rebuilt."""
    import json as _json
    import tempfile as _tempfile
    import time as _time

    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.optimizers import Asha
    from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events, replay_journal
    from maggy_tpu_torch.trial import Trial

    base = _tempfile.mkdtemp(prefix="maggy_fork_failover_")
    app_id = "forkfail"
    run_dir = os.path.join(base, "{}_0".format(app_id))
    p1 = {"lr": 0.1, "budget": 1}
    p2 = {"lr": 0.18, "budget": 1}
    t1, t2 = Trial(p1).trial_id, Trial(p2).trial_id
    child_params = {"lr": 0.1, "budget": 2}
    child = Trial(child_params).trial_id
    fork_step = 3  # the parent's last checkpointed step (4 x budget 1)
    child_info = {"sample_type": "promoted", "rung": 1, "parent": t1,
                  "forked_from": {"trial": t1, "step": fork_step},
                  "resume_step": fork_step}
    t0 = _time.time() - 60
    events = [
        {"t": t0, "ev": "driver_epoch", "epoch": 1},
        {"t": t0, "ev": "experiment", "phase": "start", "name": "forksoak"},
        {"t": t0 + 0.1, "ev": "runner", "phase": "registered",
         "partition": 0},
        {"t": t0 + 0.1, "ev": "runner", "phase": "registered",
         "partition": 1},
    ]
    for tid, params, pid in ((t1, p1, 0), (t2, p2, 1)):
        events += [
            {"t": t0 + 0.2, "ev": "trial", "trial": tid,
             "span": "span-" + tid[:6], "phase": "queued", "params": params,
             "trial_type": "optimization",
             "info": {"sample_type": "random", "rung": 0}},
            {"t": t0 + 0.3, "ev": "trial", "trial": tid,
             "span": "span-" + tid[:6], "phase": "running",
             "partition": pid, "epoch": 0},
            {"t": t0 + 1.0, "ev": "trial", "trial": tid,
             "span": "span-" + tid[:6], "phase": "finalized",
             "partition": pid},
        ]
    events += [
        {"t": t0 + 1.2, "ev": "trial", "trial": child,
         "span": "span-child", "phase": "queued", "params": child_params,
         "trial_type": "optimization", "info": child_info},
        {"t": t0 + 1.3, "ev": "trial", "trial": child,
         "span": "span-child", "phase": "assigned", "partition": 0},
        {"t": t0 + 1.3, "ev": "trial", "trial": child,
         "span": "span-child", "phase": "forked_from", "partition": 0,
         "parent": t1, "step": fork_step},
        {"t": t0 + 1.4, "ev": "trial", "trial": child,
         "span": "span-child", "phase": "running", "partition": 0,
         "epoch": 0},
    ]
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, JOURNAL_NAME), "w") as f:
        for ev in events:
            f.write(_json.dumps(ev) + "\n")
    for tid, params, metric in ((t1, p1, 0.9), (t2, p2, 0.5)):
        done = Trial(params, info_dict={"sample_type": "random", "rung": 0})
        done.status = Trial.FINALIZED
        done.final_metric = metric
        os.makedirs(os.path.join(run_dir, tid), exist_ok=True)
        with open(os.path.join(run_dir, tid, "trial.json"), "w") as f:
            f.write(done.to_json())
        for step in range(4):
            step_dir = os.path.join(run_dir, tid, "checkpoints", str(step))
            os.makedirs(step_dir, exist_ok=True)
            with open(os.path.join(step_dir, "state.json"), "w") as f:
                _json.dump({"step": step}, f)
    for name, payload in (
            (".run_claim", {}),
            ("experiment.json", {"name": "forksoak", "state": "RUNNING"}),
            (".driver_epoch.1", {}),
            ("driver_state.json", {"secret": "ab" * 16,
                                   "host": "127.0.0.1", "port": 0,
                                   "driver_epoch": 1})):
        with open(os.path.join(run_dir, name), "w") as f:
            _json.dump(payload, f)

    # The port's lagom reads its app id from the environment.
    old_app = os.environ.get("MAGGY_TPU_APP_ID")
    os.environ["MAGGY_TPU_APP_ID"] = app_id
    try:
        config = OptimizationConfig(
            name="forksoak", num_trials=2,
            optimizer=Asha(reduction_factor=2, resource_min=1,
                           resource_max=2, seed=seed),
            searchspace=Searchspace(lr=("DOUBLE", [0.05, 0.2])),
            direction="max", num_workers=2, seed=seed, es_policy="none",
            experiment_dir=base, resume=True, hb_interval=0.05,
            hb_loss_timeout=1.0)
        result = experiment.lagom(fork_ckpt_train_fn, config)
    finally:
        if old_app is None:
            os.environ.pop("MAGGY_TPU_APP_ID", None)
        else:
            os.environ["MAGGY_TPU_APP_ID"] = old_app
    events = read_events(os.path.join(run_dir, JOURNAL_NAME))
    violations: List[str] = []
    report = check_invariants(events)
    violations.extend(report["violations"])
    resumed = [ev for ev in events
               if ev.get("ev") == "trial" and ev.get("trial") == child
               and ev.get("phase") == "resumed"]
    if not resumed:
        violations.append(
            "recovered fork never resumed: the re-dispatched child "
            "carries no resumed edge")
    elif any(ev.get("from_step") != fork_step for ev in resumed):
        violations.append(
            "recovered fork lost its fork point: resumed from_step {} "
            "!= staged step {}".format(
                [ev.get("from_step") for ev in resumed], fork_step))
    fork_edges = [ev for ev in events
                  if ev.get("ev") == "trial" and ev.get("trial") == child
                  and ev.get("phase") == "forked_from"]
    if len(fork_edges) != 1:
        violations.append(
            "fork lineage not exactly-once across incarnations: {} "
            "forked_from edges for the child".format(len(fork_edges)))
    recovered = [ev for ev in events
                 if ev.get("ev") == "experiment"
                 and ev.get("phase") == "recovered"]
    if not recovered or not recovered[0].get("forks"):
        violations.append(
            "recovery did not report the rebuilt fork lineage "
            "(recovered event missing forks count)")
    derived = replay_journal(os.path.join(run_dir, JOURNAL_NAME))
    return {"violations": violations,
            "result": {"num_trials": result.get("num_trials"),
                       "best_val": result.get("best_val")},
            "fork": derived.get("fork") or {},
            "journal": os.path.join(run_dir, JOURNAL_NAME)}


def run_vmap_soak(seed: int = 7, num_trials: int = 12, workers: int = 2,
                  lanes: int = 4, base_dir: Optional[str] = None,
                  train_fn: Optional[Callable] = None,
                  hb_interval: float = 0.05, hb_loss_timeout: float = 0.6,
                  nth: int = 4, lock_witness: Optional[bool] = None) -> Dict[str, Any]:
    """The vectorized-block chaos soak: a float-only sweep (every trial
    program-compatible, so blocks assemble as soon as the prefetch queue
    fills) with ``vmap_lanes=lanes`` on a 2-runner thread fleet, under
    ``vmap_plan(nth)``: the runner holding the first assembled block killed
    mid-block. Invariant 16 on top of the standard suite, and a violation
    if the kill never tore a block. ``train_fn`` (lr, lanes, reporter)
    defaults to ``vmap_soak_train_fn``."""
    from maggy_tpu_torch import Searchspace

    report = run_soak(
        plan=vmap_plan(seed, nth=nth), seed=seed,
        train_fn=train_fn or vmap_soak_train_fn,
        num_trials=num_trials, workers=workers, pool="thread",
        hb_interval=hb_interval, hb_loss_timeout=hb_loss_timeout, base_dir=base_dir,
        lock_witness=lock_witness,
        config_overrides=dict(
            searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2])),
            vmap_lanes=lanes,
        ))
    torn = [r for r in report.get("vmap_blocks", [])
            if r.get("outcome") == "requeued"]
    if not torn:
        report["violations"].append(
            "vmap fault never tore a block: the kill_runner injection "
            "hit a scalar trial (or raced every lane's FINAL) — the soak "
            "exercised nothing (tune vmap_plan's nth)")
        report["ok"] = False
    return report


def check_invariants(events: List[Dict[str, Any]],
                     requeue_bound_s: Optional[float] = None,
                     stall_flag_bound_s: Optional[float] = 15.0
                     ) -> Dict[str, Any]:
    """Pure invariant check over journal events. Returns a report with
    ``violations`` (empty = all invariants hold), per-fault recovery
    latencies, health-flag stats, and lifecycle counts.

    ``stall_flag_bound_s`` bounds invariant 5 (every ``stall_runner``
    injection must be followed by a health ``raised`` flag for the stalled
    partition). The invariant is enforced only when the journal carries
    the health engine's ``started`` liveness marker — a pre-health or
    ``health=False`` journal has nothing watching, which is a skipped
    check, not a violation. Passing None also skips it."""
    queued: Dict[str, float] = {}
    finalized: Dict[str, List[float]] = {}
    finalized_ok: Dict[str, List[float]] = {}
    running_at: Dict[str, List[float]] = {}
    requeued: Dict[str, List[float]] = {}
    requeued_evs: Dict[str, List[Dict[str, Any]]] = {}
    preempted_evs: Dict[str, List[Dict[str, Any]]] = {}
    resumed_evs: Dict[str, List[Dict[str, Any]]] = {}
    forked_evs: Dict[str, List[Dict[str, Any]]] = {}
    gang_assembled: Dict[str, List[Dict[str, Any]]] = {}
    gang_released: Dict[str, List[Dict[str, Any]]] = {}
    # Vectorized blocks (invariant 16): block leader id -> {lane trial id
    # -> its lane-tagged assigned event}. Only block assignments carry a
    # "block" field; scalar journals never enter this map.
    block_lanes: Dict[str, Dict[str, Dict[str, Any]]] = {}
    parent_of: Dict[str, Any] = {}
    chaos_events: List[Dict[str, Any]] = []
    health_raised: List[Dict[str, Any]] = []
    health_by_check: Dict[str, int] = {}
    health_engine_ran = False
    experiment_finalized = False
    obs_armed = False
    profile_captures: List[Dict[str, Any]] = []
    driver_epochs: List[Dict[str, Any]] = []
    recovered_markers: List[Dict[str, Any]] = []
    adopted = 0
    for ev in events:
        kind = ev.get("ev")
        t = ev.get("t")
        if kind == "chaos":
            chaos_events.append(dict(ev))
            continue
        if kind == "driver_epoch":
            driver_epochs.append(dict(ev))
            continue
        if kind == "runner":
            if ev.get("phase") == "adopted":
                adopted += 1
            continue
        if kind == "obs_started":
            obs_armed = True
            continue
        if kind == "profile_captured":
            profile_captures.append(dict(ev))
            continue
        if kind == "health":
            if ev.get("check") == "engine":
                health_engine_ran |= ev.get("status") == "started"
            elif ev.get("status") == "raised":
                health_raised.append(dict(ev))
                health_by_check[ev.get("check")] = \
                    health_by_check.get(ev.get("check"), 0) + 1
            continue
        if kind == "experiment":
            if ev.get("phase") in ("finalized", "end"):
                experiment_finalized = True
            elif ev.get("phase") == "recovered":
                recovered_markers.append(dict(ev))
            continue
        if kind != "trial" or t is None:
            continue
        trial, phase = ev.get("trial"), ev.get("phase")
        if trial is None:
            continue
        if phase == "queued":
            queued.setdefault(trial, t)
            if (ev.get("info") or {}).get("parent") is not None:
                parent_of.setdefault(trial, ev["info"]["parent"])
        elif phase == "requeued":
            requeued.setdefault(trial, []).append(t)
            requeued_evs.setdefault(trial, []).append(dict(ev))
        elif phase == "assigned":
            if ev.get("block") is not None:
                block_lanes.setdefault(ev["block"], {}).setdefault(
                    trial, dict(ev))
        elif phase == "gang_assembled":
            gang_assembled.setdefault(trial, []).append(dict(ev))
        elif phase == "gang_released":
            gang_released.setdefault(trial, []).append(dict(ev))
        elif phase == "preempted":
            preempted_evs.setdefault(trial, []).append(dict(ev))
        elif phase == "resumed":
            resumed_evs.setdefault(trial, []).append(dict(ev))
        elif phase == "forked_from":
            forked_evs.setdefault(trial, []).append(dict(ev))
        elif phase == "running":
            running_at.setdefault(trial, []).append(t)
        elif phase == "finalized":
            finalized.setdefault(trial, []).append(t)
            if not ev.get("error"):
                finalized_ok.setdefault(trial, []).append(t)

    violations: List[str] = []
    for trial in sorted(queued):
        n = len(finalized.get(trial, []))
        if n == 0:
            violations.append("lost trial: {} was queued but never "
                              "finalized".format(trial))
        elif n > 1:
            violations.append("duplicate FINAL: {} finalized {} "
                              "times".format(trial, n))
    for trial in sorted(set(finalized) - set(queued)):
        violations.append("phantom trial: {} finalized but never "
                          "queued".format(trial))
    if not experiment_finalized:
        violations.append("experiment never finalized (no experiment "
                          "finalized/end event in the journal)")

    # Fault -> requeue recovery, for every injected runner-death fault
    # that names the trial it disturbed. A kill MUST produce a requeue
    # (the dead runner can never deliver the FINAL); a fake preemption
    # may lose the race to a fast trial — the alive runner's FINAL lands
    # before the loss scan fires, nothing was endangered, and that
    # benign outcome is reported as completed_before_detection.
    recoveries: List[Dict[str, Any]] = []
    for ce in chaos_events:
        if ce.get("kind") not in _REQUEUE_KINDS:
            continue
        trial, t0 = ce.get("trial"), ce.get("t")
        if trial is None or t0 is None:
            continue
        later = [t for t in requeued.get(trial, []) if t >= t0]
        finished = [t for t in finalized.get(trial, []) if t >= t0]
        rec = {"kind": ce["kind"], "trial": trial,
               "partition": ce.get("partition")}
        if later:
            rec["outcome"] = "requeued"
            rec["requeues"] = len(later)
            latency = min(later) - t0
            rec["requeue_latency_s"] = round(latency, 3)
            if requeue_bound_s is not None and latency > requeue_bound_s:
                violations.append(
                    "slow requeue: {} fault on trial {} took {:.2f}s to "
                    "requeue (bound {:.2f}s)".format(
                        ce["kind"], trial, latency, requeue_bound_s))
        elif finished and ce["kind"] not in ("kill_runner", "kill_agent",
                                             "kill_fork"):
            # A killed runner/agent can never deliver the FINAL itself —
            # a post-kill FINAL without a requeue would mean a duplicate
            # delivery path, not a benign race.
            rec["outcome"] = "completed_before_detection"
            rec["requeue_latency_s"] = None
        else:
            rec["outcome"] = "unrecovered"
            rec["requeue_latency_s"] = None
            violations.append(
                "no requeue: {} fault hit trial {} (partition {}) but the "
                "journal has no subsequent requeued event".format(
                    ce["kind"], trial, ce.get("partition")))
        recoveries.append(rec)

    # Invariant 6: exactly-once requeue. N runner-death faults naming a
    # trial must produce exactly N requeues of it — a piggybacked
    # assignment dying with its runner before the first heartbeat must
    # not be double-requeued by racing recovery paths (LOST scan vs a
    # re-registration BLACK), nor silently over-requeued in general.
    death_faults: Dict[str, int] = {}
    for ce in chaos_events:
        if ce.get("kind") in _REQUEUE_KINDS and ce.get("trial") is not None:
            death_faults[ce["trial"]] = death_faults.get(ce["trial"], 0) + 1
    for trial, n_faults in sorted(death_faults.items()):
        n_req = len(requeued.get(trial, []))
        if n_req > n_faults:
            violations.append(
                "duplicate requeue: trial {} was requeued {} times for {} "
                "runner-death fault(s)".format(trial, n_req, n_faults))

    # Invariant 7: checkpoint-assisted preemption. Every preempt_trial
    # fault must be followed by the trial's graceful ``preempted`` ack
    # (unless the trial outran the STOP and finalized — benign); a trial
    # preempted WITH a checkpoint must later resume exactly from that
    # step (never restart at 0); invariants 1/2 (single FINAL, no lost
    # trial) already cover the rest of the chain above.
    preempt_recs: List[Dict[str, Any]] = []
    for ce in chaos_events:
        if ce.get("kind") != "preempt_trial":
            continue
        trial, t0 = ce.get("trial"), ce.get("t")
        if trial is None or t0 is None:
            continue
        acks = [p for p in preempted_evs.get(trial, [])
                if p.get("t") is not None and p["t"] >= t0]
        rec: Dict[str, Any] = {"trial": trial,
                               "partition": ce.get("partition")}
        if not acks:
            if [t for t in finalized.get(trial, []) if t >= t0]:
                rec["outcome"] = "completed_before_preempt"
            else:
                rec["outcome"] = "unacked"
                violations.append(
                    "unacked preemption: preempt_trial fault on trial {} "
                    "produced neither a preempted ack nor a FINAL".format(
                        trial))
            preempt_recs.append(rec)
            continue
        ack = acks[0]
        step = ack.get("step")
        rec.update(outcome="preempted", step=step,
                   checkpointed=bool(ack.get("checkpointed")))
        if ack.get("checkpointed"):
            resumes = [r for r in resumed_evs.get(trial, [])
                       if r.get("t") is not None and r["t"] >= ack["t"]]
            if not resumes:
                violations.append(
                    "unresumed preemption: trial {} was preempted at "
                    "checkpoint step {} but never carried a resumed "
                    "edge".format(trial, step))
            else:
                from_step = resumes[0].get("from_step")
                rec["from_step"] = from_step
                if from_step != step:
                    violations.append(
                        "resume step mismatch: trial {} was preempted at "
                        "checkpoint step {} but resumed from_step={}"
                        .format(trial, step, from_step))
                elif not from_step or from_step < 1:
                    violations.append(
                        "resume from scratch: trial {} checkpointed but "
                        "resumed from step {} (expected >= 1)".format(
                            trial, from_step))
        preempt_recs.append(rec)

    # Invariant 8: gang revocation is whole and exactly-once. A
    # kill_gang_member fault whose member-loss detection won the race
    # against the trial's FINAL must be followed by the WHOLE gang's
    # release, the trial's requeue with reason gang_member_lost exactly
    # once, and a later re-assembly (the trial can only ever run through
    # a gang, and invariant 1 demands it finalizes).
    gang_recs: List[Dict[str, Any]] = []
    for ce in chaos_events:
        if ce.get("kind") != "kill_gang_member":
            continue
        trial, t0 = ce.get("trial"), ce.get("t")
        if trial is None or t0 is None:
            continue
        rec: Dict[str, Any] = {"trial": trial,
                               "victim": ce.get("partition"),
                               "leader": ce.get("leader")}
        gml = [e for e in requeued_evs.get(trial, [])
               if e.get("t") is not None and e["t"] >= t0
               and e.get("reason") == "gang_member_lost"]
        if not gml:
            if [t for t in finalized.get(trial, []) if t >= t0]:
                rec["outcome"] = "completed_before_detection"
            else:
                rec["outcome"] = "unrevoked"
                violations.append(
                    "unrevoked gang: kill_gang_member fault on trial {} "
                    "(victim runner {}) produced neither a "
                    "gang_member_lost requeue nor a FINAL".format(
                        trial, ce.get("partition")))
            gang_recs.append(rec)
            continue
        rec["outcome"] = "revoked"
        rec["requeues"] = len(gml)
        rec["revoke_latency_s"] = round(min(e["t"] for e in gml) - t0, 3)
        if len(gml) > 1:
            violations.append(
                "gang over-requeue: trial {} carries {} gang_member_lost "
                "requeues for one kill_gang_member fault".format(
                    trial, len(gml)))
        if not [e for e in gang_released.get(trial, [])
                if e.get("t") is not None and e["t"] >= t0]:
            violations.append(
                "gang lease not released: trial {} was revoked but the "
                "journal carries no gang_released edge after the "
                "fault".format(trial))
        t_req = min(e["t"] for e in gml)
        if not [e for e in gang_assembled.get(trial, [])
                if e.get("t") is not None and e["t"] >= t_req]:
            violations.append(
                "gang never reassembled: trial {} was requeued for "
                "gang_member_lost but no later gang_assembled edge "
                "exists".format(trial))
        gang_recs.append(rec)

    # Invariant 14: checkpoint forks survive runner death. Every
    # kill_fork fault names the forked trial it disturbed: the requeue
    # contract (exactly once) is covered by the generic checks above;
    # on top, the re-dispatch must RESUME from the SAME fork point (a
    # resumed edge whose from_step equals the forked_from step — never
    # a silent from-scratch restart) and the genealogy edge must stay
    # exactly-once per span across the requeue.
    fork_recs: List[Dict[str, Any]] = []
    for ce in chaos_events:
        if ce.get("kind") != "kill_fork":
            continue
        trial, t0 = ce.get("trial"), ce.get("t")
        if trial is None or t0 is None:
            continue
        edges = forked_evs.get(trial, [])
        step = edges[0].get("step") if edges else None
        rec: Dict[str, Any] = {"trial": trial,
                               "partition": ce.get("partition"),
                               "step": step}
        if len(edges) != 1:
            violations.append(
                "fork lineage not exactly-once: trial {} carries {} "
                "forked_from edges".format(trial, len(edges)))
        resumes = [r for r in resumed_evs.get(trial, [])
                   if r.get("t") is not None and r["t"] >= t0]
        if not resumes:
            rec["outcome"] = "not_resumed"
            violations.append(
                "fork lost: kill_fork hit trial {} but no later resumed "
                "edge re-dispatched it from its fork point".format(trial))
        elif step is not None and resumes[0].get("from_step") != step:
            rec["outcome"] = "wrong_fork_point"
            violations.append(
                "fork point drifted: trial {} was forked at step {} but "
                "resumed from_step={}".format(
                    trial, step, resumes[0].get("from_step")))
        else:
            rec["outcome"] = "resumed_from_fork"
            rec["from_step"] = resumes[0].get("from_step")
        fork_recs.append(rec)

    # Invariant 16: a vectorized block dies as a unit and recovers as
    # individuals. A runner-death fault naming ANY lane of an in-flight
    # block (the chaos event may name a non-leader lane — its running
    # edge fired the trigger — while the reservation names the leader)
    # must be followed by the exactly-once requeue of EVERY lane that
    # had not already finalized; non-leader lanes carry reason
    # vmap_block_lost. Phantom FINALs and lost lanes are invariants 1/2
    # above; this block pins the seam-specific contract.
    lane_block: Dict[str, str] = {}
    for bid, lanes_map in block_lanes.items():
        for tr in lanes_map:
            lane_block.setdefault(tr, bid)
    block_kills: Dict[str, List[Dict[str, Any]]] = {}
    for ce in chaos_events:
        if ce.get("kind") not in ("kill_runner", "kill_fork"):
            continue
        bid = lane_block.get(ce.get("trial"))
        if bid is not None and ce.get("t") is not None:
            block_kills.setdefault(bid, []).append(ce)
    vmap_recs: List[Dict[str, Any]] = []
    for bid, kills in sorted(block_kills.items()):
        lanes_map = block_lanes[bid]
        t0 = min(ce["t"] for ce in kills)
        rec: Dict[str, Any] = {"block": bid,
                               "lanes": sorted(lanes_map),
                               "victim": kills[0].get("trial"),
                               "partition": kills[0].get("partition")}
        live = [tr for tr in sorted(lanes_map)
                if not [t for t in finalized.get(tr, []) if t <= t0]]
        if not live:
            rec["outcome"] = "completed_before_detection"
            vmap_recs.append(rec)
            continue
        rec["outcome"] = "requeued"
        rec["live_lanes"] = live
        for tr in live:
            later = [e for e in requeued_evs.get(tr, [])
                     if e.get("t") is not None and e["t"] >= t0]
            n_req = len(requeued.get(tr, []))
            if not later:
                rec["outcome"] = "torn"
                violations.append(
                    "lane lost to the block seam: a runner-death fault "
                    "tore block {} but live lane trial {} was never "
                    "requeued".format(bid, tr))
            elif n_req > len(kills):
                violations.append(
                    "lane over-requeue: trial {} (block {}) was requeued "
                    "{} times for {} runner-death fault(s) on its "
                    "block".format(tr, bid, n_req, len(kills)))
            elif tr != bid and later[0].get("reason") not in (
                    "vmap_block_lost", "preempted"):
                violations.append(
                    "lane requeue reason drift: non-leader lane {} of "
                    "block {} requeued with reason {!r} (expected "
                    "vmap_block_lost)".format(
                        tr, bid, later[0].get("reason")))
        vmap_recs.append(rec)

    # Invariant 5: stall -> health flag. A frozen runner shorter than the
    # loss bound is invisible to the heartbeat-loss scan; the health
    # engine's hang watchdog (or straggler scoring) must still see it,
    # within bounded time, attributed to the right partition.
    from maggy_tpu_torch.telemetry.health import STALL_CHECKS

    stall_flags: List[Dict[str, Any]] = []
    enforce_stall = stall_flag_bound_s is not None and health_engine_ran
    for ce in chaos_events:
        if ce.get("kind") != "stall_runner" or not enforce_stall:
            continue
        pid, t0 = ce.get("partition"), ce.get("t")
        if pid is None or t0 is None:
            continue
        matching = [h for h in health_raised
                    if h.get("partition") == pid
                    and h.get("check") in STALL_CHECKS
                    and h.get("t") is not None
                    and t0 <= h["t"] <= t0 + stall_flag_bound_s]
        rec = {"partition": pid, "t": t0,
               "flagged": bool(matching),
               "flag_latency_s": round(min(h["t"] for h in matching) - t0, 3)
               if matching else None,
               "checks": sorted({h["check"] for h in matching})}
        stall_flags.append(rec)
        if not matching:
            violations.append(
                "unflagged stall: stall_runner fault on partition {} at "
                "t={:.3f} produced no health straggler/hang flag within "
                "{:.1f}s".format(pid, t0, stall_flag_bound_s))

    # Invariant 9, journal half: with the obs plane armed, the FIRST
    # straggler/hang flag per stalled partition yields exactly ONE
    # health-triggered profile artifact — zero means the capture hook
    # never fired, more than one means the per-partition dedup (or the
    # run-wide rate limit) is broken.
    from maggy_tpu_torch.telemetry.profiling import AUTO_CAPTURE_LIMIT

    auto_captures = [p for p in profile_captures
                     if p.get("reason") == "auto"]
    if len(auto_captures) > AUTO_CAPTURE_LIMIT:
        violations.append(
            "profile rate limit broken: {} auto captures journaled "
            "(limit {})".format(len(auto_captures), AUTO_CAPTURE_LIMIT))
    if obs_armed and enforce_stall:
        stalled_pids = []
        for ce in chaos_events:
            if ce.get("kind") == "stall_runner" \
                    and ce.get("partition") is not None \
                    and ce["partition"] not in stalled_pids:
                stalled_pids.append(ce["partition"])
        flagged_pids = {f["partition"] for f in stall_flags
                        if f.get("flagged")}
        for pid in stalled_pids:
            captures = [p for p in auto_captures
                        if p.get("partition") == pid]
            if len(captures) > 1:
                violations.append(
                    "duplicate profile capture: stalled partition {} "
                    "journaled {} auto profile_captured events (expected "
                    "exactly 1)".format(pid, len(captures)))
            elif not captures and pid in flagged_pids \
                    and len(auto_captures) < AUTO_CAPTURE_LIMIT:
                violations.append(
                    "missing profile capture: stalled partition {} was "
                    "health-flagged but journaled no profile_captured "
                    "artifact".format(pid))

    # Invariant 13: driver failover is lossless. Completed trials never
    # re-run (a successful FINAL is durable past a crash — the FINAL-path
    # barrier — so recovery must never re-dispatch one): a ``running``
    # edge after the trial's LAST successful finalized is a double run.
    # Errored trials are exempt — a controller retrying a failed unit of
    # work (PBT segment retry) legitimately re-issues the identical id.
    for trial, times in sorted(finalized_ok.items()):
        t_done = max(times)
        if any(t > t_done for t in running_at.get(trial, [])):
            violations.append(
                "completed trial re-ran: {} has a running edge after its "
                "successful finalized at t={:.3f}".format(trial, t_done))
    # Every kill_driver fault must be followed by a restarted incarnation
    # AND a journal-replay reconstruction marker — a kill with neither
    # means the failover never happened; a restart without ``recovered``
    # means it came back blind (artifact-only resume, not crash-only
    # recovery).
    failover_recs: List[Dict[str, Any]] = []
    for ce in chaos_events:
        if ce.get("kind") != "kill_driver":
            continue
        t0 = ce.get("t")
        if t0 is None:
            continue
        restarts = [d for d in driver_epochs
                    if d.get("t") is not None and d["t"] >= t0]
        recovers = [r for r in recovered_markers
                    if r.get("t") is not None and r["t"] >= t0]
        rec: Dict[str, Any] = {"t": t0}
        if not restarts:
            rec["outcome"] = "no_restart"
            violations.append(
                "driver never restarted: kill_driver at t={:.3f} has no "
                "later driver_epoch event".format(t0))
        elif not recovers:
            rec["outcome"] = "no_recovery"
            violations.append(
                "driver restarted blind: kill_driver at t={:.3f} has a "
                "later driver_epoch but no journal-replay 'recovered' "
                "marker".format(t0))
        else:
            rec["outcome"] = "recovered"
            rec["epoch"] = restarts[0].get("epoch")
            rec["mttr_s"] = round(min(r["t"] for r in recovers) - t0, 3)
        failover_recs.append(rec)

    # Invariant 15: rework chip-time lands EXACTLY on the trials whose
    # attempts the journal shows torn — a runner-death requeue seam
    # (requeued with a non-preempt reason) or a from-scratch promotion
    # (parent recorded but no forked_from edge). The goodput accountant
    # folds the SAME events; a rework second booked on an un-seamed
    # trial means the ledger mis-attributes (and a fault-free soak must
    # book ~zero rework at all — run_goodput_soak gates that side).
    from maggy_tpu_torch.telemetry.goodput import compute_goodput

    goodput = compute_goodput(events)
    per_trial_gp = goodput.get("per_trial") or {}
    seamed = {trial for trial, evs in requeued_evs.items()
              if any(e.get("reason") != "preempted" for e in evs)}
    seamed |= {trial for trial, parent in parent_of.items()
               if parent is not None and trial not in forked_evs}
    rework_trials: Dict[str, float] = {}
    for trial, buckets in sorted(per_trial_gp.items()):
        rw = buckets.get("rework") or 0.0
        if rw > 1e-6:
            rework_trials[trial] = round(rw, 3)
            if trial not in seamed:
                violations.append(
                    "rework misattributed: trial {} books {:.3f}s rework "
                    "chip-time but the journal shows no requeue seam or "
                    "from-scratch promotion for it".format(trial, rw))
    # The positive half: a runner-death fault that tore a STARTED
    # attempt (a running edge precedes the kill) and forced a requeue
    # must show up as rework on that trial — dead-attempt seconds can
    # never fall into unaccounted.
    for ce in chaos_events:
        if ce.get("kind") not in ("kill_runner", "kill_fork"):
            continue
        trial, t0 = ce.get("trial"), ce.get("t")
        if trial is None or t0 is None:
            continue
        if not [t for t in requeued.get(trial, []) if t >= t0]:
            continue  # benign race: covered by the recovery checks above
        if not [t for t in running_at.get(trial, []) if t <= t0]:
            continue  # fault beat the first running edge: nothing torn
        if (per_trial_gp.get(trial) or {}).get("rework", 0.0) <= 1e-6:
            violations.append(
                "rework not booked: {} fault requeued started trial {} "
                "but the goodput ledger books zero rework chip-time for "
                "it".format(ce["kind"], trial))

    by_kind: Dict[str, int] = {}
    for ce in chaos_events:
        by_kind[ce["kind"]] = by_kind.get(ce["kind"], 0) + 1
    return {
        "ok": not violations,
        "violations": violations,
        "trials": {"queued": len(queued),
                   "finalized": sum(1 for v in finalized.values() if v),
                   "requeued": sum(len(v) for v in requeued.values())},
        "faults": {"injected": len(chaos_events), "by_kind": by_kind},
        "recoveries": recoveries,
        "preemptions": preempt_recs,
        "gang_revocations": gang_recs,
        # Invariant 14 (checkpoint-forking search): per-kill_fork
        # outcome — the forked trial's requeue resumed from its exact
        # fork point with lineage intact.
        "forks": fork_recs,
        # Invariant 16 (vectorized micro-trials): per torn block —
        # every live lane requeued exactly once, non-leader lanes with
        # reason vmap_block_lost.
        "vmap_blocks": vmap_recs,
        "health": {"engine_ran": health_engine_ran,
                   "raised": len(health_raised),
                   "by_check": health_by_check,
                   "stall_flags": stall_flags},
        "profiles": {"obs_armed": obs_armed,
                     "captured": len(profile_captures),
                     "auto": len(auto_captures)},
        # Invariant 15 (chip-time goodput ledger): the full fold over
        # this journal plus the rework attribution the invariant
        # verified (seamed = trials allowed to book rework).
        "goodput": goodput,
        "rework": {"trials": rework_trials,
                   "seamed": sorted(seamed),
                   "booked_s": round(sum(rework_trials.values()), 3)},
        # Invariant 13 (crash-only driver failover): incarnation seams,
        # per-kill recovery outcome + MTTR, and how many pre-crash
        # runners re-bound to the restarted driver.
        "failover": {
            "driver_epochs": [d.get("epoch") for d in driver_epochs],
            "kills": sum(1 for ce in chaos_events
                         if ce.get("kind") == "kill_driver"),
            "recoveries": failover_recs,
            "recovered_markers": len(recovered_markers),
            "adopted": adopted,
        },
    }


def assert_invariants(report: Dict[str, Any]) -> None:
    if report["violations"]:
        raise AssertionError(
            "chaos invariants violated:\n  " +
            "\n  ".join(report["violations"]))
