"""Fleet soak: run concurrent experiments over one shared fleet and check
the scheduling invariants from the journal artifacts.

The port's copy of the in-process soaks of ``maggy_tpu/fleet/soak.py``
(``:28-174``, ``:362-627``): ``demo_train_fn`` and ``run_fleet_soak``,
``run_weighted_share_soak`` and ``run_slow_tenant_soak`` with their train
functions. ``fleet_soak_report`` is ``run_fleet_soak``'s check of the
journals, apart so that ``chip_smoke.py``'s card soak holds its own two
tenants to the same gates. Their signatures name no device: the train
function decides where the work runs. Not ported yet (ROADMAP queue 1 item
9b): the scale, agent, sink and remote-scale soaks; and the lock-order
witness of the JAX soaks (``maggy_tpu.analysis``), as in the port's chaos
harness.

The standard scenario (``run_fleet_soak``): a low-priority "bulk" sweep
takes the whole 2-runner fleet, then a high-priority "urgent" experiment
with ``min_runners=1`` is submitted mid-flight — the scheduler must
preempt one bulk trial (gracefully, checkpoint-assisted) to make room,
both experiments must complete, and the fleet journal must show shares
within the configured weights and no experiment starving past the bound.
bench.py's ``--fleet`` mode wraps this and records the replayed numbers
as its ``detail.fleet`` block (queue wait p50/p95, preemption count,
share error).
"""

from __future__ import annotations

import glob
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

from maggy_tpu_torch.fleet.scheduler import (FLEET_JOURNAL_NAME, Fleet,
                                             replay_fleet_journal)


def demo_train_fn(lr, units, reporter=None, ctx=None):
    """Closed-form fleet trial: checkpoints every step (TrialCheckpointer
    ``checkpoints/<step>/`` layout) and resumes from ``ctx.resume_step``
    after a preemption, broadcasting as it goes — module-level so CLI
    spec files can name it (``maggy_tpu_torch.fleet.soak:demo_train_fn``)."""
    from maggy_tpu_torch.chaos.harness import ckpt_train_fn

    return ckpt_train_fn(lr, units, reporter=reporter, ctx=ctx)


def run_fleet_soak(runners: int = 2, bulk_trials: int = 6,
                   urgent_trials: int = 2, seed: int = 7,
                   base_dir: Optional[str] = None,
                   saturation_timeout_s: float = 30.0,
                   preempt_grace_s: float = 0.25,
                   starvation_bound_s: float = 10.0,
                   hb_interval: float = 0.05) -> Dict[str, Any]:
    """Execute the standard two-experiment preemption soak; returns a
    report with ``ok``/``violations``, the fleet-journal replay, and the
    ``detail`` block bench.py records. Pure artifact-checking: shares and
    preemptions are derived from fleet.jsonl, the per-experiment
    invariants (single FINAL, preempted-then-resumed) from each
    experiment's own telemetry journal."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_fleet_")
    space = Searchspace(lr=("DOUBLE", [0.0, 0.2]),
                        units=("INTEGER", [8, 64]))

    def cfg(name: str, trials: int) -> OptimizationConfig:
        return OptimizationConfig(
            name=name, num_trials=trials, optimizer="randomsearch",
            searchspace=space, direction="max", hb_interval=hb_interval,
            hb_loss_timeout=5.0, seed=seed, es_policy="none",
            experiment_dir=base_dir)

    t0 = time.time()
    fleet = Fleet(runners=runners, home_dir=os.path.join(base_dir, "fleet"),
                  preempt_grace_s=preempt_grace_s)
    with fleet:
        bulk = experiment.lagom_submit(
            demo_train_fn, cfg("bulk", bulk_trials), fleet=fleet,
            priority="low", weight=1.0, block=False)
        # The urgent arrival must hit a SATURATED fleet or there is
        # nothing to preempt: wait until bulk actually holds every
        # runner (driver startup latency varies), not a fixed delay.
        deadline = time.monotonic() + saturation_timeout_s
        while time.monotonic() < deadline:
            if bulk.entry.allocated() >= runners:
                break
            time.sleep(0.02)
        urgent = experiment.lagom_submit(
            demo_train_fn, cfg("urgent", urgent_trials), fleet=fleet,
            priority="high", weight=1.0, min_runners=1, max_runners=1,
            block=False)
        results = {"bulk": bulk.result(timeout=120),
                   "urgent": urgent.result(timeout=120)}
    wall_s = time.time() - t0
    return fleet_soak_report(fleet, base_dir, results,
                             {"bulk": bulk_trials, "urgent": urgent_trials},
                             starvation_bound_s, wall_s)


def fleet_soak_report(fleet, base_dir: str, results: Dict[str, Any],
                      trials: Dict[str, int], starvation_bound_s: float,
                      wall_s: float) -> Dict[str, Any]:
    """``run_fleet_soak``'s gates over a finished fleet: each tenant of
    ``trials`` finished its schedule, the chaos invariants hold on every
    experiment journal under ``base_dir``, every checkpointed preemption
    resumed, the fleet journal shows a preemption, and no tenant waited
    past ``starvation_bound_s`` for its first runner."""
    from maggy_tpu_torch.chaos.harness import check_invariants
    from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events

    journal = os.path.join(fleet.home_dir, FLEET_JOURNAL_NAME)
    replay = replay_fleet_journal(journal)
    violations: List[str] = []

    # Both experiments completed with their full schedules.
    for name, want in trials.items():
        if results[name].get("num_trials") != want:
            violations.append(
                "experiment {!r} finished {} of {} trials".format(
                    name, results[name].get("num_trials"), want))

    # Per-experiment journal invariants: no lost trial, exactly one FINAL
    # per trial, experiment finalized — plus the preempted-then-resumed
    # chain for whatever the scheduler preempted.
    preempted_total = 0
    resumed_from: List[int] = []
    for exp_dir in sorted(d for d in glob.glob(os.path.join(base_dir, "*"))
                          if os.path.isdir(d) and d != fleet.home_dir):
        jp = os.path.join(exp_dir, JOURNAL_NAME)
        if not os.path.exists(jp):
            continue
        events = read_events(jp)
        rep = check_invariants(events, stall_flag_bound_s=None)
        violations.extend("{}: {}".format(os.path.basename(exp_dir), v)
                          for v in rep["violations"])
        for ev in events:
            if ev.get("ev") != "trial":
                continue
            if ev.get("phase") == "preempted":
                preempted_total += 1
                if ev.get("checkpointed") and not any(
                        e.get("phase") == "resumed"
                        and e.get("trial") == ev.get("trial")
                        and e.get("t", 0) >= ev.get("t", 0)
                        for e in events):
                    violations.append(
                        "{}: trial {} preempted at checkpoint step {} but "
                        "never resumed".format(os.path.basename(exp_dir),
                                               ev.get("trial"),
                                               ev.get("step")))
            elif ev.get("phase") == "resumed" and \
                    ev.get("from_step") is not None:
                resumed_from.append(int(ev["from_step"]))

    # The scheduler must actually have preempted (fleet journal) and the
    # driver must have executed it (experiment journals agree).
    if replay["preemptions"] < 1:
        violations.append("no preemption: the urgent experiment joined a "
                          "full fleet but the scheduler never preempted")
    # Starvation bound — the fleet half of chaos invariant 7: every
    # admitted experiment starts leasing within the bound.
    mqw = replay.get("max_queue_wait_s")
    if mqw is not None and mqw > starvation_bound_s:
        violations.append(
            "starvation: an experiment waited {:.2f}s for its first "
            "runner (bound {:.1f}s)".format(mqw, starvation_bound_s))
    for name in trials:
        if name not in replay["experiments"]:
            violations.append(
                "fleet journal has no lease record for {!r}".format(name))

    detail = {
        "queue_wait_ms": replay["queue_wait_ms"],
        "preemptions": replay["preemptions"],
        "share": replay["share"],
        "expected_share": replay["expected_share"],
        "share_error": replay["share_error"],
        "max_queue_wait_s": replay["max_queue_wait_s"],
        "resumed_from_steps": sorted(resumed_from),
        "experiments": replay["experiments"],
        # Per-tenant chip-time ledger roll-up (lease-derived
        # chip-seconds + each tenant's own journal fold).
        "goodput": replay.get("goodput"),
        "wall_s": round(wall_s, 2),
    }
    return {"ok": not violations, "violations": violations,
            "results": {k: {"num_trials": v.get("num_trials"),
                            "best_val": v.get("best_val"),
                            "preemptions": v.get("preemptions", 0)}
                        for k, v in results.items()},
            "preempted": preempted_total,
            "replay": replay, "journal": journal, "detail": detail,
            "base_dir": base_dir}


# ------------------------------------------------------- share and isolation


def resident_train_fn(lr, units, reporter=None, ctx=None):
    """Fair-share resident trial: ~0.1 s of wall per trial so resident
    tenants hold leases long enough for share accounting to mean
    something while cheap tenants churn around them."""
    import time as _time

    value = 1.0 / (1.0 + abs(lr - 0.1) + units / 1e4)
    for step in range(2):
        if reporter is not None:
            reporter.broadcast(value * (step + 1), step=step)
        _time.sleep(0.05)
    return {"metric": value}


def _scale_config(name: str, trials: int, base_dir: str, seed: int,
                  hb_interval: float = 0.25, telemetry: bool = False):
    """Config for a cheap tenant: the health engine off, and telemetry off
    unless asked for (the JAX package's ``sink`` and ``verbose`` fields are
    not the port's: no journal sink, item 9b)."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace

    return OptimizationConfig(
        name=name, num_trials=trials, optimizer="randomsearch",
        searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2]),
                                units=("INTEGER", [8, 64])),
        direction="max", hb_interval=hb_interval, hb_loss_timeout=10.0,
        seed=seed, es_policy="none", experiment_dir=base_dir,
        telemetry=telemetry, health=False)


def run_weighted_share_soak(runners: int = 4, trials: int = 12,
                            seed: int = 7,
                            base_dir: Optional[str] = None,
                            share_error_bound: float = 0.35
                            ) -> Dict[str, Any]:
    """Fair-share phase: three resident tenants with weights 1/1/2 run
    concurrently; the journal-replayed share split over their overlap
    window must sit within ``share_error_bound`` of the weight-expected
    split."""
    from maggy_tpu_torch import experiment

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_share_")
    weights = {"res_a": 1.0, "res_b": 1.0, "res_c": 2.0}
    t0 = time.time()
    fleet = Fleet(runners=runners,
                  home_dir=os.path.join(base_dir, "fleet"))
    with fleet:
        handles = {
            name: experiment.lagom_submit(
                resident_train_fn,
                _scale_config(name, trials, base_dir, seed + i,
                              hb_interval=0.05),
                fleet=fleet, weight=weights[name], block=False, name=name)
            for i, name in enumerate(sorted(weights))}
        results = {n: h.result(timeout=300) for n, h in handles.items()}
    wall_s = time.time() - t0
    journal = os.path.join(fleet.home_dir, FLEET_JOURNAL_NAME)
    replay = replay_fleet_journal(journal, share_names=set(weights))
    violations: List[str] = []
    for name in sorted(weights):
        if results[name].get("num_trials") != trials:
            violations.append("{} finished {} of {} trials".format(
                name, results[name].get("num_trials"), trials))
    if replay["share_error"] is None:
        violations.append("no overlap window: share error not computable")
    elif replay["share_error"] > share_error_bound:
        violations.append(
            "fair-share error {} over the {} bound (shares {}, expected "
            "{})".format(replay["share_error"], share_error_bound,
                         replay["share"], replay["expected_share"]))
    detail = {"share": replay["share"],
              "expected_share": replay["expected_share"],
              "share_error": replay["share_error"],
              "wall_s": round(wall_s, 1)}
    return {"ok": not violations, "violations": violations,
            "detail": detail, "journal": journal, "base_dir": base_dir}


def slow_victim_train_fn(lr, units, reporter=None, ctx=None):
    """Victim-tenant trial for the slow-tenant soak: a few broadcasts
    with a short wall so hand-off gaps dominate the measurement."""
    import time as _time

    value = 1.0 / (1.0 + abs(lr - 0.1) + units / 1e4)
    for step in range(3):
        if reporter is not None:
            reporter.broadcast(value * (step + 1), step=step)
        _time.sleep(0.02)
    return {"metric": value}


def slow_tenant_train_fn(lr, units, reporter=None, ctx=None):
    """Slow-tenant trial: ~4 s of broadcasting wall per trial, so the
    tenant keeps heartbeating (each beat's handler artificially delayed
    by the soak's injection) for the whole window the victims sweep in —
    the overlap is what makes the head-of-line measurement mean
    anything."""
    import time as _time

    value = 1.0 / (1.0 + abs(lr - 0.1) + units / 1e4)
    for step in range(80):
        if reporter is not None:
            reporter.broadcast(value * (step + 1), step=step)
        _time.sleep(0.05)
    return {"metric": value}


def run_slow_tenant_soak(runners: int = 3, victims: int = 2,
                         victim_trials: int = 6, slow_trials: int = 2,
                         delay_ms: float = 150.0,
                         seed: int = 7,
                         base_dir: Optional[str] = None,
                         handoff_p95_bound_ms: float = 150.0,
                         victim_rtt_bound_ms: float = 50.0
                         ) -> Dict[str, Any]:
    """Head-of-line-isolation soak (the chaos side of the dispatch-pool
    refactor): one tenant's handlers are artificially delayed by
    ``delay_ms`` per heartbeat/FINAL (journaled as a ``chaos`` event,
    kind ``slow_tenant``), while ``victims`` ordinary tenants run their
    sweeps on the same shared listener. Invariants:

    - every victim completes with clean journal invariants (no lost
      trials, single FINALs);
    - every victim's journal-replayed hand-off p95 stays under
      ``handoff_p95_bound_ms`` (driver-side dispatch health);
    - every victim's journaled heartbeat RTT stays under
      ``victim_rtt_bound_ms`` — THE head-of-line signal: the RTT is
      measured client-side around the whole request, so shared-loop
      queueing behind the slow tenant's delayed handlers shows up here
      (the span-derived hand-off gap cannot see it: with the FINAL
      piggyback, ``finalized`` and ``running`` are journaled inside one
      dispatch).

    The JAX soak's ``dispatch_pool=False`` side (handlers on the shared
    loop, an A/B for its scale bench) is not ported: the port's shared
    listener always gives each tenant its dispatcher. Nor is its
    lock-order witness (``witness`` is None)."""
    import threading

    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.chaos.harness import check_invariants
    from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events
    from maggy_tpu_torch.telemetry.spans import derive

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_slowten_")
    delay_s = delay_ms / 1e3
    t0 = time.time()
    injected = {"n": 0}
    fleet = Fleet(runners=runners,
                  home_dir=os.path.join(base_dir, "fleet"))
    with fleet:
        slow = experiment.lagom_submit(
            slow_tenant_train_fn,
            _scale_config("slow", slow_trials, base_dir, seed,
                          hb_interval=0.02, telemetry=True),
            fleet=fleet, max_runners=1, block=False, name="slow")

        def inject():
            # Wrap the slow tenant's handler path the moment its
            # driver/server exist: every subsequent METRIC/BATCH/
            # FINAL it handles sleeps ``delay_s`` first, in its OWN
            # dispatcher, which the victims' replies must not wait on.
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                drv = slow.entry.driver
                server = getattr(drv, "server", None) \
                    if drv is not None else None
                if server is not None:
                    orig = server.handle_message

                    def delayed(msg, _orig=orig):
                        if msg.get("type") in ("METRIC", "BATCH",
                                               "FINAL"):
                            time.sleep(delay_s)
                            injected["n"] += 1
                        return _orig(msg)

                    server.handle_message = delayed
                    telem = getattr(drv, "telemetry", None)
                    if telem is not None:
                        telem.event("chaos", kind="slow_tenant",
                                    delay_ms=delay_ms)
                    return
                time.sleep(0.005)

        injector = threading.Thread(target=inject, daemon=True,
                                    name="slow-tenant-injector")
        injector.start()
        injector.join(timeout=35.0)
        victim_handles = {
            "victim{}".format(i): experiment.lagom_submit(
                slow_victim_train_fn,
                _scale_config("victim{}".format(i), victim_trials,
                              base_dir, seed + 1 + i,
                              hb_interval=0.05, telemetry=True),
                fleet=fleet, max_runners=1, block=False,
                name="victim{}".format(i))
            for i in range(victims)}
        results = {n: h.result(timeout=180)
                   for n, h in victim_handles.items()}
        results["slow"] = slow.result(timeout=180)
    wall_s = time.time() - t0

    violations: List[str] = []
    victim_p95: Dict[str, Any] = {}
    victim_rtt: Dict[str, Any] = {}
    journals: Dict[str, str] = {}
    for exp_dir in sorted(d for d in glob.glob(os.path.join(base_dir, "*"))
                          if os.path.isdir(d) and d != fleet.home_dir):
        jp = os.path.join(exp_dir, JOURNAL_NAME)
        if not os.path.exists(jp):
            continue
        events = read_events(jp)
        name = None
        for ev in events:
            if ev.get("ev") == "experiment" and ev.get("name"):
                name = ev["name"]
                break
        name = name or os.path.basename(exp_dir)
        journals[name] = jp
        rep = check_invariants(events, stall_flag_bound_s=None)
        violations.extend("{}: {}".format(name, v)
                          for v in rep["violations"])
        if "victim" in name:
            handoff = derive(events).get("handoff") or {}
            victim_p95[name] = handoff.get("p95_ms")
            if handoff.get("p95_ms") is not None \
                    and handoff["p95_ms"] > handoff_p95_bound_ms:
                violations.append(
                    "{}: hand-off p95 {} ms over the {} ms isolation "
                    "bound (slow tenant leaked into this tenant's "
                    "dispatch path)".format(name, handoff["p95_ms"],
                                            handoff_p95_bound_ms))
            rtts = sorted(ev["hb_rtt_ms"] for ev in events
                          if ev.get("ev") == "runner_stats"
                          and ev.get("hb_rtt_ms") is not None)
            victim_rtt[name] = rtts[-1] if rtts else None
            if rtts and rtts[-1] > victim_rtt_bound_ms:
                violations.append(
                    "{}: heartbeat RTT reached {} ms, over the {} ms "
                    "isolation bound (slow tenant leaked into this "
                    "tenant's reply path)".format(
                        name, rtts[-1], victim_rtt_bound_ms))
    for name, result in sorted(results.items()):
        want = slow_trials if name == "slow" else victim_trials
        if result.get("num_trials") != want:
            violations.append("{} finished {} of {} trials".format(
                name, result.get("num_trials"), want))
    if injected["n"] == 0:
        violations.append("slow_tenant fault never injected: the soak "
                          "exercised nothing")
    detail = {
        "delay_ms": delay_ms,
        "injections": injected["n"],
        "victim_handoff_p95_ms": victim_p95,
        "handoff_p95_bound_ms": handoff_p95_bound_ms,
        "victim_reply_rtt_ms": victim_rtt,
        "victim_rtt_bound_ms": victim_rtt_bound_ms,
        "wall_s": round(wall_s, 1),
        "witness": None,
    }
    return {"ok": not violations, "violations": violations,
            "detail": detail, "journals": journals,
            "witness": None, "base_dir": base_dir}
