"""Fleet soak: run concurrent experiments over one shared fleet and check
the scheduling invariants from the journal artifacts.

The port's copy of the in-process soaks of ``maggy_tpu/fleet/soak.py``
(``:28-1364``): ``demo_train_fn`` and ``run_fleet_soak``,
``run_weighted_share_soak`` and ``run_slow_tenant_soak`` with their train
functions. ``fleet_soak_report`` is ``run_fleet_soak``'s check of the
journals, apart so that ``chip_smoke.py``'s card soak holds its own two
tenants to the same gates. Their signatures name no device: the train
function decides where the work runs. Also the scale soaks
(``run_scale_churn``, ``run_remote_scale_soak``, ``run_scale_soak``), the
agent-kill soak (``run_agent_soak``, chaos invariant 11, on agent processes
that ``spawn_agent_process`` starts with ``--device cpu``) and the
journal-sink soak (``run_sink_soak``, invariant 12). The slow-tenant, agent
and sink soaks take ``lock_witness`` as the JAX soaks do (None defers to
``MAGGY_TPU_TORCH_LOCK_WITNESS``): armed, the soak runs under the port's
lock-order witness, its result carries a ``witness`` block (edges,
violations, acquisitions, the witness's own seconds) and a forbidden edge
is a violation. Left out: the slow-tenant A/B arm with the per-tenant
dispatch pools off, a path the port's shared listener does not have.

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
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

from maggy_tpu_torch.analysis.witness import SoakWitness
from maggy_tpu_torch.fleet.scheduler import (FLEET_JOURNAL_NAME, Fleet,
                                             replay_fleet_journal)

def _witness_block(wit: SoakWitness, violations: List[str]) -> Optional[Dict[str, Any]]:
    """A fleet soak's ``witness`` block (JAX ``fleet/soak.py:602-608``),
    with this soak's forbidden edges added to ``violations``; None when
    the witness is off."""
    reading = wit.reading()
    if reading is None:
        return None
    violations.extend("lock-order witness: {}".format(v) for v in reading["violations"])
    return {"edges": reading["edge_count"], "violations": len(reading["violations"]),
            "acquisitions": reading["acquisitions"], "busy_s": reading["busy_s"]}


#: The directory holding the maggy_tpu_torch package.
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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
                  hb_interval: float = 0.25, telemetry: bool = False,
                  sink: bool = False):
    """Config for a cheap churn tenant: the health engine off and, without
    the sink, its telemetry off too (hundreds of journals and flushers would
    measure journal fan-out, not the scheduler). ``sink=True`` turns
    telemetry back on through the fleet's journal sink: one shipper thread
    a process and per-source files under the fleet home."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace

    return OptimizationConfig(
        name=name, num_trials=trials, optimizer="randomsearch",
        searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2]),
                                units=("INTEGER", [8, 64])),
        direction="max", hb_interval=hb_interval, hb_loss_timeout=10.0,
        seed=seed, es_policy="none", experiment_dir=base_dir,
        telemetry=telemetry or sink, sink=sink, health=False,
        verbose=False)


def scale_train_fn(lr, units, reporter=None, ctx=None):
    """Cheapest possible tenant trial: pure python, one broadcast — the
    measurement is the control plane (admission, leasing, RPC, journal),
    never compute. Module-level so spool spec files can name it
    (``maggy_tpu_torch.fleet.soak:scale_train_fn``)."""
    value = 1.0 / (1.0 + abs(lr - 0.1) + units / 1e4)
    if reporter is not None:
        reporter.broadcast(value, step=0)
    return {"metric": value}


def run_scale_churn(experiments: int = 520, runners: int = 8,
                    max_active: int = 12, spool_specs: int = 24,
                    trials_per_exp: int = 1, seed: int = 7,
                    base_dir: Optional[str] = None,
                    max_queued: Optional[int] = None,
                    result_timeout_s: float = 900.0,
                    min_decisions_per_s: float = 10.0,
                    admission_p99_bound_s: Optional[float] = None,
                    sink: bool = False) -> Dict[str, Any]:
    """Churn soak: hammer ONE fleet with ``experiments`` concurrent cheap
    tenants — most via ``lagom_submit``, a slice via the spool path the
    CLI host uses — and gate the control plane's replayed numbers:

    - every admitted tenant completes its full schedule (no lost trials,
      no stuck admissions);
    - scheduler decision throughput (admits + leases + preempts + sheds
      per second) stays above ``min_decisions_per_s``;
    - admission latency p99 stays under ``admission_p99_bound_s``
      (default: the soak's own wall — i.e. the queue drains steadily
      instead of parking a cohort until the end).

    Deferred activation bounds live drivers to ``max_active`` no matter
    how many hundreds queue, which is what makes this shape feasible in
    one process at all."""
    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.core.environment import EnvSing
    from maggy_tpu_torch.fleet.__main__ import _drain_spool

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_scale_")
    env = EnvSing.get_instance()
    t0 = time.time()
    fleet = Fleet(runners=runners, home_dir=os.path.join(base_dir, "fleet"),
                  max_active=max_active, max_queued=max_queued,
                  preempt_grace_s=5.0)
    direct = max(0, experiments - spool_specs)
    handles = {}
    spool_handles: Dict[str, Any] = {}
    failures: Dict[str, str] = {}
    shed = 0
    with fleet:
        spool = fleet.home_dir + "/queue"
        env.mkdir(spool)
        for i in range(spool_specs):
            spec = {"name": "spool{:04d}".format(i),
                    "train_fn": "maggy_tpu_torch.fleet.soak:scale_train_fn",
                    "config": {"num_trials": trials_per_exp,
                               "optimizer": "randomsearch",
                               "direction": "max", "seed": seed + i,
                               "es_policy": "none", "telemetry": sink,
                               "sink": sink,
                               "health": False, "hb_interval": 0.25,
                               "searchspace": {
                                   "lr": ["DOUBLE", [0.0, 0.2]],
                                   "units": ["INTEGER", [8, 64]]}}}
            env.dump(json.dumps(spec),
                     "{}/spool{:04d}.json".format(spool, i))
        from maggy_tpu_torch.fleet.scheduler import FleetSaturated

        for i in range(direct):
            name = "churn{:04d}".format(i)
            try:
                handles[name] = experiment.lagom_submit(
                    scale_train_fn,
                    _scale_config(name, trials_per_exp, base_dir, seed + i,
                                  sink=sink),
                    fleet=fleet, block=False, name=name)
            except FleetSaturated:
                shed += 1  # expected under a max_queued bound
            except Exception as e:  # noqa: BLE001 - anything else is a real failure
                failures[name] = repr(e)
        # Spool drain with the bounded (seen-set) scan, like the CLI host.
        seen: set = set()
        deadline = time.monotonic() + result_timeout_s
        while len(spool_handles) < spool_specs \
                and time.monotonic() < deadline:
            _drain_spool(fleet, env, spool, spool_handles,
                         base_dir=base_dir, seen=seen)
            if len(spool_handles) < spool_specs:
                time.sleep(0.2)
        handles.update(spool_handles)
        for name, handle in sorted(handles.items()):
            try:
                left = max(1.0, deadline - time.monotonic())
                result = handle.result(timeout=left)
                if result.get("num_trials") != trials_per_exp:
                    failures[name] = "finished {} of {} trials".format(
                        result.get("num_trials"), trials_per_exp)
            except BaseException as e:  # noqa: BLE001 - one tenant's failure is a finding
                failures[name] = repr(e)
    wall_s = time.time() - t0

    journal = os.path.join(fleet.home_dir, FLEET_JOURNAL_NAME)
    replay = replay_fleet_journal(journal)
    violations: List[str] = []
    if failures:
        sample = dict(list(sorted(failures.items()))[:5])
        violations.append(
            "{} of {} tenants failed/incomplete (sample: {})".format(
                len(failures), len(handles) + len(failures), sample))
    rate = replay.get("decisions_per_s")
    if rate is not None and rate < min_decisions_per_s:
        violations.append(
            "decision throughput {:.1f}/s under the {:.0f}/s "
            "floor".format(rate, min_decisions_per_s))
    p99_bound = admission_p99_bound_s \
        if admission_p99_bound_s is not None else wall_s
    p99 = replay.get("admission_p99_ms")
    if p99 is not None and p99 > p99_bound * 1e3:
        violations.append(
            "admission latency p99 {:.0f} ms over the {:.0f} ms bound "
            "(queue not draining steadily)".format(p99, p99_bound * 1e3))
    detail = {
        "experiments": len(handles), "spooled": len(spool_handles),
        # failures may include submit-time names that never got a handle
        # — only subtract the ones that did.
        "completed": len(handles) - sum(1 for n in failures
                                        if n in handles),
        "failed": len(failures),
        # The journal is the source of truth for sheds — the scheduler
        # journals each refusal before raising, so counting the local
        # FleetSaturated tally on top would double-count them.
        "shed": replay.get("sheds", 0),
        "wall_s": round(wall_s, 1),
        "experiments_per_s": round(len(handles) / wall_s, 2)
        if wall_s > 0 else None,
        "admission_ms": replay["admission_ms"],
        "admission_p99_ms": replay["admission_p99_ms"],
        "decisions": replay["decisions"],
        "decisions_per_s": replay["decisions_per_s"],
        "queue_wait_ms": replay["queue_wait_ms"],
        "preemptions": replay["preemptions"],
        # Journal-sink ingest (zero when the churn ran telemetry-off).
        "telemetry_sink": sink,
        "sink": replay.get("sink"),
    }
    return {"ok": not violations, "violations": violations,
            "detail": detail, "journal": journal, "base_dir": base_dir}


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
                         victim_rtt_bound_ms: float = 50.0,
                         lock_witness: Optional[bool] = None
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
    listener always gives each tenant its dispatcher. ``lock_witness``
    arms the lock-order witness like the chaos soaks do; any forbidden
    edge is a violation."""
    import threading

    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.chaos.harness import check_invariants
    from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events
    from maggy_tpu_torch.telemetry.spans import derive

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_slowten_")
    delay_s = delay_ms / 1e3
    t0 = time.time()
    injected = {"n": 0}
    wit = SoakWitness(lock_witness)
    fleet = Fleet(runners=runners,
                  home_dir=os.path.join(base_dir, "fleet"))
    with wit, fleet:
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
    witness_block = _witness_block(wit, violations)
    detail = {
        "delay_ms": delay_ms,
        "injections": injected["n"],
        "victim_handoff_p95_ms": victim_p95,
        "handoff_p95_bound_ms": handoff_p95_bound_ms,
        "victim_reply_rtt_ms": victim_rtt,
        "victim_rtt_bound_ms": victim_rtt_bound_ms,
        "wall_s": round(wall_s, 1),
        "witness": witness_block,
    }
    return {"ok": not violations, "violations": violations,
            "detail": detail, "journals": journals,
            "witness": witness_block, "base_dir": base_dir}


def agent_train_fn(lr, units, reporter=None, ctx=None):
    """Remote-agent soak trial: ~1.5 s of broadcasting wall so a
    SIGKILL reliably lands MID-lease (the invariant-11 window), cheap
    enough that a soak of a dozen trials stays fast. Module-level so an
    ABIND lease can name it (``maggy_tpu_torch.fleet.soak:agent_train_fn``)."""
    import time as _time

    value = 1.0 / (1.0 + abs(lr - 0.1) + units / 1e4)
    for step in range(30):
        if reporter is not None:
            reporter.broadcast(value * (step + 1), step=step)
        _time.sleep(0.05)
    return {"metric": value}


def spawn_agent_process(ticket_path: str, obs_port: Optional[int] = None,
                        log_path: Optional[str] = None,
                        idle_exit_s: Optional[float] = None, device: str = "cpu"):
    """Start one agent (``python -m maggy_tpu_torch.fleet agent``) as an OS
    process of its own, on ``device`` (``--device cpu`` by default, where
    the JAX package's soaks set ``JAX_PLATFORMS=cpu``). Returns the Popen;
    ``stop_agent_processes`` ends it."""
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "maggy_tpu_torch.fleet", "agent",
           "--ticket", ticket_path, "--wait-ticket", "60", "--device", device]
    if obs_port is not None:
        cmd += ["--obs-port", str(obs_port)]
    if idle_exit_s is not None:
        cmd += ["--idle-exit", str(idle_exit_s)]
    env = dict(os.environ)
    # The child imports this package from where this process did, whatever
    # its working directory.
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = open(log_path, "ab") if log_path else subprocess.DEVNULL
    try:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT
                                if log_path else subprocess.DEVNULL, env=env)
    finally:
        if log_path:
            out.close()


def stop_agent_processes(procs, grace_s: float = 10.0) -> List[Optional[int]]:
    """End agent processes: SIGTERM, then SIGKILL for one still alive after
    ``grace_s`` (an agent wedged in a native call ignores nothing but the
    kill). Returns their exit codes."""
    import signal
    import subprocess

    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)
    return [p.returncode for p in procs]


def run_agent_soak(agents: int = 2, trials: int = 6, seed: int = 7,
                   base_dir: Optional[str] = None,
                   result_timeout_s: float = 240.0,
                   lease_timeout_s: float = 120.0,
                   lock_witness: Optional[bool] = None) -> Dict[str, Any]:
    """Chaos invariant 11: REAL agent processes serve leases over
    sockets; one is SIGKILLed mid-lease. The experiment's slot-reclaim
    liveness must requeue the killed trial EXACTLY once (the invariant-
    6/7/8 machinery extended to agent scope via the ``kill_agent`` chaos
    kind), the fleet must revoke the lease (``lease`` end
    ``reason=agent_lost`` + ``agent`` phase ``lost`` in fleet.jsonl),
    and the experiment must still complete its full schedule on the
    survivors (the thread runner + the remaining agent). The agents join
    before the tenant starts. ``lock_witness`` arms the lock-order witness
    in this process (the fleet, its agent plane and the tenant's driver)
    like the chaos soaks do."""
    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.chaos.harness import check_invariants
    from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_agent_soak_")
    t0 = time.time()
    wit = SoakWitness(lock_witness)
    fleet = Fleet(runners=1, max_agents=agents,
                  home_dir=os.path.join(base_dir, "fleet"),
                  agent_liveness_s=3.0, preempt_grace_s=5.0)
    procs = []
    killed = {"agent": None, "trial": None, "partition": None}
    violations: List[str] = []
    try:
        with wit, fleet:
            ticket = os.path.join(fleet.home_dir, "agent_ticket.json")
            for i in range(agents):
                procs.append(spawn_agent_process(
                    ticket, log_path=os.path.join(
                        base_dir, "agent{}.log".format(i))))
            # The agents join before the tenant starts: where an agent
            # process takes longer to start than the schedule takes on the
            # thread runner, no agent would ever hold a lease to kill.
            plane = fleet.agent_plane
            deadline = time.monotonic() + lease_timeout_s
            while len(plane.snapshot()) < agents \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            sub = experiment.lagom_submit(
                agent_train_fn,
                _scale_config("agentexp", trials, base_dir, seed,
                              hb_interval=0.05, telemetry=True),
                fleet=fleet, block=False, name="agentexp")
            # Wait for a LEASED agent whose partition holds a running
            # trial — the mid-lease window the kill must land in.
            deadline = time.monotonic() + lease_timeout_s
            while time.monotonic() < deadline and killed["agent"] is None \
                    and not sub.done():
                drv = sub.entry.driver
                if drv is None:
                    time.sleep(0.05)
                    continue
                for rec in plane.snapshot():
                    if rec["state"] != "leased" or rec["pid"] is None:
                        continue
                    tid = drv.server.reservations.get_assigned_trial(
                        rec["pid"])
                    if tid is None:
                        continue
                    drv.telemetry.event(
                        "chaos", kind="kill_agent", trial=tid,
                        partition=rec["pid"], agent=rec["agent"])
                    if not plane.kill_agent_by_runner(rec["runner"]):
                        violations.append(
                            "kill_agent could not signal agent {} "
                            "(runner {})".format(rec["agent"],
                                                 rec["runner"]))
                    killed.update(agent=rec["agent"], trial=tid,
                                  partition=rec["pid"])
                    break
                time.sleep(0.05)
            if killed["agent"] is None:
                violations.append(
                    "no agent lease with a running trial within {:.0f}s "
                    "— the kill was never injected".format(
                        lease_timeout_s))
            result = {}
            try:
                result = sub.result(timeout=result_timeout_s)
            except BaseException as e:  # noqa: BLE001 - a hung experiment IS the invariant-11 failure mode
                violations.append(
                    "experiment did not complete after the kill: {!r} — "
                    "the requeue machinery under test likely lost the "
                    "trial".format(e))
    finally:
        stop_agent_processes(procs)
    wall_s = time.time() - t0

    if result and result.get("num_trials") != trials:
        violations.append("experiment finished {} of {} trials".format(
            result.get("num_trials"), trials))
    # Experiment journal: lifecycle + exactly-once requeue for the kill.
    exp_journal = None
    report = None
    for exp_dir in sorted(d for d in glob.glob(os.path.join(base_dir, "*"))
                          if os.path.isdir(d) and d != fleet.home_dir):
        jp = os.path.join(exp_dir, JOURNAL_NAME)
        if os.path.exists(jp):
            exp_journal = jp
            report = check_invariants(read_events(jp),
                                      stall_flag_bound_s=None)
            violations.extend(report["violations"])
    if exp_journal is None:
        violations.append("no experiment journal found under "
                          "{}".format(base_dir))
    # Fleet journal: the lease-revocation half of invariant 11.
    fleet_journal = os.path.join(fleet.home_dir, FLEET_JOURNAL_NAME)
    replay = replay_fleet_journal(fleet_journal)
    agents_replay = replay.get("agents") or {}
    if agents_replay.get("joins", 0) < agents:
        violations.append(
            "only {} of {} agents ever joined the fleet".format(
                agents_replay.get("joins", 0), agents))
    if killed["agent"] is not None:
        if agents_replay.get("losses", 0) < 1:
            violations.append(
                "agent {} was killed but the fleet journal carries no "
                "agent 'lost' event".format(killed["agent"]))
        if agents_replay.get("lost_leases", 0) < 1:
            violations.append(
                "agent {} was killed mid-lease but no lease ended with "
                "reason=agent_lost".format(killed["agent"]))
        elif agents_replay.get("lost_leases", 0) > 1:
            violations.append(
                "one kill produced {} agent_lost lease revocations "
                "(expected exactly 1)".format(
                    agents_replay["lost_leases"]))
    witness_block = _witness_block(wit, violations)
    detail = {
        "agents": agents,
        "killed": killed,
        "agents_replay": agents_replay,
        "wall_s": round(wall_s, 1),
        "witness": witness_block,
    }
    return {"ok": not violations, "violations": violations,
            "detail": detail, "report": report,
            "journal": exp_journal, "fleet_journal": fleet_journal,
            "witness": witness_block, "base_dir": base_dir}


def sink_train_fn(lr, units, reporter=None):
    """Churn-shaped trial, stretched: enough broadcast steps that the
    sink soak's kill/recover window reliably lands while trials (and
    their journal events) are still flowing."""
    import time as _time

    value = 1.0 / (1.0 + abs(lr - 0.1) + units / 1e4)
    for step in range(4):
        if reporter is not None:
            reporter.broadcast(value * (step + 1), step=step)
        _time.sleep(0.08)
    return {"metric": value}


def run_sink_soak(tenants: int = 3, trials: int = 6, seed: int = 7,
                  base_dir: Optional[str] = None,
                  result_timeout_s: float = 240.0,
                  phase_timeout_s: float = 30.0,
                  lock_witness: Optional[bool] = None) -> Dict[str, Any]:
    """Chaos invariant 12 — the journal sink degrades, never dominates:
    tenants run with sink-routed telemetry (``config.sink``) while the
    soak KILLS the sink mid-run (``kill_sink``: the sink tenant detaches
    from the shared listener, exactly what a crashed/partitioned sink
    looks like to shippers) and restarts it once a shipper has provably
    degraded. Checked offline over the artifacts:

    - zero experiment failures: every tenant completes its schedule and
      its merged journal passes the standard trial invariants;
    - zero lost events: per source, the union of the sink's per-source
      segments and the surviving local journal covers every event id
      ``1..max`` (the degraded window re-shipped / fell back locally);
    - zero duplicates: the merged (sid-deduped) stream holds each event
      id exactly once across the fallback seam;
    - the seam is real: ``sink_degraded`` AND ``sink_recovered`` events
      exist, and the degraded source's local fallback journal exists.

    A soak-owned PROBE journal records on a steady cadence through the
    whole window, so the degrade/recover/re-ship path is exercised
    deterministically even when the tenants' own schedules drain early.
    ``lock_witness`` arms the lock-order witness like the chaos soaks do."""
    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.chaos.harness import check_invariants
    from maggy_tpu_torch.core.environment import EnvSing
    from maggy_tpu_torch.telemetry import JOURNAL_NAME, Telemetry, read_events
    from maggy_tpu_torch.telemetry.sink import (check_exactly_once,
                                          merge_source_events,
                                          sanitize_source)

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_sink_soak_")
    env = EnvSing.get_instance()
    t0 = time.time()
    wit = SoakWitness(lock_witness)
    fleet = Fleet(runners=2, home_dir=os.path.join(base_dir, "fleet"),
                  preempt_grace_s=5.0)
    violations: List[str] = []
    handles: Dict[str, Any] = {}
    probe: Optional[Telemetry] = None
    killed_t = None
    recovered_seen = False
    expected: Dict[str, int] = {}
    exp_dirs: Dict[str, str] = {}
    with wit, fleet:
        probe = Telemetry(
            env=env, journal_path=os.path.join(base_dir,
                                               "probe_local.jsonl"),
            enabled=True, sink=fleet.sink_binding(),
            sink_source="probe")
        for i in range(tenants):
            name = "sink{:02d}".format(i)
            handles[name] = experiment.lagom_submit(
                sink_train_fn,
                _scale_config(name, trials, base_dir, seed + i,
                              hb_interval=0.05, sink=True),
                fleet=fleet, block=False, name=name)

        def _tick(n: int) -> None:
            probe.event("runner_stats", partition=0, probe=n)

        # Phase 1: the sink must be provably ingesting.
        deadline = time.monotonic() + phase_timeout_s
        n = 0
        while time.monotonic() < deadline:
            _tick(n)
            n += 1
            snap = fleet.sink.snapshot()
            if any(s["ingested"] > 0 for s in snap.values()):
                break
            time.sleep(0.1)
        else:
            violations.append(
                "sink never ingested a batch within {:.0f}s — the "
                "kill had nothing to degrade".format(phase_timeout_s))
        # Phase 2: kill the sink; a shipper must degrade.
        fleet.telemetry.event("chaos", kind="kill_sink")
        fleet.kill_sink()
        killed_t = time.time()
        deadline = time.monotonic() + phase_timeout_s
        while time.monotonic() < deadline:
            _tick(n)
            n += 1
            if probe.journal is not None and probe.journal.degraded:
                break
            time.sleep(0.1)
        else:
            violations.append(
                "no shipper degraded within {:.0f}s of the sink "
                "kill".format(phase_timeout_s))
        # Phase 3: restart; the degraded shipper must recover and
        # re-ship its spool.
        fleet.restart_sink()
        deadline = time.monotonic() + phase_timeout_s
        while time.monotonic() < deadline:
            _tick(n)
            n += 1
            if probe.journal is not None \
                    and not probe.journal.degraded:
                recovered_seen = True
                break
            time.sleep(0.1)
        if not recovered_seen:
            violations.append(
                "shipper did not recover within {:.0f}s of the sink "
                "restart".format(phase_timeout_s))
        for name, handle in sorted(handles.items()):
            try:
                result = handle.result(timeout=result_timeout_s)
                if result.get("num_trials") != trials:
                    violations.append(
                        "{} finished {} of {} trials".format(
                            name, result.get("num_trials"), trials))
            except BaseException as e:  # noqa: BLE001 - a failed tenant IS the invariant failure
                violations.append(
                    "experiment {} failed after the sink kill: "
                    "{!r}".format(name, e))
        probe.close()
        expected["probe"] = probe.journal.max_sid() \
            if probe.journal is not None else 0
        for name, handle in handles.items():
            drv = handle.entry.driver
            if drv is None:
                continue
            exp_dirs[name] = drv.exp_dir
            max_sid = getattr(drv.telemetry.journal, "max_sid", None)
            if max_sid is not None:
                expected[name] = max_sid()
    wall_s = time.time() - t0

    # Offline exactly-once check per source over sink segments + the
    # surviving local journals.
    sink_dir = os.path.join(fleet.home_dir, "journal")
    degraded_events = 0
    recovered_events = 0
    per_source: Dict[str, Dict[str, Any]] = {}
    local_paths = {"probe": os.path.join(base_dir, "probe_local.jsonl")}
    for name, exp_dir in exp_dirs.items():
        local_paths[name] = os.path.join(exp_dir, JOURNAL_NAME)
    for source, want in sorted(expected.items()):
        spath = os.path.join(sink_dir,
                             sanitize_source(source) + ".jsonl")
        shipped = read_events(spath) if os.path.exists(spath) else None
        lpath = local_paths.get(source)
        local = read_events(lpath) \
            if lpath and os.path.exists(lpath) else None
        merged = merge_source_events(shipped, local)
        source_violations = check_exactly_once(merged,
                                               expected_max_sid=want)
        degraded_events += sum(1 for e in merged
                               if e.get("ev") == "sink_degraded")
        recovered_events += sum(1 for e in merged
                                if e.get("ev") == "sink_recovered")
        if source != "probe":
            report = check_invariants(merged, stall_flag_bound_s=None)
            source_violations.extend(report["violations"])
        per_source[source] = {
            "expected": want,
            "sink_events": len(shipped) if shipped is not None else 0,
            "local_events": len(local) if local is not None else 0,
            "merged": len(merged),
            "violations": source_violations,
        }
        violations.extend("{}: {}".format(source, v)
                          for v in source_violations)
    if killed_t is not None and degraded_events < 1:
        violations.append("sink killed but no sink_degraded event "
                          "survives in any merged journal")
    if recovered_seen and recovered_events < 1:
        violations.append("shipper recovered but no sink_recovered "
                          "event survives in any merged journal")
    witness_block = _witness_block(wit, violations)
    detail = {
        "tenants": tenants,
        "killed_t": killed_t,
        "degraded_events": degraded_events,
        "recovered_events": recovered_events,
        "per_source": per_source,
        "wall_s": round(wall_s, 1),
        "witness": witness_block,
    }
    return {"ok": not violations, "violations": violations,
            "detail": detail, "sink_dir": sink_dir,
            "fleet_journal": os.path.join(fleet.home_dir,
                                          FLEET_JOURNAL_NAME),
            "witness": witness_block, "base_dir": base_dir}


def run_remote_scale_soak(experiments: int = 40, agents: int = 4,
                          runners: int = 2, max_active: int = 8,
                          trials_per_exp: int = 1, seed: int = 7,
                          base_dir: Optional[str] = None,
                          result_timeout_s: float = 600.0
                          ) -> Dict[str, Any]:
    """The remote half of ROADMAP item 4 ("nothing yet measures hundreds
    of sockets"): the PR-11 churn driven by REAL agent processes over
    sockets — every agent is a separate OS process dialing the shared
    listener, every lease a full AJOIN/ABIND/REG/.../ADONE round trip.
    Gates: every tenant completes, every agent joins, remote leases
    actually happened (the churn must not quietly drain through the
    thread runners alone), and — with the journal sink on — the run
    yields ONE ``--unified`` Perfetto trace: driver track, one process
    group per agent, ABIND->execution->FINAL flow arrows, event order
    consistent with the journaled clock offsets. Records
    ``detail.remote``: agent join latency p50/p95 (process spawn ->
    fleet journal join), ABIND lease round-trip p50/p95, churn
    completion, and the unified-trace block."""
    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.fleet.scheduler import FleetSaturated
    from maggy_tpu_torch.telemetry import read_events
    from maggy_tpu_torch.telemetry.spans import _dist_stats

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_remote_scale_")
    t0 = time.time()
    fleet = Fleet(runners=runners, max_agents=agents,
                  home_dir=os.path.join(base_dir, "fleet"),
                  max_active=max_active, agent_liveness_s=10.0,
                  preempt_grace_s=5.0)
    procs = []
    spawn_wall: List[float] = []
    handles: Dict[str, Any] = {}
    failures: Dict[str, str] = {}
    try:
        with fleet:
            ticket = os.path.join(fleet.home_dir, "agent_ticket.json")
            for i in range(agents):
                spawn_wall.append(time.time())
                procs.append(spawn_agent_process(
                    ticket, log_path=os.path.join(
                        base_dir, "agent{}.log".format(i))))
            # As in run_agent_soak: the churn starts once the agents joined,
            # or a short churn drains through the thread runners alone.
            deadline = time.monotonic() + result_timeout_s
            while len(fleet.agent_plane.snapshot()) < agents \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            for i in range(experiments):
                name = "remote{:04d}".format(i)
                try:
                    handles[name] = experiment.lagom_submit(
                        scale_train_fn,
                        _scale_config(name, trials_per_exp, base_dir,
                                      seed + i, sink=True),
                        fleet=fleet, block=False, name=name)
                except FleetSaturated:
                    pass
                except Exception as e:  # noqa: BLE001 - a real submission failure
                    failures[name] = repr(e)
            deadline = time.monotonic() + result_timeout_s
            for name, handle in sorted(handles.items()):
                try:
                    left = max(1.0, deadline - time.monotonic())
                    result = handle.result(timeout=left)
                    if result.get("num_trials") != trials_per_exp:
                        failures[name] = "finished {} of {} trials".format(
                            result.get("num_trials"), trials_per_exp)
                except BaseException as e:  # noqa: BLE001 - one tenant's failure is a finding
                    failures[name] = repr(e)
    finally:
        stop_agent_processes(procs)
    wall_s = time.time() - t0

    journal = os.path.join(fleet.home_dir, FLEET_JOURNAL_NAME)
    replay = replay_fleet_journal(journal)
    agents_replay = replay.get("agents") or {}
    # Join latency: process spawn wall time -> the fleet journal's agent
    # join stamp, matched in order (agents join in spawn order on an
    # idle fleet; ties are within measurement noise).
    join_ts = sorted(ev.get("t") for ev in read_events(journal)
                     if ev.get("ev") == "agent"
                     and ev.get("phase") == "join"
                     and ev.get("t") is not None)
    join_ms = [(t - s) * 1e3 for s, t in zip(spawn_wall, join_ts)
               if t >= s]
    # Remote leases: leases granted to agent-slot runners (runner index
    # >= the thread-fleet size).
    remote_leases = sum(1 for ev in read_events(journal)
                        if ev.get("ev") == "lease"
                        and ev.get("phase") == "start"
                        and isinstance(ev.get("runner"), int)
                        and ev["runner"] >= runners)
    violations: List[str] = []
    if failures:
        sample = dict(list(sorted(failures.items()))[:5])
        violations.append(
            "{} of {} tenants failed/incomplete (sample: {})".format(
                len(failures), len(handles), sample))
    if agents_replay.get("joins", 0) < agents:
        violations.append("only {} of {} agents joined".format(
            agents_replay.get("joins", 0), agents))
    if remote_leases < 1:
        violations.append(
            "no lease was ever granted to a remote agent — the churn "
            "drained entirely through thread runners")
    # The unified trace: fleet journal + sink segments merged with any
    # surviving local journals, clock-corrected, flow-arrowed — the
    # artifact the acceptance gate inspects.
    unified: Dict[str, Any] = {}
    try:
        from maggy_tpu_torch.telemetry.sink import (SINK_DIR_NAME,
                                              merge_source_events,
                                              read_sink_dir,
                                              sanitize_source)
        from maggy_tpu_torch.telemetry.trace import (build_unified_trace,
                                               validate_trace)

        fleet_events = read_events(journal)
        sink_map = read_sink_dir(os.path.join(fleet.home_dir,
                                              SINK_DIR_NAME))
        agent_ids = {str(ev.get("agent")) for ev in fleet_events
                     if ev.get("ev") == "agent"
                     and ev.get("phase") == "join" and ev.get("agent")}
        exp_events: Dict[str, Any] = {}
        for name in handles:
            shipped = sink_map.pop(sanitize_source(name), None)
            if shipped:
                exp_events[name] = merge_source_events(shipped)
        agent_journals = {src: evs for src, evs in sink_map.items()
                          if src in agent_ids}
        trace = build_unified_trace(fleet_events, exp_events,
                                    agent_journals=agent_journals)
        validate_trace(trace)
        out_path = os.path.join(fleet.home_dir, "unified_trace.json")
        with open(out_path, "w") as f:
            json.dump(trace, f)
        other = trace.get("otherData") or {}
        unified = {"path": out_path,
                   "agents": len(other.get("agents") or []),
                   "flows": other.get("flows", 0),
                   "clock_offsets": len(other.get("clock_offsets")
                                        or {})}
        if unified["agents"] < min(2, agents):
            violations.append(
                "unified trace carries {} agent process group(s) "
                "(expected >= {})".format(unified["agents"],
                                          min(2, agents)))
        if unified["flows"] < 1:
            violations.append(
                "unified trace carries no ABIND->execution flow arrows")
    except Exception as e:  # noqa: BLE001 - a broken trace build is a gate failure, not a crash
        violations.append("unified trace build failed: {!r}".format(e))
    detail = {
        "experiments": len(handles),
        "completed": len(handles) - sum(1 for n in failures
                                        if n in handles),
        "failed": len(failures),
        "agents": agents,
        "agent_joins": agents_replay.get("joins", 0),
        "agent_join_ms": _dist_stats(join_ms),
        "abind_ms": agents_replay.get("abind_ms"),
        "remote_leases": remote_leases,
        "total_leases": agents_replay.get("leases", 0),
        "unified": unified,
        "sink": replay.get("sink"),
        "clock_offsets": replay.get("clock_offsets"),
        "wall_s": round(wall_s, 1),
        "experiments_per_s": round(len(handles) / wall_s, 2)
        if wall_s > 0 else None,
        "decisions_per_s": replay.get("decisions_per_s"),
        "admission_p99_ms": replay.get("admission_p99_ms"),
    }
    return {"ok": not violations, "violations": violations,
            "detail": detail, "journal": journal, "base_dir": base_dir}


def run_scale_soak(experiments: int = 520, runners: int = 8,
                   max_active: int = 12, seed: int = 7,
                   base_dir: Optional[str] = None,
                   churn_kwargs: Optional[Dict[str, Any]] = None,
                   sink_ab: bool = True,
                   sink_throughput_ratio: float = 0.9,
                   sink_lag_p95_bound_ms: float = 10_000.0
                   ) -> Dict[str, Any]:
    """The JAX package's ``bench.py --scale`` scenario:

    1. **churn** — ``experiments`` concurrent cheap tenants through one
       fleet (lagom_submit + spool), gating completion, scheduler
       decision throughput, and admission latency p99;
    2. **sink A/B** — the SAME churn with telemetry re-enabled through
       the fleet's journal sink (``config.sink``): decision throughput
       must stay within ``sink_throughput_ratio`` (default 10%) of the
       telemetry-off baseline, admission p99 within the mirrored 10%
       bound, and the sink's replayed ingest lag p95 under
       ``sink_lag_p95_bound_ms`` — telemetry at churn scale must be
       near-free, or the sink is dominating instead of observing;
    3. **fair share** — three weighted residents, gating journal-replayed
       share error;
    4. **slow tenant**: the head-of-line isolation soak; victims'
       hand-off p95 must hold the isolation bound. (The JAX package also
       runs it with the per-tenant dispatch pools off, an A/B whose
       shared-loop path the port does not have.)
    """
    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_scale_soak_")
    churn = run_scale_churn(
        experiments=experiments, runners=runners, max_active=max_active,
        seed=seed, base_dir=os.path.join(base_dir, "churn"),
        **(churn_kwargs or {}))
    sink_detail = None
    sink_violations: List[str] = []
    if sink_ab:
        churn_sink = run_scale_churn(
            experiments=experiments, runners=runners,
            max_active=max_active, seed=seed,
            base_dir=os.path.join(base_dir, "churn_sink"), sink=True,
            **(churn_kwargs or {}))
        sink_violations.extend(churn_sink["violations"])
        off_rate = churn["detail"].get("decisions_per_s")
        on_rate = churn_sink["detail"].get("decisions_per_s")
        rate_ratio = None
        if off_rate and on_rate:
            rate_ratio = round(on_rate / off_rate, 3)
            if rate_ratio < sink_throughput_ratio:
                sink_violations.append(
                    "sink-on decision throughput {:.1f}/s is {:.0%} of "
                    "the telemetry-off baseline {:.1f}/s (floor "
                    "{:.0%})".format(on_rate, on_rate / off_rate,
                                     off_rate, sink_throughput_ratio))
        off_p99 = churn["detail"].get("admission_p99_ms")
        on_p99 = churn_sink["detail"].get("admission_p99_ms")
        p99_ratio = None
        if off_p99 and on_p99:
            p99_ratio = round(on_p99 / off_p99, 3)
            # Mirrored 10% bound, with an absolute floor so sub-second
            # p99s don't fail on scheduler jitter.
            if on_p99 > off_p99 * (2 - sink_throughput_ratio) + 500.0:
                sink_violations.append(
                    "sink-on admission p99 {:.0f} ms exceeds the "
                    "telemetry-off baseline {:.0f} ms by more than "
                    "{:.0%}".format(on_p99, off_p99,
                                    1 - sink_throughput_ratio))
        sink_replay = churn_sink["detail"].get("sink") or {}
        lag_p95 = (sink_replay.get("lag_ms") or {}).get("p95_ms")
        if not sink_replay.get("events"):
            sink_violations.append(
                "sink arm ran but the fleet journal carries no jsink "
                "ingest records — tenants did not ship")
        elif lag_p95 is not None and lag_p95 > sink_lag_p95_bound_ms:
            sink_violations.append(
                "sink ingest lag p95 {:.0f} ms over the {:.0f} ms "
                "bound".format(lag_p95, sink_lag_p95_bound_ms))
        sink_detail = {
            "baseline": {"decisions_per_s": off_rate,
                         "admission_p99_ms": off_p99},
            "sink_on": churn_sink["detail"],
            "decisions_ratio": rate_ratio,
            "admission_p99_ratio": p99_ratio,
            "ingest_lag_p95_ms": lag_p95,
            "ingest": sink_replay,
        }
    share = run_weighted_share_soak(
        seed=seed, base_dir=os.path.join(base_dir, "share"))
    pooled = run_slow_tenant_soak(
        seed=seed, base_dir=os.path.join(base_dir, "slow_pooled"))
    violations: List[str] = []
    violations.extend("churn: {}".format(v) for v in churn["violations"])
    violations.extend("sink: {}".format(v) for v in sink_violations)
    violations.extend("share: {}".format(v) for v in share["violations"])
    violations.extend("slow_tenant: {}".format(v) for v in pooled["violations"])
    detail = {
        "churn": churn["detail"],
        "sink": sink_detail,
        "share": share["detail"],
        "slow_tenant": pooled["detail"],
    }
    return {"ok": not violations, "violations": violations,
            "detail": detail, "base_dir": base_dir,
            "journal": churn["journal"]}
