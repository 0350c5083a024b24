"""``python -m maggy_tpu_torch.chaos`` — run a deterministic chaos soak.

Runs a real local lagom experiment of the port under a fault plan, prints
the invariant report as JSON and exits non-zero if any recovery invariant
is violated. Like the JAX package's CLI (``maggy_tpu/chaos/__main__.py``),
its trials are closed-form host loops that touch no device; the card's soaks
are ``chip_smoke.py``'s ``slice_chaos`` phase. With no ``--plan`` the
standard soak runs: a runner killed mid-trial, a false preemption, 5% METRIC
drops, and every 5th FINAL's reply severed.

    python -m maggy_tpu_torch.chaos --seed 7
    python -m maggy_tpu_torch.chaos --plan my_plan.json --trials 20 --workers 4
    python -m maggy_tpu_torch.chaos --stall [--obs]   # health-engine soak
    python -m maggy_tpu_torch.chaos --piggyback       # hand-off soak
    python -m maggy_tpu_torch.chaos --preempt         # preemption soak
    python -m maggy_tpu_torch.chaos --fork            # fork-kill soak
    python -m maggy_tpu_torch.chaos --goodput         # fault-free ledger soak
    python -m maggy_tpu_torch.chaos --vmap            # vectorized-block soak
    python -m maggy_tpu_torch.chaos --agent           # agent-kill soak
    python -m maggy_tpu_torch.chaos --sink            # sink-kill soak
    python -m maggy_tpu_torch.chaos --driver          # driver-kill soak
    python -m maggy_tpu_torch.chaos --show-schedule --seed 7   # no experiment

``--agent``, ``--sink`` and ``--driver`` own their whole topology (agent or
driver processes, or a fleet whose sink is detached mid-run; the kill is the
harness's, since no in-process plan can reach another process or the
fleet's sink), and their processes run with no card. ``--gang`` runs the
gang soak (its ranks on the device kind ``MAGGY_TPU_TORCH_DEVICE`` names,
"cuda" by default; ``cpu`` for a host without a card).

Every soak runs under the lock-order witness
(``maggy_tpu_torch.analysis.witness``) unless ``--no-witness``: the
acquisition edges the run takes are recorded, and an edge the static lock
order forbids fails the soak like an invariant violation.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maggy_tpu_torch.chaos",
        description="Deterministic fault-injection soak against a real "
                    "local lagom run of the port.")
    ap.add_argument("--plan", help="path to a FaultPlan JSON (default: the "
                                   "built-in kill+preempt+drop+sever soak)")
    ap.add_argument("--seed", type=int, default=None,
                    help="plan seed (default: the plan file's embedded "
                         "seed, or 7 for the built-in plans)")
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--pool", default="thread", choices=["thread", "process"],
                    help="runner substrate (process = real SIGKILL/SIGSTOP)")
    ap.add_argument("--hb-loss-timeout", type=float, default=None,
                    help="seconds of heartbeat silence before a runner is "
                         "declared lost (default 0.6; with --stall 10, so "
                         "the loss scan stays blind to the stall)")
    ap.add_argument("--stall", action="store_true",
                    help="a runner stalled below the loss bound; the health "
                         "engine must flag it (invariant 5)")
    ap.add_argument("--piggyback", action="store_true",
                    help="a runner killed between receiving a piggybacked "
                         "TRIAL and its first heartbeat; the trial requeues "
                         "exactly once (invariant 6)")
    ap.add_argument("--preempt", action="store_true",
                    help="a graceful checkpoint-assisted preemption: one "
                         "FINAL, and the trial resumes from its checkpoint "
                         "step (invariant 7)")
    ap.add_argument("--fork", action="store_true",
                    help="the runner of the first forked trial killed at "
                         "dispatch: one requeue, resumed from the same fork "
                         "point; plus one fork across lagom(..., "
                         "resume=True) (invariant 14)")
    ap.add_argument("--goodput", action="store_true",
                    help="the fault-free ledger soak: zero rework, at most "
                         "5%% unaccounted (invariant 15)")
    ap.add_argument("--vmap", action="store_true",
                    help="a vmap_lanes=4 sweep with the runner of the first "
                         "block killed: every live lane requeues once "
                         "(invariant 16)")
    ap.add_argument("--obs", action="store_true",
                    help="run with the observability plane on (invariant "
                         "9): a concurrent scraper holds /metrics, /status "
                         "and /healthz to answering truthfully, and a "
                         "stalled partition's first flag must journal "
                         "exactly one profile_captured artifact")
    ap.add_argument("--show-schedule", action="store_true",
                    help="print the plan's deterministic decision "
                         "expansion and exit (no experiment)")
    ap.add_argument("--agent", action="store_true",
                    help="the agent-kill soak: agent processes (--device cpu) "
                         "serve leases, one is SIGKILLed mid-lease; the lease "
                         "is revoked and the trial requeued exactly once "
                         "(invariant 11)")
    ap.add_argument("--sink", action="store_true",
                    help="the sink-kill soak: the fleet's journal sink is "
                         "killed mid-run and restarted; no event lost or "
                         "doubled, no experiment failed (invariant 12)")
    ap.add_argument("--driver", action="store_true",
                    help="the driver-kill soak: the driver process SIGKILLed "
                         "mid-sweep and resumed; its remote runners survive "
                         "and the sweep completes (invariant 13)")
    ap.add_argument("--gang", action="store_true",
                    help="the gang-revocation soak: a mixed 1-chip + 4-chip-fsdp ASHA "
                         "sweep with one member of the first assembled gang killed "
                         "mid-trial; the whole gang lease must be revoked and the trial "
                         "requeued exactly once (invariant 8)")
    ap.add_argument("--no-witness", action="store_true",
                    help="disable the runtime lock-order witness "
                         "(maggy_tpu_torch.analysis.witness; on by default so "
                         "every soak doubles as a dynamic lock-order check)")
    args = ap.parse_args(argv)

    from maggy_tpu_torch.chaos import harness
    from maggy_tpu_torch.chaos.plan import FaultPlan

    modes = [m for m in ("stall", "piggyback", "preempt", "gang", "fork", "goodput", "vmap")
             if getattr(args, m)]
    if args.plan and modes:
        ap.error("--{} uses a built-in plan; drop --plan".format(modes[0]))
    if len(modes) > 1:
        ap.error("pick one of --stall / --piggyback / --preempt / --gang / --fork / "
                 "--goodput / --vmap")
    seed = 7 if args.seed is None else args.seed
    witness = not args.no_witness
    if args.driver:
        from maggy_tpu_torch.chaos.driver_soak import run_driver_soak

        report = run_driver_soak(seed=seed, lock_witness=witness)
    elif args.sink:
        from maggy_tpu_torch.fleet.soak import run_sink_soak

        report = run_sink_soak(seed=seed, lock_witness=witness)
    elif args.agent:
        from maggy_tpu_torch.fleet.soak import run_agent_soak

        report = run_agent_soak(trials=min(args.trials, 6), seed=seed,
                                lock_witness=witness)
    elif args.vmap:
        report = harness.run_vmap_soak(seed=seed, num_trials=args.trials,
                                       lock_witness=witness)
    elif args.goodput:
        report = harness.run_goodput_soak(seed=seed, num_trials=args.trials,
                                          workers=args.workers, lock_witness=witness)
    elif args.fork:
        report = harness.run_fork_soak(seed=seed, lock_witness=witness)
    elif args.gang and not args.show_schedule:
        report = harness.run_gang_soak(seed=seed, num_trials=args.trials,
                                       lock_witness=witness)
    else:
        report = None
    if report is not None:
        print(json.dumps(report, indent=2, default=str))
        return 0 if report["ok"] else 1
    if args.plan:
        plan = FaultPlan.load(args.plan)
        # A reproduction honors the plan file's embedded seed; only an
        # explicit --seed overrides it.
        if args.seed is not None:
            plan.seed = args.seed
    elif args.stall:
        plan = harness.stall_plan(seed=seed)
    elif args.piggyback:
        plan = harness.piggyback_plan(seed=seed)
    elif args.preempt:
        plan = harness.preempt_plan(seed=seed)
    elif args.gang:
        plan = harness.gang_plan(seed=seed)
    else:
        plan = harness.default_plan(seed=seed)
    if args.show_schedule:
        print(json.dumps({"seed": plan.seed, "schedule": plan.fingerprint()}, indent=2))
        return 0
    if args.preempt:
        # A checkpointing, ctx-aware trial, so the resume provably restarts
        # from the checkpoint step.
        train_fn = harness.ckpt_train_fn
    else:
        # Module-level, so a spawned process runner unpickles it.
        train_fn = harness._soak_train_fn
    hb_loss = args.hb_loss_timeout
    soak_kwargs = dict(hb_loss_timeout=0.6 if hb_loss is None else hb_loss)
    if args.stall:
        # The loss scan stays blind to the stall by default (that is the
        # point), and the watchdog tightens; an explicit --hb-loss-timeout
        # is honored as given.
        soak_kwargs = dict(hb_loss_timeout=10.0 if hb_loss is None else hb_loss,
                           config_overrides={"health_hang_factor": 10.0,
                                             "health_interval_s": 0.1})
    report = harness.run_soak(plan=plan, seed=plan.seed, train_fn=train_fn,
                              num_trials=args.trials, workers=args.workers,
                              pool=args.pool, obs=args.obs, lock_witness=witness,
                              **soak_kwargs)
    print(json.dumps(report, indent=2, default=str))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
