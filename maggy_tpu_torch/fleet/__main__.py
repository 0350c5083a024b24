"""``python -m maggy_tpu_torch.fleet`` — host, feed, and watch a shared fleet.

    start   host a fleet in this process and serve submissions from a
            spec file and/or the fleet home's ``queue/`` spool directory
            (``--max-agents N`` also opens the agent plane and writes
            ``<home>/agent_ticket.json``)
    agent   run an agent process: read the fleet ticket, JOIN, and serve
            leases on ``--device`` (default cuda) until the fleet releases
            it
    submit  drop a submission JSON into a running fleet's spool
    status  print the fleet's status.json + journal-replayed shares
    soak    run the built-in two-experiment preemption soak (invariants
            checked; exit 1 on violation); ``--slow-tenant`` runs the
            head-of-line isolation soak, ``--agent`` the agent-kill soak
            (invariant 11) with real agent processes on the CPU, ``--sink``
            the journal-sink soak (invariant 12)

The port's copy of ``maggy_tpu/fleet/__main__.py``. The agent, sink and
slow-tenant soaks run under the port's lock-order witness
(``maggy_tpu_torch.analysis.witness``), as the JAX CLI's do.

A submission spec names a module-level train function and the
OptimizationConfig fields (searchspace as ``{name: [TYPE, range]}``):

    {"name": "sweep_a",
     "train_fn": "maggy_tpu_torch.fleet.soak:demo_train_fn",
     "priority": "normal", "weight": 2.0,
     "min_runners": 0, "max_runners": 4,
     "config": {"num_trials": 8, "optimizer": "randomsearch",
                "direction": "max",
                "searchspace": {"lr": ["DOUBLE", [0.0, 0.2]],
                                "units": ["INTEGER", [8, 64]]}}}

Spool submissions are claimed with ``exclusive_create`` (a ``.claimed``
marker), so several feeders can share one spool without double-running.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
import uuid
from typing import Any, Dict


def _load_train_fn(spec: str):
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(
            "train_fn must be 'module.path:function', got {!r}".format(spec))
    return getattr(importlib.import_module(mod_name), fn_name)


def _build_config(conf: Dict[str, Any], base_dir=None):
    from maggy_tpu_torch import OptimizationConfig, Searchspace

    conf = dict(conf)
    space = conf.pop("searchspace", None)
    if space is not None and not isinstance(space, Searchspace):
        space = Searchspace(**{k: (v[0], v[1]) for k, v in space.items()})
    if base_dir and not conf.get("experiment_dir"):
        conf["experiment_dir"] = base_dir
    return OptimizationConfig(searchspace=space, **conf)


def _submit_spec(fleet, spec: Dict[str, Any], handles: Dict[str, Any],
                 base_dir=None) -> None:
    from maggy_tpu_torch import experiment

    handle = experiment.lagom_submit(
        _load_train_fn(spec["train_fn"]),
        _build_config(spec.get("config", {}), base_dir=base_dir),
        fleet=fleet,
        priority=spec.get("priority", "normal"),
        weight=spec.get("weight", 1.0),
        min_runners=spec.get("min_runners", 0),
        max_runners=spec.get("max_runners"),
        name=spec.get("name"), block=False)
    handles[handle.name] = handle
    print("submitted {!r} (priority={}, weight={})".format(
        handle.name, spec.get("priority", "normal"),
        spec.get("weight", 1.0)), flush=True)


def _drain_spool(fleet, env, spool: str, handles: Dict[str, Any],
                 base_dir=None, seen=None) -> int:
    """Claim and submit every unclaimed spec in the spool dir. The claim
    marker (exclusive_create) makes multiple hosts/restarts safe.

    Bounded scan: ``seen`` (caller-held, persisted across polls) records
    every spec name already resolved — claimed by us, observed claimed
    by another feeder, or submitted — so a poll over a spool holding
    thousands of processed specs costs ONE directory listing plus
    set-membership checks, not O(files) ``exists`` round trips per
    claim. Claim markers are only consulted for names this process has
    never resolved. A saturated fleet (admission queue at its
    ``max_queued`` bound) stops the drain WITHOUT claiming: unclaimed
    specs are the spool's natural backpressure buffer, picked up again
    once the queue drains — claiming and shedding would lose them."""
    from maggy_tpu_torch.fleet.scheduler import FleetSaturated

    n = 0
    for name in sorted(env.ls(spool)):
        if not name.endswith(".json"):
            continue
        if seen is not None and name in seen:
            continue
        if fleet.scheduler.saturated():
            break
        path = "{}/{}".format(spool, name)
        marker = path + ".claimed"
        if env.exists(marker):
            if seen is not None:
                seen.add(name)
            continue
        if not env.exclusive_create(
                json.dumps({"claimed_at": time.time(),
                            "pid": os.getpid()}), marker):
            if seen is not None:
                seen.add(name)
            continue
        if seen is not None:
            seen.add(name)
        try:
            _submit_spec(fleet, json.loads(env.load(path)), handles,
                         base_dir=base_dir)
            n += 1
        except FleetSaturated:
            # Raced past the pre-claim check (a concurrent submit filled
            # the queue): un-burn the claim so the spec is retried — by
            # this host or any other — once the queue drains. Losing it
            # would contradict the spool's backpressure contract.
            try:
                env.delete(marker)
            except Exception:  # noqa: BLE001 - a stuck marker only delays the retry
                pass
            if seen is not None:
                seen.discard(name)
            break
        except Exception as e:  # noqa: BLE001 - one bad spec must not kill the host
            print("bad submission {}: {!r}".format(name, e),
                  file=sys.stderr, flush=True)
    return n


def _cmd_start(args) -> int:
    from maggy_tpu_torch.core.environment import EnvSing
    from maggy_tpu_torch.fleet import Fleet

    env = EnvSing.get_instance()
    fleet = Fleet(runners=args.runners, name=args.name,
                  home_dir=args.home, max_active=args.max_active,
                  max_queued=args.max_queued,
                  preempt_grace_s=args.preempt_grace,
                  max_agents=args.max_agents,
                  bind_host=args.bind_host,
                  agent_liveness_s=args.agent_liveness,
                  sink=False if args.no_sink else None)
    spool = fleet.home_dir + "/queue"
    env.mkdir(spool)
    handles: Dict[str, Any] = {}
    seen: set = set()
    with fleet:
        print("fleet {!r}: {} runner(s), {} agent slot(s), home {}".format(
            fleet.name, fleet.num_runners, fleet.max_agents,
            fleet.home_dir), flush=True)
        if fleet.agent_plane is not None:
            print("agent ticket: {}/agent_ticket.json".format(fleet.home_dir), flush=True)
        for spec_path in args.spec or []:
            with open(spec_path) as f:
                loaded = json.load(f)
            for spec in loaded if isinstance(loaded, list) else [loaded]:
                _submit_spec(fleet, spec, handles, base_dir=args.base_dir)
        idle_since = None
        while True:
            _drain_spool(fleet, env, spool, handles,
                         base_dir=args.base_dir, seen=seen)
            pending = [h for h in handles.values() if not h.done()]
            if pending:
                idle_since = None
            elif args.idle_exit is not None:
                idle_since = idle_since or time.monotonic()
                if time.monotonic() - idle_since >= args.idle_exit:
                    break
            time.sleep(args.poll)
    failures = 0
    for name, h in sorted(handles.items()):
        try:
            result = h.result(timeout=0)
            print("{}: FINISHED best={}".format(
                name, result.get("best_val") if isinstance(result, dict)
                else result), flush=True)
        except BaseException as e:  # noqa: BLE001 - report, keep printing the rest
            failures += 1
            print("{}: FAILED {!r}".format(name, e), flush=True)
    return 1 if failures else 0


def _cmd_submit(args) -> int:
    from maggy_tpu_torch.core.environment import EnvSing

    env = EnvSing.get_instance()
    with open(args.spec) as f:
        spec = json.load(f)
    name = spec.get("name", "experiment")
    path = "{}/queue/{}-{}.json".format(args.home.rstrip("/"), name,
                                        uuid.uuid4().hex[:8])
    if not env.exclusive_create(json.dumps(spec, indent=2), path):
        print("spool collision at {}; retry".format(path), file=sys.stderr)
        return 1
    print("queued {} -> {}".format(name, path))
    return 0


def _cmd_status(args) -> int:
    from maggy_tpu_torch.monitor import _poll_fleet, render_fleet

    print(render_fleet(*_poll_fleet(args.home)))
    return 0


def _cmd_agent(args) -> int:
    from maggy_tpu_torch.fleet.agent import agent_main

    return agent_main(args)


def _cmd_soak(args) -> int:
    from maggy_tpu_torch.fleet.soak import (run_agent_soak, run_fleet_soak,
                                            run_sink_soak, run_slow_tenant_soak)

    if args.sink:
        report = run_sink_soak(seed=args.seed, lock_witness=True)
    elif args.agent:
        report = run_agent_soak(seed=args.seed, lock_witness=True)
    elif args.slow_tenant:
        # Witness on, like the chaos CLI's soaks: the isolation run doubles
        # as a dynamic lock-order check.
        report = run_slow_tenant_soak(seed=args.seed, lock_witness=True)
    else:
        report = run_fleet_soak(runners=args.runners, seed=args.seed)
    print(json.dumps(report, indent=2, default=str))
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m maggy_tpu_torch.fleet",
        description="Host, feed, and watch a shared experiment fleet.")
    sub = p.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("start", help="host a fleet in this process")
    ps.add_argument("--home", help="fleet home dir (journal, status.json, "
                                   "queue/ spool); default under the "
                                   "environment base dir")
    ps.add_argument("--name", default="fleet")
    ps.add_argument("--runners", type=int, default=2)
    ps.add_argument("--max-active", type=int, default=None,
                    help="admission cap: concurrent experiments competing "
                         "for runners (default unbounded)")
    ps.add_argument("--max-queued", type=int, default=None,
                    help="admission-queue bound: submissions past it are "
                         "shed (journaled 'shed' events); the spool "
                         "feeder stops claiming while saturated "
                         "(default unbounded)")
    ps.add_argument("--preempt-grace", type=float, default=1.0,
                    help="seconds an experiment may sit below its "
                         "guaranteed allocation before the scheduler "
                         "preempts a victim")
    ps.add_argument("--spec", action="append",
                    help="submission spec JSON (file with one spec or a "
                         "list); repeatable")
    ps.add_argument("--base-dir", help="experiment_dir for submissions "
                                       "that don't set one")
    ps.add_argument("--poll", type=float, default=1.0,
                    help="spool poll interval seconds")
    ps.add_argument("--idle-exit", type=float, default=None,
                    help="exit after this many idle seconds (no pending "
                         "experiments, empty spool); default: run forever")
    ps.add_argument("--max-agents", type=int, default=0,
                    help="agent slots: >0 opens the agent plane and writes "
                         "<home>/agent_ticket.json for `python -m "
                         "maggy_tpu_torch.fleet agent` processes (default 0: "
                         "thread runners only)")
    ps.add_argument("--bind-host", default="127.0.0.1",
                    help="address the shared listener binds (default "
                         "loopback; 0.0.0.0 for agents on other hosts, the "
                         "ticket then advertising this host's address)")
    ps.add_argument("--agent-liveness", type=float, default=None,
                    help="seconds of silence after which an agent is "
                         "declared lost (default 10)")
    ps.add_argument("--no-sink", action="store_true",
                    help="no journal sink (<home>/journal/): tenants with "
                         "config.sink journal locally, agents keep their "
                         "agent.jsonl (default: the sink is on whenever "
                         "the fleet's telemetry is)")

    pa = sub.add_parser("agent", help="run a fleet agent process")
    pa.add_argument("--ticket",
                    help="path to the fleet's agent_ticket.json (written by "
                         "`start --max-agents`)")
    pa.add_argument("--wait-ticket", type=float, default=30.0,
                    help="seconds to wait for the ticket file to appear")
    pa.add_argument("--fleet-addr",
                    help="fleet control-plane address HOST:PORT (instead of "
                         "--ticket)")
    pa.add_argument("--secret", help="fleet secret (hex)")
    pa.add_argument("--secret-file", help="file containing the fleet secret")
    pa.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where this agent's trials run: cuda (the default; "
                         "the agent refuses to start without a visible card) "
                         "or cpu (every card hidden from the process)")
    pa.add_argument("--chips", type=int, default=1,
                    help="CUDA devices this agent declares (and pins to, "
                         "with --pin)")
    pa.add_argument("--process-index", type=int, default=0,
                    help="this agent's index among the agents on this host "
                         "(selects its devices with --pin)")
    pa.add_argument("--pin", action="store_true",
                    help="pin this process to its disjoint CUDA devices "
                         "(CUDA_VISIBLE_DEVICES) before CUDA starts")
    pa.add_argument("--advertise-host", default="127.0.0.1",
                    help="host other gang members reach this agent on (the "
                         "rendezvous address of a gang it leads)")
    pa.add_argument("--obs-port", type=int, default=None,
                    help="per-agent observability: serve /healthz and "
                         "/metrics on this port (0 = ephemeral; default off)")
    pa.add_argument("--home", help="agent scratch dir (its journal); "
                                   "default: a temp dir")
    pa.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace per trial")
    pa.add_argument("--max-leases", type=int, default=None,
                    help="exit after serving this many leases (default: run "
                         "until AGSTOP)")
    pa.add_argument("--idle-exit", type=float, default=None,
                    help="exit after this many idle seconds with no lease "
                         "(default: run until AGSTOP)")

    pq = sub.add_parser("submit", help="queue a spec into a fleet's spool")
    pq.add_argument("--home", required=True)
    pq.add_argument("spec", help="submission spec JSON file")

    pt = sub.add_parser("status", help="print fleet status + replayed "
                                       "shares")
    pt.add_argument("--home", required=True)

    pk = sub.add_parser("soak", help="run the built-in preemption soak")
    pk.add_argument("--runners", type=int, default=2)
    pk.add_argument("--seed", type=int, default=7)
    pk.add_argument("--agent", action="store_true",
                    help="run the agent-kill soak instead: agent processes "
                         "(--device cpu) serve leases over sockets, one is "
                         "SIGKILLed mid-lease, and invariant 11 (lease "
                         "revoked, trial requeued exactly once) is checked "
                         "from the journals")
    pk.add_argument("--sink", action="store_true",
                    help="run the journal-sink soak instead: the fleet's "
                         "sink is killed mid-soak and restarted; invariant "
                         "12 (degrade to local journals, re-ship on "
                         "reconnect, no lost or duplicate event, no failed "
                         "experiment)")
    pk.add_argument("--slow-tenant", action="store_true",
                    help="run the slow-tenant isolation soak instead: one "
                         "tenant's handlers artificially delayed, other "
                         "tenants' hand-off p95 must stay in bound")

    args = p.parse_args(argv)
    return {"start": _cmd_start, "agent": _cmd_agent,
            "submit": _cmd_submit, "status": _cmd_status,
            "soak": _cmd_soak}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
