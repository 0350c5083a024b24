"""Telemetry CLI: ``python -m maggy_tpu_torch.telemetry <command>``.

    trace <exp_dir|journal.jsonl|fleet home> [-o OUT]   journal -> Perfetto JSON
    replay <exp_dir|journal.jsonl>                       journal -> derived numbers
    goodput <exp_dir|journal.jsonl|fleet home>           chip-time ledger

The port's copy of ``maggy_tpu/telemetry/__main__.py``. ``trace`` writes
Chrome-trace-event JSON loadable in https://ui.perfetto.dev or
chrome://tracing (one track per partition, trial slices with phase
sub-slices, instant markers for stops and requeues); on a fleet home
directory (one holding ``fleet.jsonl``) it writes the fleet timeline, one
track per fleet runner with a lane per experiment (``fleet_trace.json``).
``replay`` prints the same derived scheduling numbers the driver and the
TELEM verb compute, plus the journal's ``torn_lines`` count. ``goodput``
on a fleet home prints each tenant's leased chip-seconds and its own
ledger. ``trace --unified`` on a fleet home merges ``fleet.jsonl``, the
journal sink's per-source segments (``<home>/journal/``) and the surviving
local journals into one trace (``unified_trace.json``): a process group an
agent, its journal moved onto the fleet's clock by its journaled clock
offset, and ABIND -> execution -> FINAL flow arrows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events, replay_journal
from maggy_tpu_torch.telemetry.goodput import compute_goodput, render_goodput
from maggy_tpu_torch.telemetry.trace import write_trace

FLEET_JOURNAL = "fleet.jsonl"


def _is_fleet_home(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, FLEET_JOURNAL))


def _resolve_journal(path: str) -> str:
    """Accept an experiment dir or a journal file path."""
    if os.path.isdir(path):
        path = os.path.join(path, JOURNAL_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError("no telemetry journal at {}".format(path))
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="maggy_tpu_torch.telemetry",
        description="Offline telemetry tools over a journal artifact.")
    sub = p.add_subparsers(dest="command", required=True)
    pt = sub.add_parser("trace",
                        help="export a Perfetto/Chrome-trace timeline")
    pt.add_argument("path", help="experiment dir or telemetry.jsonl path")
    pt.add_argument("-o", "--out",
                    help="output file (default: <exp_dir>/trace.json)")
    pt.add_argument("--unified", action="store_true",
                    help="fleet home dirs only: merge fleet.jsonl, the journal "
                         "sink's per-source segments (<home>/journal/) and "
                         "the surviving local journals into one trace, with "
                         "a process group an agent, clock-offset-corrected "
                         "timestamps and ABIND->execution->FINAL flow arrows")
    pr = sub.add_parser("replay", help="print journal-derived scheduling "
                                       "numbers as JSON")
    pr.add_argument("path", help="experiment dir or telemetry.jsonl path")
    pg = sub.add_parser("goodput",
                        help="print the chip-time goodput ledger (where "
                             "every held chip-second went)")
    pg.add_argument("path", help="experiment dir or telemetry.jsonl path")
    pg.add_argument("--json", action="store_true",
                    help="emit the full ledger as JSON instead of the "
                         "human summary")
    args = p.parse_args(argv)
    if args.command == "goodput" and _is_fleet_home(args.path):
        return _fleet_goodput(args)
    if args.command == "trace" and _is_fleet_home(args.path):
        return _fleet_trace(args)
    if args.command == "trace" and args.unified:
        raise SystemExit("--unified needs a fleet home dir (a directory containing "
                         "fleet.jsonl)")

    journal = _resolve_journal(args.path)
    if args.command == "replay":
        print(json.dumps(replay_journal(journal), indent=2, default=str))
        return 0
    events = read_events(journal)
    if args.command == "goodput":
        block = compute_goodput(events)
        if args.json:
            print(json.dumps(block, indent=2, default=str))
        else:
            for line in render_goodput(block):
                print(line)
        return 0

    out = args.out or os.path.join(os.path.dirname(journal), "trace.json")
    n = write_trace(events, out)
    torn = getattr(events, "torn_lines", 0)
    msg = ("trace: {} journal events -> {} trace events -> {}"
           .format(len(events), n, out))
    if torn:
        msg += " ({} torn line(s) skipped)".format(torn)
    print(msg)
    print("open in https://ui.perfetto.dev or chrome://tracing")
    return 0


def _fleet_goodput(args) -> int:
    """A fleet home's ledger: the fleet replay's per-tenant roll-up of
    lease-derived chip-seconds and each tenant's own journal fold."""
    from maggy_tpu_torch.fleet.scheduler import replay_fleet_journal

    block = replay_fleet_journal(args.path).get("goodput") or {}
    if args.json:
        print(json.dumps(block, indent=2, default=str))
        return 0
    for tenant, tb in sorted((block.get("tenants") or {}).items()):
        print("tenant {}: {:.1f} leased chip-seconds".format(tenant, tb.get("chip_seconds") or 0.0))
        for line in render_goodput(tb.get("goodput") or {}):
            print("  " + line)
    return 0


def _fleet_trace(args) -> int:
    """The fleet timeline: each experiment's journal is found through the
    fleet journal's events, which carry its exp_dir. With ``--unified``,
    each experiment's stream is the exactly-once merge of its sink segment
    and any surviving local journal, the agents' shipped journals join as
    clock-corrected process groups, and flow arrows cross the process
    boundary."""
    from maggy_tpu_torch.telemetry.trace import (build_fleet_trace, build_unified_trace,
                                                 validate_trace)

    fleet_events = read_events(os.path.join(args.path, FLEET_JOURNAL))
    exp_dirs = {ev["exp"]: ev["exp_dir"] for ev in fleet_events
                if ev.get("exp") and ev.get("exp_dir")}
    unified = args.command == "trace" and args.unified
    sink = {}
    if unified:
        from maggy_tpu_torch.telemetry.sink import (SINK_DIR_NAME, merge_source_events,
                                                    read_sink_dir, sanitize_source)

        sink = read_sink_dir(os.path.join(args.path, SINK_DIR_NAME))
    experiments = {}
    for name, exp_dir in exp_dirs.items():
        jp = os.path.join(exp_dir, JOURNAL_NAME)
        local = read_events(jp) if os.path.exists(jp) else None
        if unified:
            shipped = sink.pop(sanitize_source(name), None)
            if shipped is not None or local is not None:
                experiments[name] = merge_source_events(shipped, local)
        elif local is not None:
            experiments[name] = local
    if unified:
        # Every remaining sink source that names a joined agent is that
        # agent's own journal.
        agent_ids = {str(ev.get("agent")) for ev in fleet_events
                     if ev.get("ev") == "agent" and ev.get("phase") == "join"
                     and ev.get("agent")}
        trace = build_unified_trace(fleet_events, experiments,
                                    agent_journals={src: evs for src, evs in sink.items()
                                                    if src in agent_ids})
        default_out = "unified_trace.json"
    else:
        trace = build_fleet_trace(fleet_events, experiments)
        default_out = "fleet_trace.json"
    n = validate_trace(trace)
    out = args.out or os.path.join(args.path, default_out)
    with open(out, "w") as f:
        json.dump(trace, f)
    print("{} trace: {} fleet events + {} experiment journal(s) -> {} trace events -> "
          "{}".format("unified" if unified else "fleet", len(fleet_events),
                      len(experiments), n, out))
    print("open in https://ui.perfetto.dev or chrome://tracing")
    return 0

if __name__ == "__main__":
    sys.exit(main())
