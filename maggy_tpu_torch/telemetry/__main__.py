"""Telemetry CLI: ``python -m maggy_tpu_torch.telemetry <command>``.

    trace <exp_dir|journal.jsonl> [-o OUT]   journal -> Perfetto JSON
    replay <exp_dir|journal.jsonl>           journal -> derived numbers
    goodput <exp_dir|journal.jsonl>          chip-time ledger

The port's copy of ``maggy_tpu/telemetry/__main__.py`` for experiment
journals. ``trace`` writes Chrome-trace-event JSON loadable in
https://ui.perfetto.dev or chrome://tracing (one track per partition, trial
slices with phase sub-slices, instant markers for stops and requeues).
``replay`` prints the same derived scheduling numbers the driver and the
TELEM verb compute, plus the journal's ``torn_lines`` count. A fleet home
directory and ``trace --unified`` are not ported yet (ROADMAP queue 1
item 9).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events, replay_journal
from maggy_tpu_torch.telemetry.goodput import compute_goodput, render_goodput
from maggy_tpu_torch.telemetry.trace import write_trace

_FLEET = "fleet home directories are not ported yet (ROADMAP queue 1 item 9)"


def _resolve_journal(path: str) -> str:
    """Accept an experiment dir or a journal file path."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "fleet.jsonl")):
            raise SystemExit(_FLEET)
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
                    help="fleet home dirs only; not ported yet")
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
    if getattr(args, "unified", False):
        raise SystemExit("--unified: " + _FLEET)

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


if __name__ == "__main__":
    sys.exit(main())
