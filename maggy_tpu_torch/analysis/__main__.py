"""``python -m maggy_tpu_torch.analysis`` — run the concurrency & protocol
conformance checkers over the port package.

    python -m maggy_tpu_torch.analysis                 # exit 0 = clean
    python -m maggy_tpu_torch.analysis --json          # machine-readable report
    python -m maggy_tpu_torch.analysis --write-docs    # refresh docs/analysis_torch.md
    python -m maggy_tpu_torch.analysis --checkers guards,lockorder

Exit codes: 0 = no unsuppressed findings; 1 = findings (each printed as
``path:line: [checker] message``); suppressed findings are listed with
their written reasons under ``--verbose`` so deliberate exceptions stay
auditable.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from maggy_tpu_torch.analysis import CHECKERS, package_root, run_analysis

#: The port's analysis doc (never the JAX package's docs/analysis.md).
DEFAULT_DOCS = os.path.join(os.path.dirname(package_root()), "docs",
                            "analysis_torch.md")

#: Markers bounding the generated lock-order section in the docs file.
DOCS_BEGIN = "<!-- BEGIN GENERATED LOCK ORDER (python -m maggy_tpu_torch.analysis --write-docs) -->"
DOCS_END = "<!-- END GENERATED LOCK ORDER -->"


def render_lock_order(report) -> str:
    lines = ["", "The canonical acquisition order (acquire earlier-listed "
                 "locks first; generated from the static "
                 "acquired-while-holding graph):", ""]
    for i, name in enumerate(report.get("lock_order", []), 1):
        lines.append("{:2d}. `{}`".format(i, name))
    lines += ["", "Observed acquired-while-holding edges:", ""]
    for edge in report.get("lock_edges", []):
        lines.append("- `{}`".format(edge))
    lines.append("")
    return "\n".join(lines)


def write_docs(report, docs_path: str) -> bool:
    with open(docs_path, "r") as f:
        text = f.read()
    if DOCS_BEGIN not in text or DOCS_END not in text:
        return False
    head, rest = text.split(DOCS_BEGIN, 1)
    _, tail = rest.split(DOCS_END, 1)
    new = head + DOCS_BEGIN + "\n" + render_lock_order(report) \
        + DOCS_END + tail
    if new != text:
        with open(docs_path, "w") as f:
            f.write(new)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maggy_tpu_torch.analysis",
        description="Static concurrency & protocol conformance analysis.")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("--verbose", action="store_true",
                    help="also list suppressed findings with their reasons")
    ap.add_argument("--checkers", default=",".join(CHECKERS),
                    help="comma-separated subset of: " + ", ".join(CHECKERS))
    ap.add_argument("--root", default=None,
                    help="package root to analyze (default: installed "
                         "maggy_tpu_torch)")
    ap.add_argument("--write-docs", metavar="DOCS_MD", nargs="?",
                    const=DEFAULT_DOCS, default=None,
                    help="refresh the generated lock-order section of "
                         "docs/analysis_torch.md (default path when flag "
                         "given bare)")
    args = ap.parse_args(argv)

    checkers = tuple(c.strip() for c in args.checkers.split(",") if c)
    unknown = [c for c in checkers if c not in CHECKERS]
    if unknown:
        ap.error("unknown checker(s): {}".format(", ".join(unknown)))
    report = run_analysis(root=args.root, checkers=checkers)

    if args.write_docs is not None:
        path = args.write_docs
        if not os.path.exists(path):
            print("docs file not found: {}".format(path), file=sys.stderr)
            return 2
        if not write_docs(report, path):
            print("docs file has no generated-section markers",
                  file=sys.stderr)
            return 2

    if args.json:
        out = dict(report)
        out["findings"] = [f.to_dict() for f in report["findings"]]
        out["suppressed"] = [f.to_dict() for f in report["suppressed"]]
        print(json.dumps(out, indent=2))
    else:
        for f in report["findings"]:
            print(repr(f))
        if args.verbose:
            for f in report["suppressed"]:
                print(repr(f))
        counts = ", ".join("{}: {}".format(k, v)
                           for k, v in sorted(report["summary"].items()))
        print("maggy_tpu_torch.analysis: {} finding(s) ({}); {} suppressed with "
              "reasons; {} locks, {} order edges".format(
                  len(report["findings"]), counts,
                  len(report["suppressed"]), report.get("num_locks", 0),
                  len(report.get("lock_edges", []))))
    return 1 if report["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
