"""Static concurrency & protocol conformance analysis for maggy_tpu_torch.

The port's copy of ``maggy_tpu/analysis/``, pointed at the port's own
sources: four checkers over the package's AST plus one runtime harness.

- **guards** — guarded-by inference: which ``self._x`` attributes are
  written under ``with <lock>``, flagging accesses on paths that do not
  hold it. ``# guarded-by:`` / ``# locked-by:`` / ``# unguarded-ok:``
  annotations seed and silence the inference (docs/analysis_torch.md).
- **lockorder** — the static acquired-while-holding graph across modules,
  cycle detection, and the canonical acquisition order (emitted into
  docs/analysis_torch.md). Paired with the runtime **witness**
  (witness.py): an opt-in instrumented lock wrapper, armed by
  ``MAGGY_TPU_TORCH_LOCK_WITNESS=1`` or ``install()``, that records actual
  acquisition edges and fails on any edge the static order forbids.
- **rpcconf** — RPC conformance: every verb in a server's ``_handlers``
  (and every driver ``message_callbacks`` verb) has a producer, and the
  payload keys a handler reads agree with the keys producers send.
- **journalvocab** — journal vocabulary conformance against
  ``telemetry/vocab.py``, in both directions.

The annotations and their syntax are the JAX package's. Where the port's
layout differs, the copy learns the port's:

- ``device_gate``'s gate is a module singleton whose bound methods are the
  module's functions (``step = _GATE.step``; ``capture = quiesce =
  exclusive`` in the class). ``astindex`` resolves a call through a
  package module's name (``device_gate.quiesce()``) to that module's
  function or to the method such an alias names, so ``with
  device_gate.quiesce():`` under a lock is an edge to ``_Gate._cond``.
- The analyzer's own modules are ``maggy_tpu_torch.analysis.*``
  (excluded from the journal-vocabulary scan, as the JAX package excludes
  its own).

Run ``python -m maggy_tpu_torch.analysis`` (exit 0 = no unsuppressed
findings). Pure AST: it imports no code under analysis and no ``torch``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from maggy_tpu_torch.analysis.astindex import PackageIndex, parse_package

#: The four checker names, in report order.
CHECKERS = ("guards", "lockorder", "rpcconf", "journalvocab")


class Finding:
    """One analyzer finding, pointing at a file:line."""

    __slots__ = ("checker", "path", "line", "message", "suppressed", "reason")

    def __init__(self, checker: str, path: str, line: int, message: str,
                 suppressed: bool = False, reason: Optional[str] = None):
        self.checker = checker
        self.path = path
        self.line = int(line)
        self.message = message
        self.suppressed = suppressed
        self.reason = reason

    def to_dict(self) -> Dict[str, Any]:
        return {"checker": self.checker, "path": self.path,
                "line": self.line, "message": self.message,
                "suppressed": self.suppressed, "reason": self.reason}

    def __repr__(self):
        tag = " [suppressed: {}]".format(self.reason) if self.suppressed \
            else ""
        return "{}:{}: [{}] {}{}".format(self.path, self.line, self.checker,
                                         self.message, tag)


def package_root() -> str:
    """Filesystem root of the ``maggy_tpu_torch`` package this module sits
    in (found from this file's path: nothing is imported)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def analyze(index: PackageIndex,
            checkers=CHECKERS) -> Dict[str, List[Finding]]:
    """Run the selected checkers over a parsed index. Returns
    checker -> findings (suppressed ones included, flagged)."""
    from maggy_tpu_torch.analysis import guards, journalvocab, lockorder, rpcconf

    runners = {
        "guards": guards.check,
        "lockorder": lockorder.check,
        "rpcconf": rpcconf.check,
        "journalvocab": journalvocab.check,
    }
    return {name: runners[name](index) for name in checkers
            if name in runners}


def run_analysis(root: Optional[str] = None,
                 checkers=CHECKERS) -> Dict[str, Any]:
    """Parse + analyze the package; returns the full report dict
    (``findings`` = unsuppressed, ``suppressed`` = annotated-away,
    ``summary`` = counts per checker, ``lock_order`` = the canonical
    order for docs/witness consumers)."""
    from maggy_tpu_torch.analysis import lockorder

    root = root or package_root()
    index = parse_package(root)
    results = analyze(index, checkers=checkers)
    findings = [f for fs in results.values() for f in fs if not f.suppressed]
    suppressed = [f for fs in results.values() for f in fs if f.suppressed]
    report: Dict[str, Any] = {
        "root": root,
        "findings": findings,
        "suppressed": suppressed,
        "summary": {name: sum(1 for f in fs if not f.suppressed)
                    for name, fs in results.items()},
        "num_locks": len(index.lock_decls()),
    }
    if "lockorder" in checkers:
        graph = lockorder.build_graph(index)
        report["lock_order"] = lockorder.canonical_order(graph)
        report["lock_edges"] = sorted(
            "{} -> {}".format(a, b) for (a, b) in graph.edges)
    return report


def analyze_paths(paths: List[str],
                  checkers=CHECKERS) -> Dict[str, List[Finding]]:
    """Analyze an explicit file set (fixture tests)."""
    index = parse_package(None, paths=paths)
    return analyze(index, checkers=checkers)


__all__ = ["Finding", "CHECKERS", "analyze", "analyze_paths",
           "run_analysis", "package_root", "parse_package", "PackageIndex"]
