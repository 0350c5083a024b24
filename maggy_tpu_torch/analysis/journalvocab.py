"""Checker 4: journal vocabulary conformance.

``telemetry/vocab.py`` is the single home of every string the journal
speaks. This checker verifies three directions, all statically:

1. **emit -> vocab**: every literal span phase (``trial_event(tid,
   "phase")``), event kind (``.event("kind", ...)``) and ``reason=``
   kwarg emitted anywhere in the package appears in the vocabulary;
2. **vocab -> emit**: every ``SPAN_PHASES`` / ``EVENT_KINDS`` /
   ``REQUEUE_REASONS`` entry is emitted by at least one call site (no
   orphan vocabulary — an entry nothing emits is a dead consumer match);
3. **consume -> vocab**: every literal a consumer matches against a
   journal field (``ev.get("phase") == "..."``, membership in a
   ``*_PHASES`` constant, aliases of such fields) appears in the
   vocabulary — a consumer typo matches nothing, silently.

``# vocab-ok: <reason>`` on the emit/consume line suppresses.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from maggy_tpu_torch.analysis.astindex import ModuleInfo, PackageIndex

#: Journal fields whose compared literals belong to a vocab family.
#: ``kind`` is the CHAOS fault kind (the ``ev`` field carries the event
#: kind; consumers holding ``ev.get("ev")`` in a variable are tracked by
#: alias, whatever the variable is called). Built with ``dict()``, not a
#: literal: a ``{"ev": ...}`` literal reads as a journal record to the JAX
#: package's analyzer, which excludes only its own modules when pointed at
#: this tree.
_FIELD_FAMILY = dict(phase="phase", ev="kind", reason="reason",
                     kind="chaos_kind",
                     status="health_status", check="health_check")

#: Module-level constant-name suffix -> family (consumer tables like
#: trace._INSTANT_PHASES, harness._REQUEUE_KINDS).
_CONST_FAMILY = (("PHASES", "phase"), ("REASONS", "reason"),
                 ("KINDS", "chaos_kind"), ("CHECKS", "health_check"),
                 ("STATUSES", "health_status"))

#: Emitter call method names.
_EMIT_EVENT = ("event", "_event")


class Vocab:
    def __init__(self):
        self.sets: Dict[str, Set[str]] = {}
        self.mod: Optional[ModuleInfo] = None
        self.lines: Dict[str, int] = {}  # entry -> decl line (span/kind)

    def family(self, name: str) -> Set[str]:
        if name == "phase":
            return (self.sets.get("ALL_PHASES") or
                    set().union(*[v for k, v in self.sets.items()
                                  if k.endswith("PHASES")] or [set()]))
        if name == "kind":
            return self.sets.get("EVENT_KINDS", set())
        if name == "reason":
            return (self.sets.get("ALL_REASONS") or
                    set().union(*[v for k, v in self.sets.items()
                                  if k.endswith("REASONS")] or [set()]))
        if name == "health_status":
            return self.sets.get("HEALTH_STATUSES", set())
        if name == "health_check":
            return self.sets.get("HEALTH_CHECKS", set())
        if name == "chaos_kind":
            return self.sets.get("CHAOS_KINDS", set())
        return set()


def _load_vocab(index: PackageIndex) -> Optional[Vocab]:
    for mod in index.modules.values():
        names = {}
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                lits = _literal_set(node.value)
                if lits is not None:
                    names[node.targets[0].id] = (lits, node.lineno)
        if "SPAN_PHASES" in names and "EVENT_KINDS" in names:
            vocab = Vocab()
            vocab.mod = mod
            for k, (lits, line) in names.items():
                vocab.sets[k] = lits
                for entry in lits:
                    vocab.lines.setdefault(entry, line)
            # Synthesize the unions when vocab.py computes them (the
            # computed ALL_PHASES is a BinOp, not a literal).
            if "ALL_PHASES" not in vocab.sets:
                vocab.sets["ALL_PHASES"] = set().union(
                    *[v for k, v in vocab.sets.items()
                      if k.endswith("PHASES")] or [set()])
            if "ALL_REASONS" not in vocab.sets:
                vocab.sets["ALL_REASONS"] = set().union(
                    *[v for k, v in vocab.sets.items()
                      if k.endswith("REASONS")] or [set()])
            return vocab
    return None


def _literal_set(node) -> Optional[Set[str]]:
    """Flat tuple/set/frozenset/list of string constants -> set."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("frozenset", "set") and node.args:
        return _literal_set(node.args[0])
    if isinstance(node, (ast.Tuple, ast.Set, ast.List)):
        out = set()
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.add(el.value)
            else:
                return None
        return out
    return None


# ------------------------------------------------------------------ emitters


def _collect_emits(index: PackageIndex, vocab_mod
                   ) -> List[Tuple[str, str, ModuleInfo, int]]:
    """(family, literal, module, line) for every literal emit site."""
    out = []
    for mod in index.modules.values():
        if mod is vocab_mod or _is_meta(mod):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = node.func.attr if isinstance(node.func, ast.Attribute) \
                else (node.func.id if isinstance(node.func, ast.Name)
                      else None)
            if name == "trial_event":
                if len(node.args) >= 2 and _is_str(node.args[1]):
                    out.append(("phase", node.args[1].value, mod,
                                node.lineno))
                for kw in node.keywords:
                    if kw.arg == "reason" and _is_str(kw.value):
                        out.append(("reason", kw.value.value, mod,
                                    node.lineno))
            elif name in _EMIT_EVENT:
                if node.args and _is_str(node.args[0]):
                    out.append(("kind", node.args[0].value, mod,
                                node.lineno))
                    kind = node.args[0].value
                    for kw in node.keywords:
                        if kw.arg == "phase" and _is_str(kw.value):
                            out.append(("phase", kw.value.value, mod,
                                        node.lineno))
                        elif kw.arg == "reason" and _is_str(kw.value):
                            out.append(("reason", kw.value.value, mod,
                                        node.lineno))
                        elif kind == "health" and kw.arg == "status" \
                                and _is_str(kw.value):
                            out.append(("health_status", kw.value.value,
                                        mod, node.lineno))
                        elif kind == "health" and kw.arg == "check" \
                                and _is_str(kw.value):
                            out.append(("health_check", kw.value.value,
                                        mod, node.lineno))
            elif name == "mark":
                # SpanTracker.mark(trial, "phase") — the facade's inner
                # edge; literal phases here are emits too.
                if len(node.args) >= 2 and _is_str(node.args[1]):
                    out.append(("phase", node.args[1].value, mod,
                                node.lineno))
        # Raw journal records: dict literals carrying an "ev" key (the
        # Telemetry facade's internal _record paths).
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if k is not None and _is_str(k) and k.value == "ev" \
                        and _is_str(v):
                    out.append(("kind", v.value, mod, node.lineno))
                elif k is not None and _is_str(k) and k.value == "phase" \
                        and _is_str(v) and any(
                            kk is not None and _is_str(kk)
                            and kk.value == "ev"
                            for kk in node.keys):
                    out.append(("phase", v.value, mod, node.lineno))
    return out


def _is_str(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _is_meta(mod: ModuleInfo) -> bool:
    """The analyzer's own modules hold field-name/vocabulary PATTERN
    tables (e.g. ``_FIELD_FAMILY``), not emit/consume sites — linting
    them against the vocabulary is self-referential noise."""
    return mod.modname.startswith("maggy_tpu_torch.analysis")


# ----------------------------------------------------------------- consumers


class _ConsumerVisitor(ast.NodeVisitor):
    """Collects literals compared against journal fields within one
    function: direct ``x.get("phase") == "lit"`` / ``x["phase"] ==``,
    membership tests, and single-hop aliases (``phase = ev.get("phase")``,
    tuple unpack included)."""

    def __init__(self, mod: ModuleInfo, sink: List):
        self.mod = mod
        self.sink = sink
        self.aliases: Dict[str, str] = {}  # var -> family

    def _field_of(self, node) -> Optional[str]:
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and node.args and \
                _is_str(node.args[0]):
            return _FIELD_FAMILY.get(node.args[0].value)
        if isinstance(node, ast.Subscript) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str):
            return _FIELD_FAMILY.get(node.slice.value)
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id)
        return None

    def visit_Assign(self, node):
        tgts = node.targets
        if len(tgts) == 1 and isinstance(tgts[0], ast.Tuple) and \
                isinstance(node.value, ast.Tuple) and \
                len(tgts[0].elts) == len(node.value.elts):
            pairs = zip(tgts[0].elts, node.value.elts)
        else:
            pairs = [(t, node.value) for t in tgts]
        for tgt, val in pairs:
            if isinstance(tgt, ast.Name):
                fam = self._field_of(val)
                if fam is not None:
                    self.aliases[tgt.id] = fam
        self.generic_visit(node)

    def visit_Compare(self, node):
        sides = [node.left] + list(node.comparators)
        fams = [self._field_of(s) for s in sides]
        fam = next((f for f in fams if f), None)
        if fam is not None:
            for s, op in zip(sides[1:], node.ops):
                if isinstance(op, (ast.Eq, ast.NotEq)) and _is_str(s):
                    self.sink.append((fam, s.value, self.mod, s.lineno))
                elif isinstance(op, (ast.In, ast.NotIn)) and \
                        isinstance(s, (ast.Tuple, ast.Set, ast.List)):
                    for el in s.elts:
                        if _is_str(el):
                            self.sink.append((fam, el.value, self.mod,
                                              el.lineno))
            if _is_str(sides[0]) and any(
                    isinstance(op, (ast.In, ast.NotIn))
                    for op in node.ops):
                pass  # "lit" in field-valued container: not a vocab use
        self.generic_visit(node)


def _collect_consumes(index: PackageIndex, vocab_mod
                      ) -> List[Tuple[str, str, ModuleInfo, int]]:
    out: List[Tuple[str, str, ModuleInfo, int]] = []
    for mod in index.modules.values():
        if mod is vocab_mod or _is_meta(mod):
            continue
        # Functions (module + methods): fresh alias scope each.
        funcs = [n for n in ast.walk(mod.tree)
                 if isinstance(n, ast.FunctionDef)]
        for fn in funcs:
            v = _ConsumerVisitor(mod, out)
            for stmt in fn.body:
                v.visit(stmt)
        # Module-level vocabulary tables (trace._INSTANT_PHASES etc.).
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                cname = node.targets[0].id
                for suffix, fam in _CONST_FAMILY:
                    if cname.endswith(suffix):
                        lits = _literal_set(node.value)
                        if lits:
                            out.extend((fam, lit, mod, node.lineno)
                                       for lit in sorted(lits))
                        break
    return out


# -------------------------------------------------------------------- check


def check(index: PackageIndex) -> List["Finding"]:
    from maggy_tpu_torch.analysis import Finding

    findings: List[Finding] = []
    vocab = _load_vocab(index)
    if vocab is None:
        # No vocabulary in scope (fixture sets without one): nothing to
        # conform to — report that loudly for the package run, quietly
        # skip for single-file fixtures that have no emitters either.
        emits_exist = any(_collect_emits(index, None))
        if emits_exist:
            any_mod = next(iter(index.modules.values()))
            findings.append(Finding(
                "journalvocab", any_mod.path, 1,
                "no vocabulary module found (SPAN_PHASES/EVENT_KINDS) "
                "but telemetry emit sites exist"))
        return findings

    def emit_finding(mod: ModuleInfo, line: int, msg: str) -> None:
        ann = mod.annotation_near(line, "vocab-ok", back=2)
        if ann is not None and not ann.value:
            findings.append(Finding(
                "journalvocab", mod.path, line,
                "vocab-ok suppression without a reason"))
            return
        findings.append(Finding(
            "journalvocab", mod.path, line, msg,
            suppressed=ann is not None,
            reason=ann.value if ann is not None else None))

    emits = _collect_emits(index, vocab.mod)
    emitted_by_family: Dict[str, Set[str]] = {}
    for fam, lit, mod, line in emits:
        emitted_by_family.setdefault(fam, set()).add(lit)
        if lit not in vocab.family(fam):
            emit_finding(mod, line,
                         "emitted {} {!r} is not in the journal "
                         "vocabulary (telemetry/vocab.py)".format(fam, lit))

    # Orphan vocabulary: core families must be emitted somewhere.
    for set_name, fam in (("SPAN_PHASES", "phase"),
                          ("EVENT_KINDS", "kind"),
                          ("REQUEUE_REASONS", "reason")):
        for entry in sorted(vocab.sets.get(set_name, set())):
            if entry not in emitted_by_family.get(fam, set()):
                emit_finding(vocab.mod, vocab.lines.get(entry, 1),
                             "vocabulary entry {!r} ({}) is never emitted "
                             "by any call site".format(entry, set_name))

    for fam, lit, mod, line in _collect_consumes(index, vocab.mod):
        if lit not in vocab.family(fam):
            emit_finding(mod, line,
                         "consumer matches {} {!r} which is not in the "
                         "journal vocabulary — the match can never "
                         "fire".format(fam, lit))
    return findings
