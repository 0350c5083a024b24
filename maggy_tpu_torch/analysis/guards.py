"""Checker 1: guarded-by inference.

For every class that owns ``threading`` locks, decide which instance
attributes those locks guard, then flag accesses on code paths that do
not hold the guard:

- **Annotated attributes** (``# guarded-by: <lock>`` on the attribute's
  ``__init__`` assignment): strict — every read AND write outside
  ``__init__`` must hold the lock, unless the line carries
  ``# unguarded-ok: <reason>``.
- **Inferred attributes** (no annotation): an attribute written at least
  twice under one common lock (outside ``__init__``) is presumed guarded
  by it; any lock-free WRITE is flagged (reads are too often benignly
  racy to infer on — annotate to get read checking).

``# locked-by: <lock>`` on a method declares a caller-holds-the-lock
contract (the held set starts with that lock). A ``# guarded-by:`` on the
``class`` line documents external synchronization (e.g. fleet
``ExperimentEntry`` guarded by the scheduler's lock) and exempts the
whole class. Accesses made by package-local subclasses count toward the
defining class's attributes, so an inherited structure cannot dodge its
guard by being touched from a child class.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from maggy_tpu_torch.analysis.astindex import Access, ClassInfo, PackageIndex

#: Attribute write threshold for inferring a guard without annotation.
MIN_LOCKED_WRITES = 2


def _canon_lock(cls: ClassInfo, value: str) -> Optional[str]:
    """'_store_lock' -> 'Cls._store_lock' (following Condition aliases);
    'Owner.attr' passes through; unknown -> None."""
    if "." in value:
        return value
    decl = cls.locks.get(value)
    if decl is None:
        return None
    if decl.alias_of and decl.alias_of in cls.locks:
        return "{}.{}".format(cls.name, decl.alias_of)
    return "{}.{}".format(cls.name, value)


def _subclasses(index: PackageIndex, cls: ClassInfo) -> List[ClassInfo]:
    out, frontier = [], {cls.name}
    changed = True
    while changed:
        changed = False
        for cands in index.classes.values():
            for c in cands:
                if c in out or c is cls:
                    continue
                if any(b in frontier for b in c.bases if b):
                    out.append(c)
                    frontier.add(c.name)
                    changed = True
    return out


def _gather_accesses(index: PackageIndex,
                     cls: ClassInfo) -> List[Tuple[ClassInfo, Access]]:
    pairs = [(cls, a) for a in cls.accesses]
    for sub in _subclasses(index, cls):
        # A subclass that re-declares the attribute in its own __init__
        # owns it separately (e.g. both servers define self.driver).
        pairs.extend((sub, a) for a in sub.accesses
                     if a.attr not in sub.attr_decl_lines)
    return pairs


def check(index: PackageIndex) -> List["Finding"]:
    from maggy_tpu_torch.analysis import Finding

    findings: List[Finding] = []
    for mod in index.modules.values():
        for cls in mod.classes.values():
            if not cls.locks and not cls.guard_annotations:
                continue
            if cls.external_guard is not None:
                continue
            findings.extend(_check_class(index, cls))
    return findings


def _check_class(index: PackageIndex, cls: ClassInfo) -> List["Finding"]:
    from maggy_tpu_torch.analysis import Finding

    mod = cls.module
    findings: List[Finding] = []
    pairs = _gather_accesses(index, cls)
    by_attr: Dict[str, List[Tuple[ClassInfo, Access]]] = {}
    for owner, acc in pairs:
        if acc.attr in cls.locks or acc.attr in cls.methods:
            continue
        by_attr.setdefault(acc.attr, []).append((owner, acc))

    def emit(owner: ClassInfo, acc: Access, msg: str) -> None:
        # On the access line or a comment just above it.
        ann = owner.module.annotation_near(acc.line, "unguarded-ok", back=2)
        if ann is not None and not ann.value:
            findings.append(Finding(
                "guards", owner.module.path, acc.line,
                "unguarded-ok suppression without a reason "
                "({}.{})".format(cls.name, acc.attr)))
            return
        findings.append(Finding(
            "guards", owner.module.path, acc.line, msg,
            suppressed=ann is not None,
            reason=ann.value if ann is not None else None))

    for attr, accs in sorted(by_attr.items()):
        if attr in cls.exempt_attrs:
            continue
        annotated = cls.guard_annotations.get(attr)
        if annotated is not None:
            lock = _canon_lock(cls, annotated[0])
            if lock is None:
                findings.append(Finding(
                    "guards", mod.path, annotated[1],
                    "guarded-by names unknown lock {!r} for {}.{}".format(
                        annotated[0], cls.name, attr)))
                continue
            for owner, acc in accs:
                if acc.in_init or lock in acc.held:
                    continue
                emit(owner, acc,
                     "{} of {}.{} without holding {} "
                     "(guarded-by annotation)".format(
                         acc.kind, cls.name, attr, lock))
            continue
        # Inference: all non-init locked writes share a common lock?
        writes = [(o, a) for o, a in accs
                  if a.kind == "write" and not a.in_init]
        locked = [(o, a) for o, a in writes if a.held]
        if len(locked) < MIN_LOCKED_WRITES:
            continue
        common = frozenset.intersection(*[a.held for _, a in locked])
        if not common:
            continue
        lock = sorted(common)[0]
        for owner, acc in writes:
            if acc.held:
                continue
            emit(owner, acc,
                 "write of {}.{} without holding {} ({} of {} writes "
                 "hold it — inferred guard; annotate guarded-by/"
                 "unguarded-ok to settle)".format(
                     cls.name, attr, lock, len(locked), len(writes)))
    return findings
