"""Checker 2 (static half): the acquired-while-holding graph.

Every lock acquisition that happens while another lock is held adds the
edge ``held -> acquired``; edges also cross method calls (a bounded
fixpoint computes each function's may-acquire set, so ``with A: self.m()``
where ``m`` takes B yields A -> B). Cycles in the graph are the static
deadlock signal; the acyclic graph's topological order is the package's
canonical lock order, emitted into docs/analysis_torch.md and consumed by the
runtime witness (witness.py) as its forbidden-edge oracle.

``# lock-order-ok: <reason>`` on the inner acquisition (or the call that
reaches it) suppresses that site's edges from cycle checking — for edges
proven unreachable-together at runtime. Lock names are canonical
``Owner.attr``; acquisitions that cannot be attributed statically
(``?.attr``) are excluded from the graph rather than guessed.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from maggy_tpu_torch.analysis.astindex import PackageIndex

#: Call-graph fixpoint depth bound (defensive; the graph converges fast).
MAX_ROUNDS = 20


class LockGraph:
    def __init__(self):
        # (held, acquired) -> list of "path:line [via func]" example sites.
        self.edges: Dict[Tuple[str, str], List[str]] = {}
        self.suppressed: Dict[Tuple[str, str], str] = {}
        self.nodes: Set[str] = set()

    def add(self, held: str, acquired: str, site: str,
            suppressed_reason=None) -> None:
        if held == acquired or held.startswith("?.") \
                or acquired.startswith("?."):
            return
        key = (held, acquired)
        self.edges.setdefault(key, [])
        if len(self.edges[key]) < 4:
            self.edges[key].append(site)
        if suppressed_reason is not None:
            self.suppressed.setdefault(key, suppressed_reason)
        self.nodes.update(key)

    def active_edges(self) -> List[Tuple[str, str]]:
        return [e for e in self.edges if e not in self.suppressed]


def _resolve_callee(index: PackageIndex, call) -> str:
    """Qualname of the call's target: a package module's function or alias
    when the call names one (``device_gate.quiesce()``), then the
    same-class method (the caller is ``Class.method``), else the
    package-wide unique definition."""
    if call.target is not None:
        target = index.resolve_alias(call.target)
        if target in index.functions:
            return target
    owner = call.func.split(".")[0]
    cls = index.class_info(owner)
    if cls is not None:
        mro = index.mro_methods(cls)
        if call.callee in mro:
            # The defining class may be a base; find it for the qualname.
            for cand_name in [owner] + cls.bases:
                cand = index.class_info(cand_name) if cand_name else None
                if cand is not None and call.callee in cand.methods:
                    return "{}.{}".format(cand.name, call.callee)
            return "{}.{}".format(owner, call.callee)
        alias = index.resolve_alias("{}.{}".format(owner, call.callee))
        if alias in index.functions:
            return alias
    return index.resolve_method(call.callee) or ""


def _resolve_callees(index: PackageIndex, call) -> List[str]:
    """``_resolve_callee``'s target, or, for a method name that only one
    class hierarchy defines, each of its definitions (a call through an
    interface may reach any override)."""
    callee = _resolve_callee(index, call)
    return [callee] if callee else index.method_family(call.callee)


def build_graph(index: PackageIndex) -> LockGraph:
    graph = LockGraph()
    for decl in index.lock_decls():
        if decl.alias_of is None:
            graph.nodes.add(decl.name)

    def site_of(func: str, line: int) -> str:
        mod = index.func_module.get(func)
        path = mod.path if mod is not None else "?"
        return "{}:{} [{}]".format(path, line, func)

    def suppression(func: str, line: int):
        mod = index.func_module.get(func)
        if mod is None:
            return None
        # On the acquisition line or a comment just above it.
        ann = mod.annotation_near(line, "lock-order-ok", back=2)
        return ann.value if ann is not None else None

    # Direct lexical edges.
    direct: Dict[str, Set[str]] = {}
    for acq in index.acquisitions:
        direct.setdefault(acq.func, set()).add(acq.lock)
        for held in acq.held:
            graph.add(held, acq.lock, site_of(acq.func, acq.line),
                      suppressed_reason=suppression(acq.func, acq.line))

    # may-acquire fixpoint over the (name-resolved) call graph.
    calls_of: Dict[str, Set[str]] = {}
    for call in index.calls:
        for callee in _resolve_callees(index, call):
            if callee in index.functions:
                calls_of.setdefault(call.func, set()).add(callee)
    may: Dict[str, Set[str]] = {f: set(direct.get(f, ()))
                                for f in index.functions}
    for _ in range(MAX_ROUNDS):
        changed = False
        for f, callees in calls_of.items():
            acc = may.setdefault(f, set())
            before = len(acc)
            for g in callees:
                acc |= may.get(g, set())
            changed |= len(acc) != before
        if not changed:
            break

    # Call-crossing edges: holding H while calling g that may acquire L.
    for call in index.calls:
        if not call.held:
            continue
        for callee in _resolve_callees(index, call):
            for lock in sorted(may.get(callee, ())):
                for held in call.held:
                    graph.add(held, lock,
                              site_of(call.func, call.line) + " -> " + callee,
                              suppressed_reason=suppression(call.func,
                                                            call.line))
    return graph


def _cycles(edges: List[Tuple[str, str]]) -> List[List[str]]:
    """Strongly connected components with >1 node (Tarjan, iterative)."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    idx: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v0):
        work = [(v0, iter(adj[v0]))]
        idx[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on.add(v0)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in idx:
                    idx[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(adj[w])))
                    advanced = True
                    break
                if w in on:
                    low[v] = min(low[v], idx[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == idx[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for v in sorted(adj):
        if v not in idx:
            strongconnect(v)
    return sccs


def canonical_order(graph: LockGraph) -> List[str]:
    """Deterministic topological order over ALL known locks (isolated
    locks included, ordered by name after their constrained peers' tiers).
    Cycles are broken by name so the order is always total — the cycle
    itself is reported separately."""
    edges = graph.active_edges()
    indeg: Dict[str, int] = {n: 0 for n in graph.nodes}
    adj: Dict[str, Set[str]] = {n: set() for n in graph.nodes}
    for a, b in edges:
        if b not in adj[a]:
            adj[a].add(b)
            indeg[b] += 1
    order: List[str] = []
    ready = sorted(n for n, d in indeg.items() if d == 0)
    while ready:
        n = ready.pop(0)
        order.append(n)
        for m in sorted(adj[n]):
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
        ready.sort()
    for n in sorted(graph.nodes):
        if n not in order:  # cycle member — break by name
            order.append(n)
    return order


def check(index: PackageIndex) -> List["Finding"]:
    from maggy_tpu_torch.analysis import Finding

    graph = build_graph(index)
    findings: List[Finding] = []
    for key, reason in sorted(graph.suppressed.items()):
        if not reason:
            findings.append(Finding(
                "lockorder", graph.edges[key][0].split(":")[0], 0,
                "lock-order-ok suppression without a reason on edge "
                "{} -> {}".format(*key)))
    for comp in _cycles(graph.active_edges()):
        sites = []
        for a, b in graph.edges:
            if a in comp and b in comp:
                sites.append("{} -> {} at {}".format(
                    a, b, graph.edges[(a, b)][0]))
        path, line = "?", 0
        if sites:
            loc = sites[0].rsplit(" at ", 1)[1]
            path = loc.split(":")[0]
            try:
                line = int(loc.split(":")[1].split(" ")[0])
            except (IndexError, ValueError):
                line = 0
        findings.append(Finding(
            "lockorder", path, line,
            "lock-order cycle among {{{}}}: {}".format(
                ", ".join(comp), "; ".join(sorted(sites)))))
    return findings
