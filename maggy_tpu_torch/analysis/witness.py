"""Checker 2 (runtime half): the lock-order witness.

The port's copy of ``maggy_tpu/analysis/witness.py``. The static lock-order
graph (lockorder.py) sees every *possible* acquired-while-holding edge;
the witness sees the edges that *actually happen*. Installed, it
interposes on ``threading.Lock`` / ``RLock`` construction (and so on
``Condition()``, whose default lock is an ``RLock``): locks allocated from
a ``maggy_tpu_torch`` source line are wrapped (the allocation site
resolves to its static declaration through ``PackageIndex.decl_by_site``,
so the runtime lock carries the same canonical ``Owner.attr`` name the
static graph uses); locks allocated anywhere else pass through untouched,
so torch and stdlib internals pay nothing.

Every acquisition of a wrapped lock while another wrapped lock is held
records the edge ``held -> acquired``; an edge the static canonical
order forbids (the holder sorts *after* the acquiree) is a **violation**
— the dynamic face of a lock-order cycle, caught the first time the two
locks actually interleave rather than the first time they deadlock.

Opt-in: set ``MAGGY_TPU_TORCH_LOCK_WITNESS=1`` (or call :func:`install`
directly) *before* the objects under test build their locks — locks made
at module import (``device_gate``'s gate, ``profiling._CAPTURE_LOCK``)
predate installation and stay unwrapped (docs/analysis_torch.md). The
chaos soaks (``chaos/harness.py``, ``chaos/driver_soak.py``'s children)
and the fleet's agent, sink and slow-tenant soaks install it, so every
invariant run doubles as a dynamic race check.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: Env var arming the witness.
ENV_VAR = "MAGGY_TPU_TORCH_LOCK_WITNESS"

#: The real factories, bound at import so install/uninstall can't lose
#: them however many times they run.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition


def enabled_by_env() -> bool:
    return os.environ.get(ENV_VAR, "").lower() in ("1", "true", "yes", "on")


class Violation:
    """One forbidden acquisition edge: ``held`` sorts after ``acquired``
    in the canonical order, yet a thread acquired ``acquired`` while
    holding ``held``."""

    __slots__ = ("held", "acquired", "site", "thread")

    def __init__(self, held: str, acquired: str, site: str, thread: str):
        self.held = held
        self.acquired = acquired
        self.site = site
        self.thread = thread

    def __repr__(self):
        return ("lock-order violation: acquired {} while holding {} "
                "(canonical order says {} first) at {} [{}]".format(
                    self.acquired, self.held, self.acquired, self.site,
                    self.thread))


class Witness:
    """Per-process edge recorder + forbidden-edge checker."""

    def __init__(self, order: List[str]):
        #: canonical name -> position; edges between named locks are
        #: checked, edges involving site-named (``rel/path.py:NN``) locks
        #: are recorded but can't be forbidden (the static graph excludes
        #: them from ordering too).
        self.positions: Dict[str, int] = {n: i for i, n in enumerate(order)}
        self._mu = _REAL_LOCK()  # real lock: guards edges/violations
        self.edges: Dict[Tuple[str, str], str] = {}  # edge -> example site
        self.violations: List[Violation] = []
        self._tls = threading.local()
        #: Acquisitions noted and the seconds spent noting them (the
        #: witness's own bookkeeping; the wrapper's call overhead is not
        #: in it).
        self.acquisitions = 0
        self.busy_s = 0.0

    # -- per-thread held stack -------------------------------------------

    def _held(self) -> List[Tuple[int, str]]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def note_acquire(self, lock_id: int, name: str) -> None:
        t0 = time.perf_counter()
        stack = self._held()
        site = self._call_site()
        thread = threading.current_thread().name
        with self._mu:
            self.acquisitions += 1
            for _, held_name in stack:
                if held_name == name:
                    continue  # two instances of one decl: unordered
                edge = (held_name, name)
                if edge not in self.edges:
                    self.edges[edge] = site
                # Checked per OCCURRENCE, not per first-seen edge: the
                # env-armed witness is shared across soaks, and a soak
                # counts only violations recorded after its own install
                # point — dedup here would hide a repeat offense from
                # every soak but the first.
                ph = self.positions.get(held_name)
                pa = self.positions.get(name)
                if ph is not None and pa is not None and ph > pa:
                    self.violations.append(
                        Violation(held_name, name, site, thread))
            self.busy_s += time.perf_counter() - t0
        stack.append((lock_id, name))

    def note_release(self, lock_id: int) -> None:
        stack = self._held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == lock_id:
                del stack[i]
                return

    @staticmethod
    def _call_site() -> str:
        # First frame outside this module and threading: the acquire site.
        f = sys._getframe(2)
        skip = (__file__, threading.__file__)
        while f is not None and f.f_code.co_filename in skip:
            f = f.f_back
        if f is None:
            return "?"
        return "{}:{}".format(f.f_code.co_filename, f.f_lineno)

    # -- reporting --------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        with self._mu:
            return {
                "edges": sorted("{} -> {}".format(a, b)
                                for (a, b) in self.edges),
                "edge_count": len(self.edges),
                "violations": [repr(v) for v in self.violations],
                "acquisitions": self.acquisitions,
                "busy_s": self.busy_s,
            }

    def check(self) -> None:
        """Raise if any forbidden edge was observed."""
        with self._mu:
            if self.violations:
                raise AssertionError(
                    "lock-order witness: {} forbidden edge(s):\n{}".format(
                        len(self.violations),
                        "\n".join(repr(v) for v in self.violations)))


class _WitnessLock:
    """Wraps one real Lock/RLock, reporting acquisitions to the witness.

    Implements the full Condition-backing protocol (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``) so ``threading.Condition(
    wrapped_rlock)`` — the fleet scheduler's wake condition — keeps its
    reentrancy semantics through the wrapper.
    """

    __slots__ = ("_inner", "_name", "_witness", "_reentrant", "_tls")

    def __init__(self, inner, name: str, witness: Witness, reentrant: bool):
        self._inner = inner
        self._name = name
        self._witness = witness
        self._reentrant = reentrant
        self._tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            d = self._depth()
            self._tls.depth = d + 1
            if d == 0:  # reentrant re-acquire adds no edge
                self._witness.note_acquire(id(self), self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        d = self._depth()
        self._tls.depth = max(0, d - 1)
        if d <= 1:
            self._witness.note_release(id(self))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    # Condition protocol (threading.Condition probes these with getattr).

    def _release_save(self):
        d = self._depth()
        self._tls.depth = 0
        self._witness.note_release(id(self))
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), d)
        self._inner.release()
        return (None, d)

    def _acquire_restore(self, state):
        saved, d = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(saved)
        else:
            self._inner.acquire()
        self._tls.depth = d
        self._witness.note_acquire(id(self), self._name)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return self._depth() > 0

    def __repr__(self):
        return "<WitnessLock {} of {!r}>".format(self._name,
                                                 self._inner)


class _Installed:
    """Module state for one install(): the witness plus the site map."""

    def __init__(self, witness: Witness,
                 decls: Dict[Tuple[str, int], object], root: str):
        self.witness = witness
        self.decls = decls
        self.root = os.path.abspath(root) + os.sep


_active: Optional[_Installed] = None


def _site_name(inst: _Installed) -> Optional[str]:
    """Canonical name for a lock allocated at the caller's caller, or
    None when the allocation is outside the package (pass through)."""
    f = sys._getframe(2)
    path = os.path.abspath(f.f_code.co_filename)
    decl = inst.decls.get((path, f.f_lineno))
    if decl is not None:
        # Condition(self.X) aliases collapse onto the underlying lock.
        alias = getattr(decl, "alias_of", None)
        owner = getattr(decl, "owner", "?")
        return "{}.{}".format(owner, alias) if alias \
            else getattr(decl, "name", None)
    if path.startswith(inst.root):
        return "{}:{}".format(os.path.relpath(path, inst.root), f.f_lineno)
    return None


def _make_lock(*a, **kw):
    inst = _active
    inner = _REAL_LOCK(*a, **kw)
    if inst is None:
        return inner
    name = _site_name(inst)
    if name is None:
        return inner
    return _WitnessLock(inner, name, inst.witness, reentrant=False)


def _make_rlock(*a, **kw):
    inst = _active
    inner = _REAL_RLOCK(*a, **kw)
    if inst is None:
        return inner
    name = _site_name(inst)
    if name is None:
        return inner
    return _WitnessLock(inner, name, inst.witness, reentrant=True)


#: root -> (canonical order, decl by site): the static oracle, parsed once a
#: process (the sources do not change under a running process, and a parse
#: of the package takes seconds; soaks install the witness one after another).
_ORACLES: Dict[str, Tuple[List[str], Dict[Tuple[str, int], object]]] = {}


def _oracle(root: str) -> Tuple[List[str], Dict[Tuple[str, int], object]]:
    if root not in _ORACLES:
        from maggy_tpu_torch.analysis import parse_package
        from maggy_tpu_torch.analysis.lockorder import build_graph, canonical_order

        index = parse_package(root)
        _ORACLES[root] = (canonical_order(build_graph(index)), index.decl_by_site())
    return _ORACLES[root]


def install(root: Optional[str] = None) -> Witness:
    """Compute the static oracle (once a process a root), patch the
    threading factories, return the live witness. Idempotent: a second
    install returns the active witness."""
    global _active
    if _active is not None:
        return _active.witness
    from maggy_tpu_torch.analysis import package_root

    root = root or package_root()
    order, decls = _oracle(root)
    inst = _Installed(Witness(order), decls, root)
    _active = inst
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    return inst.witness


def uninstall() -> Optional[Witness]:
    """Restore the real factories; returns the retired witness (its
    recorded edges/violations stay readable). Already-wrapped locks keep
    working — their witness just stops gaining new allocations."""
    global _active
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    inst, _active = _active, None
    return inst.witness if inst is not None else None


def active_witness() -> Optional[Witness]:
    return _active.witness if _active is not None else None


def maybe_install() -> Optional[Witness]:
    """Install iff the env arms it (the chaos CLI / soak entry point)."""
    return install() if enabled_by_env() else active_witness()


class SoakWitness:
    """A soak's hold on the witness (``maggy_tpu/chaos/harness.py:
    679-686, 742-747, 815-827``): ``lock_witness`` True arms it, None
    defers to ``MAGGY_TPU_TORCH_LOCK_WITNESS``, False leaves it off. Built
    before the soak's objects make their locks; ``release()`` uninstalls
    a witness this soak installed (an env-armed one stays, shared by the
    process's soaks). Violations count from this soak's start, so a
    shared witness does not charge one soak with another's edges."""

    def __init__(self, lock_witness: Optional[bool]):
        self.witness: Optional[Witness] = None
        self._installed_here = False
        self._pre_violations = 0
        self._pre_acquisitions = 0
        self._pre_busy_s = 0.0
        if lock_witness or (lock_witness is None and enabled_by_env()):
            self._installed_here = active_witness() is None
            self.witness = install()
            snap = self.witness.snapshot()
            self._pre_violations = len(snap["violations"])
            self._pre_acquisitions = snap["acquisitions"]
            self._pre_busy_s = snap["busy_s"]

    def release(self) -> None:
        if self.witness is not None and self._installed_here \
                and not enabled_by_env():
            uninstall()

    def __enter__(self) -> "SoakWitness":
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def reading(self) -> Optional[Dict[str, Any]]:
        """The soak's share of the witness: ``edge_count`` (every edge the
        witness holds), this soak's ``violations``, ``acquisitions`` and
        ``busy_s``; None when the witness is off."""
        if self.witness is None:
            return None
        snap = self.witness.snapshot()
        return {"edge_count": snap["edge_count"],
                "violations": snap["violations"][self._pre_violations:],
                "acquisitions": snap["acquisitions"] - self._pre_acquisitions,
                "busy_s": snap["busy_s"] - self._pre_busy_s}
