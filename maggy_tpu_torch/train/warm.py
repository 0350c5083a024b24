"""Warm-state runner harness: the compile-once trial hot path on the card.

Counterpart of ``maggy_tpu/train/warm.py``. A trial's step in the JAX
package is one compiled XLA executable, which a runner keeps per program
identity and reuses across trials. Here the counterpart is a **unit**: the
materialized module, its optimizer and the step captured per batch shape as
CUDA graphs (``train/trainer.py``). A unit retired by one trial is taken by
the next trial of the same program, which writes its own initial VALUES into
the unit's memory in place (weights from its seed, optimizer state zeroed,
this trial's hyperparameters in the optimizer's tensors) and replays the
graphs: memory and captured programs are reused, values never are.

This module is the mechanism; ``train/trainer.py`` is the policy:

- ``WarmCache``: a bounded (LRU, ``DEFAULT_WARM_SLOTS``, or
  ``MAGGY_TPU_WARM_SLOTS``) per-process registry of ``WarmSlot`` objects
  keyed by program identity; evicting a slot drops its units and their
  graphs. ``clear_warm()`` empties it.
- ``WarmSlot``: the program's init entry (``_InitEntry``) with its retired
  units, and ``graph_ok``, which a failed capture clears (the counterpart
  of ``aot_ok``): the slot's trials then step eagerly. The JAX slot keeps
  an init entry per example-input shape; the port's ``init`` takes no
  example inputs (a module's shapes come with its identity), so a slot
  has one.
- ``_InitEntry``'s retired cell holds at most ONE unit per runner that
  retired into it (the JAX entry holds one), so two thread runners training
  the same program both find a unit; with one runner the hit/miss sequence
  is the JAX package's.
- **Trial scope**: the executor wraps each trial in ``trial_scope``, so the
  warm path follows ``config.warm_start``, telemetry lands in the trial's
  ``RunnerStats``, and every Trainer the trial built retires its unit at
  scope exit. ``fresh_state`` marks a trial that restores a checkpoint; it
  takes a unit like any other trial, since a unit's values are always
  re-initialized (its pre-restore values are a bit-fresh init), and a
  restore that replaces the optimizer's state tensors drops the unit's
  graphs (``Trainer.step``).
- **Counters**: ``warm_hits`` / ``warm_misses`` (a unit taken or built),
  and the capture counters ``graph_captures``, ``graph_replays``,
  ``graph_failures``, ``eager_steps``, routed to the current trial's
  ``RunnerStats`` and mirrored in process-global counters.

Left out of the JAX module, each for a reason:

- the ``jax.monitoring`` listener (``maggy_tpu/train/warm.py:187-228``):
  the port counts directly;
- the ``xla_cache_*`` counters and ``enable_compile_cache``
  (``maggy_tpu/util.py:235``): the port compiles no XLA program; its only
  compile cache is the kernels' build directory (``ops/build.py``);
- the re-init prebuild (``_prebuild_reinit_async``, ``reinit_prebuilds``,
  ``maggy_tpu/train/trainer.py:120-160``): an in-place torch re-init has no
  compile to overlap;

The vectorized lanes (``train/vmap.py``) keep their own units in the slot
of their program: ``WarmSlot.vmap_entry(key, lanes)`` holds one retired
K-lane unit (stacked state, per-lane optimizer, the block's graphs) per K
(``_VmapEntry``, ``maggy_tpu/train/warm.py:351-424``).

``MAGGY_TPU_WARM_START=0`` disables the warm default process-wide.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

#: Default LRU bound: distinct programs kept warm per runner process.
DEFAULT_WARM_SLOTS = 4

#: Per-unit bound on captured graphs (one per batch-shape signature).
PER_SLOT_SHAPES = 8

#: Counter keys shipped in runner stats / returned by ``counters()``.
COUNTER_KEYS = ("warm_hits", "warm_misses", "graph_captures", "graph_replays",
                "graph_failures", "eager_steps")

_local = threading.local()

_counters_lock = threading.Lock()
_counters: Dict[str, int] = {k: 0 for k in COUNTER_KEYS}


# --------------------------------------------------------------- trial scope

class _TrialScope:
    __slots__ = ("trial_id", "enabled", "stats", "fresh_state", "trainers")

    def __init__(self, trial_id, enabled, stats, fresh_state):
        self.trial_id = trial_id
        self.enabled = enabled
        self.stats = stats
        self.fresh_state = fresh_state
        self.trainers: list = []


def current_scope() -> Optional[_TrialScope]:
    return getattr(_local, "scope", None)


class trial_scope:
    """Context manager the trial executor wraps around one train_fn call.

    Arms the thread's warm behavior (``enabled`` mirrors
    ``config.warm_start``; ``fresh_state=True`` for a trial that restores a
    checkpoint, ``core.executors.context.info_needs_fresh_state``) and routes
    telemetry to ``stats`` (a ``RunnerStats``). On exit, every Trainer the
    trial built retires its unit into its warm slot for the NEXT trial."""

    def __init__(self, trial_id: Optional[str] = None, enabled: bool = True,
                 stats=None, fresh_state: bool = False):
        self._scope = _TrialScope(trial_id, enabled, stats, fresh_state)

    def __enter__(self) -> _TrialScope:
        self._prev = getattr(_local, "scope", None)
        _local.scope = self._scope
        return self._scope

    def __exit__(self, exc_type, exc, tb) -> None:
        scope = self._scope
        _local.scope = self._prev
        if not scope.enabled:
            return
        for trainer in scope.trainers:
            try:
                trainer.retire_to_warm_cache()
            except Exception:  # noqa: BLE001 - retirement is an optimization
                pass


def enabled() -> bool:
    """Is the warm path armed for this thread? The trial scope's flag when
    inside one (``config.warm_start``), else the process default
    (``MAGGY_TPU_WARM_START`` != "0", read at call time so process pools
    inherit it through the environment)."""
    scope = current_scope()
    if scope is not None:
        return scope.enabled
    return os.environ.get("MAGGY_TPU_WARM_START", "1") != "0"


def fresh_state_only() -> bool:
    """True when the current trial resumes a checkpoint (its own or a
    parent's): its state must come from that checkpoint, never from an
    earlier trial."""
    scope = current_scope()
    return scope is not None and scope.fresh_state


def register_trainer(trainer) -> None:
    """Called by ``Trainer.__init__``: the trial scope retires this
    trainer's unit at trial end. No-op outside an armed scope (library
    users may call ``trainer.retire_to_warm_cache()`` themselves)."""
    scope = current_scope()
    if scope is not None and scope.enabled:
        scope.trainers.append(trainer)


def _stats():
    scope = current_scope()
    return scope.stats if scope is not None else None


def note_compile(**fields: Any) -> None:
    """Record set-up telemetry for the current trial (merged into its
    RunnerStats ``compile`` record; ``*_ms`` fields accumulate)."""
    stats = _stats()
    if stats is not None:
        stats.note_compile(**fields)


def note_ckpt(**fields: Any) -> None:
    """Record checkpoint I/O for the current trial (merged into its
    RunnerStats ``ckpt`` record; ``*_ms``, ``saves`` and ``restores``
    accumulate), which goodput folds into ``ckpt_save`` and
    ``ckpt_restore``."""
    stats = _stats()
    if stats is not None:
        stats.note_ckpt(**fields)


def note_counter(key: str, n: int = 1) -> None:
    """Bump a cumulative counter of the current trial's runner."""
    stats = _stats()
    if stats is not None:
        stats.note_counter(key, n)


# ----------------------------------------------------------------- counters

def _count(key: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[key] = _counters.get(key, 0) + n
    note_counter(key, n)


def counters() -> Dict[str, int]:
    """Process-global warm and capture counter snapshot."""
    with _counters_lock:
        return dict(_counters)


def record_warm_event(hit: bool) -> None:
    _count("warm_hits" if hit else "warm_misses")


# -------------------------------------------------------------- program keys

def shape_key(tree) -> tuple:
    """Hashable signature of a batch's structure and leaf shapes, dtypes and
    devices: what one captured graph is valid for. Non-array leaves enter
    by value (a graph bakes them in)."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, shape_key(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(shape_key(v) for v in tree)
    shape = getattr(tree, "shape", None)
    if shape is not None:
        return (tuple(shape), str(tree.dtype), str(getattr(tree, "device", "cpu")))
    return ("value", repr(tree))


def swept_info(factory) -> Optional[Dict[str, Any]]:
    """The metadata ``swept_transform`` attached to an optimizer factory
    (its family and the hyperparameters that ride the optimizer's tensors),
    or None for a plain factory."""
    return getattr(factory, "_maggy_swept", None)


def opt_family(factory) -> Optional[tuple]:
    """Value-independent optimizer identity: factories built by
    ``swept_transform`` from the same factory with the same hyperparameter
    NAMES (and equal repr-stable statics and baked values) share a family.
    None for plain factories AND for swept ones with object-repr statics
    (schedules, callables): no safe cross-object sharing."""
    info = swept_info(factory)
    return None if info is None else info["family"]


def rebind_hyperparams(optimizer, factory):
    """Make a retired unit's ``optimizer`` this trial's: zero its state in
    place (moments, step counts; the tensors a captured graph reads keep
    their memory) and return this trial's learning-rate scheduler built
    over it by ``factory.scheduler``, which writes the trial's rate into
    the optimizer's learning-rate tensor. The counterpart of
    ``maggy_tpu/train/warm.py``'s ``rebind_hyperparams`` and of its
    donating optimizer re-init: a fresh optimizer's lazily created state
    starts at the same zeros."""
    for state in optimizer.state.values():
        for value in state.values():
            if hasattr(value, "zero_"):
                value.zero_()
    return factory.scheduler(optimizer)


# -------------------------------------------------------------- cache/slots

def _release(unit) -> None:
    """Free a dropped unit's captured graphs and their memory pool now (its
    optimizer and learning-rate scheduler reference each other, so the
    unit's last reference may only go at the next cyclic collection)."""
    release = getattr(unit, "release", None)
    if release is not None:
        release()


class _InitEntry:
    """A program's retired units, at most one per runner (keyed by the
    retiring thread: a thread runner keeps its thread for life, and a
    process runner is its process)."""

    __slots__ = ("retired", "lock")

    def __init__(self):
        self.retired: "OrderedDict[int, Any]" = OrderedDict()  # guarded-by: lock
        self.lock = threading.Lock()

    def store_retired(self, unit, runner: Optional[int] = None) -> None:
        runner = threading.get_ident() if runner is None else runner
        with self.lock:
            replaced = self.retired.pop(runner, None)
            self.retired[runner] = unit
        _release(replaced)

    def take_retired(self, runner: Optional[int] = None):
        """Pop a retired unit: this runner's own, else another runner's,
        else None (at most one consumer: its memory is re-initialized in
        place)."""
        runner = threading.get_ident() if runner is None else runner
        with self.lock:
            if runner in self.retired:
                return self.retired.pop(runner)
            if self.retired:
                return self.retired.popitem(last=False)[1]
            return None

    def drop_retired(self) -> None:
        with self.lock:
            units = list(self.retired.values())
            self.retired.clear()
        for unit in units:
            _release(unit)


class _VmapEntry:
    """A program's vectorized warm state for one lane count K: the retired
    K-lane unit of the previous block (``train/vmap.py``), which the next
    block of the program and K takes and re-initializes in place, the
    counterpart of the JAX entry's donated stacked buffers
    (``maggy_tpu/train/warm.py:351-387``). One unit: a second block running
    meanwhile builds its own, and the later retirement replaces (frees) the
    earlier."""

    __slots__ = ("lanes", "retired", "lock")

    def __init__(self, lanes: int):
        self.lanes = lanes
        self.retired = None  # guarded-by: lock
        self.lock = threading.Lock()

    def store_retired(self, unit) -> None:
        with self.lock:
            replaced, self.retired = self.retired, unit
        _release(replaced)

    def take_retired(self):
        """Pop the retired unit (at most one consumer: its memory is
        re-initialized in place)."""
        with self.lock:
            unit, self.retired = self.retired, None
            return unit

    def drop_retired(self) -> None:
        _release(self.take_retired())


class WarmSlot:
    """One program's warm state: its init entry, whose retired units carry
    their captured graphs, its vectorized entries by lane count
    (``vmap_entry``), and ``graph_ok``, cleared by a capture that raised
    (its trials then step eagerly, and the error is kept in
    ``graph_error``)."""

    __slots__ = ("key", "entry", "vmaps", "lock", "graph_ok", "graph_error")

    def __init__(self, key):
        self.key = key
        self.entry = _InitEntry()
        self.vmaps: "OrderedDict[Any, _VmapEntry]" = OrderedDict()  # guarded-by: lock
        self.lock = threading.Lock()
        self.graph_ok = True
        self.graph_error: Optional[str] = None

    def vmap_entry(self, key, lanes: int) -> _VmapEntry:
        """Get-or-create the vectorized entry for ``key`` and ``lanes``
        (``maggy_tpu/train/warm.py:410-424``), bounded by PER_SLOT_SHAPES
        entries a slot (LRU)."""
        with self.lock:
            entry = self.vmaps.get(key)
            evicted = []
            if entry is None or entry.lanes != lanes:
                if entry is not None:
                    evicted.append(entry)
                entry = _VmapEntry(lanes)
                self.vmaps[key] = entry
                while len(self.vmaps) > PER_SLOT_SHAPES:
                    evicted.append(self.vmaps.popitem(last=False)[1])
            else:
                self.vmaps.move_to_end(key)
        for old in evicted:
            old.drop_retired()
        return entry

    def release(self) -> None:
        """Drop every retired unit, freeing its graphs."""
        self.entry.drop_retired()
        with self.lock:
            entries = list(self.vmaps.values())
            self.vmaps.clear()
        for entry in entries:
            entry.drop_retired()


class WarmCache:
    """Bounded LRU of warm slots keyed by program identity."""

    def __init__(self, maxsize: Optional[int] = None):
        if maxsize is None:
            maxsize = int(os.environ.get("MAGGY_TPU_WARM_SLOTS", DEFAULT_WARM_SLOTS))
        self.maxsize = max(1, maxsize)
        self._lock = threading.Lock()
        self._slots: "OrderedDict[Any, WarmSlot]" = OrderedDict()  # guarded-by: _lock

    def slot(self, key) -> Tuple[WarmSlot, bool]:
        """Get-or-create the slot for ``key``; returns (slot, existed)."""
        with self._lock:
            slot = self._slots.get(key)
            if slot is not None:
                self._slots.move_to_end(key)
                return slot, True
            slot = WarmSlot(key)
            self._slots[key] = slot
            evicted = []
            while len(self._slots) > self.maxsize:
                evicted.append(self._slots.popitem(last=False)[1])
        for old in evicted:
            old.release()
        return slot, False

    def clear(self) -> None:
        with self._lock:
            slots = list(self._slots.values())
            self._slots.clear()
        for slot in slots:
            slot.release()

    def keys(self):
        with self._lock:
            return list(self._slots)

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)


_CACHE = WarmCache()


def warm_cache() -> WarmCache:
    return _CACHE


def clear_warm() -> None:
    """Drop every warm slot (retired units, their modules, optimizers and
    captured graphs): the escape hatch for long-lived runners, and the reset
    between A/B arms. Exported as ``maggy_tpu_torch.train.clear_warm``."""
    _CACHE.clear()
