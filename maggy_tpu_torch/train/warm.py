"""The trial scope: which trial the current thread trains, and its stats.

The trial-scope part of ``maggy_tpu/train/warm.py:25-180``. The trial
executor wraps each train_fn call in ``trial_scope``; code the trial runs
on that thread (the ``Trainer``, the ``TrialContext``'s checkpoint calls)
reaches the running trial's ``RunnerStats`` through it, so telemetry lands
in the right runner's buffer when thread runners share one process.
``fresh_state`` marks a trial that continues saved state (a fork, a
promotion or a preemption resume). Outside a scope every note is a no-op.
The warm cache itself (resident programs and retired state buffers reused
across trials, which ``fresh_state`` would keep such a trial from
consuming) is not ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

_local = threading.local()


class _TrialScope:
    __slots__ = ("trial_id", "stats", "fresh_state")

    def __init__(self, trial_id, stats, fresh_state):
        self.trial_id = trial_id
        self.stats = stats
        self.fresh_state = fresh_state


def current_scope() -> Optional[_TrialScope]:
    return getattr(_local, "scope", None)


class trial_scope:
    """Context manager the trial executor wraps around one train_fn call:
    routes telemetry noted on this thread to ``stats`` (a
    ``RunnerStats``); ``fresh_state=True`` for a trial that restores a
    checkpoint (``core.executors.context.info_needs_fresh_state``)."""

    def __init__(self, trial_id: Optional[str] = None, stats=None,
                 fresh_state: bool = False):
        self._scope = _TrialScope(trial_id, stats, fresh_state)

    def __enter__(self) -> _TrialScope:
        self._prev = getattr(_local, "scope", None)
        _local.scope = self._scope
        return self._scope

    def __exit__(self, exc_type, exc, tb) -> None:
        _local.scope = self._prev


def fresh_state_only() -> bool:
    """True when the current trial resumes a checkpoint (its own or a
    parent's): its state must come from that checkpoint, never from an
    earlier trial."""
    scope = current_scope()
    return scope is not None and scope.fresh_state


def note_compile(**fields: Any) -> None:
    """Record set-up telemetry for the current trial (merged into its
    RunnerStats ``compile`` record; ``*_ms`` fields accumulate)."""
    scope = current_scope()
    stats = scope.stats if scope is not None else None
    if stats is not None:
        stats.note_compile(**fields)


def note_ckpt(**fields: Any) -> None:
    """Record checkpoint I/O for the current trial (merged into its
    RunnerStats ``ckpt`` record; ``*_ms``, ``saves`` and ``restores``
    accumulate), which goodput folds into ``ckpt_save`` and
    ``ckpt_restore``."""
    scope = current_scope()
    stats = scope.stats if scope is not None else None
    if stats is not None:
        stats.note_ckpt(**fields)


def note_counter(key: str, n: int = 1) -> None:
    """Bump a cumulative counter of the current trial's runner."""
    scope = current_scope()
    stats = scope.stats if scope is not None else None
    if stats is not None:
        stats.note_counter(key, n)
