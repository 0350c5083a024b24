"""The process's gate between training steps on the card and the work that
must run with no step beside it: CUDA-graph captures, and the profiler's
start and stop.

- ``step()``: a training step (eager or a graph replay). Steps share the
  gate with each other.
- ``capture()``: one CUDA-graph capture, alone: no step and no other
  holder runs meanwhile. A capture in ``thread_local`` mode fails if
  another thread's library call or a device-wide synchronization meets it.
- ``quiesce()``: the same hold, for the profiler's start and its stop (the
  stop synchronizes the device and flushes CUPTI's buffers; a stop with
  runner threads stepping beside it was seen to hang on the card).

A holder that waits keeps new steps out. The trainers (``train/trainer.py``,
``train/vmap.py``) and the profiler (``telemetry/profiling.py``) share the
one gate of the process.
"""

from __future__ import annotations

import contextlib
import threading


class _Gate:
    def __init__(self):
        self._cond = threading.Condition()
        # Steps running, exclusive holders waiting, and whether one holds.
        self._steps = 0  # guarded-by: _cond
        self._waiting = 0  # guarded-by: _cond
        self._held = False  # guarded-by: _cond

    @contextlib.contextmanager
    def step(self):
        with self._cond:
            while self._held or self._waiting:
                self._cond.wait()
            self._steps += 1
        try:
            yield
        finally:
            with self._cond:
                self._steps -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            while self._held or self._steps:
                self._cond.wait()
            self._waiting -= 1
            self._held = True
        try:
            yield
        finally:
            with self._cond:
                self._held = False
                self._cond.notify_all()

    capture = quiesce = exclusive


_GATE = _Gate()

step = _GATE.step
capture = _GATE.capture
quiesce = _GATE.quiesce
