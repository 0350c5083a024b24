"""On-demand and health-triggered device profiling on ``torch.profiler``.

The port's ``maggy_tpu/telemetry/profiling.py``, whose captures are
``jax.profiler`` traces. A step-time regression is diagnosable from a device
profile captured AT the anomaly; a journal line says a partition straggled,
not why. This module owns that capture:

- ``ProfileCapturer.capture``: one bounded ``torch.profiler`` window written
  as a Chrome trace (``trace.json``) under ``<exp_dir>/profiles/<stamp>/``
  together with a faulthandler all-threads dump (``threads.txt``). The dump
  lands FIRST and the ``profile_captured`` journal event, which names the
  activities the window records (CPU, plus CUDA once the process has
  initialized CUDA), is recorded as soon as the artifact directory is real,
  so a hard kill mid-trace still leaves a linked artifact. A window that
  finds another torch.profiler active in the process (one profiler a
  process) records ``profiler: "unavailable"`` and keeps the dump alone, as
  the JAX package does when ``jax.profiler`` is busy.
- ``ProfileCapturer.auto_capture``: the HealthEngine's hook: the FIRST
  ``straggler``/``hang`` raise per partition triggers a background capture,
  at most one per partition and ``AUTO_CAPTURE_LIMIT`` per run. It runs on
  its own daemon thread, so the health check keeps its cadence.

Runner threads capture their steps as CUDA graphs, and no thread may
synchronize the device during a capture; and a stop with runner threads
stepping beside it was seen to hang on the card (PERF.md). So the
profiler's start and its stop each hold ``device_gate.quiesce``: no step
and no capture runs meanwhile. The window between them holds nothing, and
the trace is written after the stop, outside the gate. The stop drains
the window's events with every runner held, so an auto window is short
(``AUTO_CAPTURE_DURATION_S``). ``prime`` pays the profiler's one-time
start-up (CUPTI's) once, when the obs plane comes up, before any runner
steps. Captures in one process run one at a time (``/profilez`` and the
auto captures of every experiment share one lock).

A remote target (an experiment dir on an object store, ``gs://...``) is
written into a local staging directory and uploaded through the
environment (``upload_tree``), as TensorBoard's event files are: nothing
is written under a local path that begins with ``gs:``.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import socket
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from maggy_tpu_torch import device_gate
from maggy_tpu_torch.core.environment import is_remote

#: Auto (health-triggered) captures per run, across all partitions.
AUTO_CAPTURE_LIMIT = 2

#: Trace window for auto captures, seconds. Short on purpose: the stalled
#: partition is stalled NOW, and the capture must land in the journal
#: before the experiment can wind down. A fifth of the JAX package's 0.5
#: s: the stop drains the window's events with every runner held, and a
#: card replaying captured steps on three runner threads records some 75k
#: kernel events a second (PERF.md), so the hold of a 0.5 s window (about
#: 2 s) outlasts a hang bound (1 s at the JAX package's stall soak values).
AUTO_CAPTURE_DURATION_S = 0.1

#: Health checks that trigger an auto capture (mirrors the stall checks
#: the chaos harness asserts on).
AUTO_CAPTURE_CHECKS = ("straggler", "hang")

#: The trace file inside a capture's directory.
TRACE_NAME = "trace.json"

#: One capture at a time in a process: torch.profiler is a process global.
_CAPTURE_LOCK = threading.Lock()


def capture_activities() -> List[str]:
    """The activities a window records now: CPU, and CUDA when this process
    has initialized CUDA (a process that never touched the card has no
    device work to trace and must not create a context for the profiler)."""
    import torch

    return ["cpu", "cuda"] if torch.cuda.is_initialized() else ["cpu"]


#: A profiled trial's trace directory inside its trial directory
#: (``config.profile``): its TensorBoard logdir, where the JAX package's
#: ``jax.profiler`` trace goes (``trial_executor.py:613-617``).
TRIAL_PROFILE_DIR = "tensorboard"

#: The suffix of a trace that TensorBoard's profile plugin reads.
TB_TRACE_SUFFIX = ".pt.trace.json"


def tb_trace_path(trace_dir: str) -> str:
    """A trace's path in ``trace_dir``, named as
    ``torch.profiler.tensorboard_trace_handler`` names it:
    ``<host>_<pid>.<ns>.pt.trace.json``."""
    return os.path.join(trace_dir, "{}_{}.{}{}".format(
        socket.gethostname(), os.getpid(), time.time_ns(), TB_TRACE_SUFFIX))


def upload_file(local_path: str, remote_path: str) -> None:
    """Copy one local file to ``remote_path`` through the active
    environment, chunked (traces run to GBs)."""
    from maggy_tpu_torch.core.environment import EnvSing

    with open(local_path, "rb") as src, \
            EnvSing.get_instance().open_file(remote_path, "wb") as dst:
        shutil.copyfileobj(src, dst)


def upload_tree(local_dir: str, remote_dir: str) -> None:
    """Copy a staged directory to its remote home through the active
    environment (best-effort, as every TensorBoard and profile artifact
    is), then remove the staging directory."""
    try:
        for root, _, files in os.walk(local_dir):
            rel = os.path.relpath(root, local_dir)
            for fname in files:
                upload_file(os.path.join(root, fname), "/".join(
                    p for p in (remote_dir, "" if rel == "." else rel, fname) if p))
    except Exception:  # noqa: BLE001 - an artifact never fails its run
        pass
    finally:
        shutil.rmtree(local_dir, ignore_errors=True)


def _trial_activities() -> List[str]:
    import torch

    return ["cpu", "cuda"] if torch.cuda.is_available() else ["cpu"]


@contextlib.contextmanager
def trial_profile(trace_dir: str):
    """``config.profile`` (``maggy_tpu/core/executors/trial_executor.py:
    583-620``): trace one trial into ``trace_dir`` (a trial's
    ``<trial dir>/tensorboard``, a distributed rank's
    ``<exp dir>/tensorboard_worker<partition>``) as ``tb_trace_path``
    names the file, recording CPU and, where the process can reach a card,
    CUDA. Yields the trace's path, or None when the process's profiler is
    taken (another trial's trace, a user trace or a capture holds it): the
    trial then runs untraced. Start and stop hold ``device_gate.quiesce``,
    as every capture does. A remote ``trace_dir`` is staged locally and
    uploaded after the stop."""
    if not _CAPTURE_LOCK.acquire(blocking=False):
        yield None
        return
    try:
        prof = _start_trace(_trial_activities())
        if isinstance(prof, str):
            yield None
            return
        path = tb_trace_path(trace_dir)
        staging = tempfile.mkdtemp(prefix="maggy_trace_") if is_remote(trace_dir) else None
        try:
            yield path
        finally:
            if staging is None:
                os.makedirs(trace_dir, exist_ok=True)
                _stop_trace(prof, path)
            else:
                _stop_trace(prof, os.path.join(staging, os.path.basename(path)))
                upload_tree(staging, trace_dir)
    finally:
        _CAPTURE_LOCK.release()


def start_user_trace():
    """``tensorboard.start_trace``'s profiler: holds ``_CAPTURE_LOCK`` until
    ``stop_user_trace``, so it never overlaps a trial's profile or a
    capture. Raises RuntimeError when the profiler is taken."""
    if not _CAPTURE_LOCK.acquire(blocking=False):
        raise RuntimeError("the process's profiler is taken (a trial's profile, "
                           "a capture or another trace)")
    try:
        prof = _start_trace(_trial_activities())
    except BaseException:
        _CAPTURE_LOCK.release()
        raise
    if isinstance(prof, str):
        _CAPTURE_LOCK.release()
        raise RuntimeError(prof)
    return prof


def stop_user_trace(prof, trace_dir: str) -> str:
    """Stop ``start_user_trace``'s profiler, write its trace into
    ``trace_dir`` and release the profiler. Returns the trace's path."""
    try:
        path = tb_trace_path(trace_dir)
        os.makedirs(trace_dir, exist_ok=True)
        _stop_trace(prof, path)
        return path
    finally:
        _CAPTURE_LOCK.release()


class ProfileCapturer:
    """Capture coordinator for one experiment. Thread-safe; at most one
    capture in flight in the process."""

    def __init__(self, telemetry, profile_dir: str,
                 auto_limit: int = AUTO_CAPTURE_LIMIT,
                 auto_duration_s: float = AUTO_CAPTURE_DURATION_S):
        self.telemetry = telemetry
        self.profile_dir = profile_dir
        self.auto_limit = int(auto_limit)
        self.auto_duration_s = float(auto_duration_s)
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        #: Partitions whose first straggler/hang raise already captured.
        self._auto_partitions: set = set()  # guarded-by: _lock
        self._auto_count = 0  # guarded-by: _lock
        self._threads: List[threading.Thread] = []  # guarded-by: _lock

    # -------------------------------------------------------------- capture

    def capture(self, duration_s: float = 2.0, reason: str = "manual",
                check: Optional[str] = None, partition=None,
                trial: Optional[str] = None) -> Dict[str, Any]:
        """Run one capture window synchronously on the CALLER's thread
        (obs /profilez handlers run per-request threads; auto captures come
        through ``auto_capture``'s worker). Returns the record (journaled
        before the window), or ``{"skipped": ...}`` when a capture is
        already in flight."""
        if not _CAPTURE_LOCK.acquire(blocking=False):
            return {"skipped": "capture already in flight"}
        try:
            with self._lock:
                self._seq += 1
                seq = self._seq
            stamp = "{}_{:03d}_{}".format(int(time.time()), seq, reason)
            if partition is not None:
                stamp += "_p{}".format(partition)
            target = os.path.join(self.profile_dir, stamp)
            staging = tempfile.mkdtemp(prefix="maggy_profile_") \
                if is_remote(target) else None
            local = staging or target
            os.makedirs(local, exist_ok=True)
            # The thread dump is the cheap, always-available half of the
            # artifact, written before the trace.
            from maggy_tpu_torch.telemetry.health import thread_dump

            try:
                with open(os.path.join(local, "threads.txt"), "w") as f:
                    f.write(thread_dump(max_bytes=1 << 20))
                if staging is not None:
                    upload_file(os.path.join(local, "threads.txt"), target + "/threads.txt")
            except Exception:  # noqa: BLE001 - the dump is best-effort
                pass
            record: Dict[str, Any] = {
                "path": target, "reason": reason,
                "duration_s": round(float(duration_s), 3),
                "activities": capture_activities()}
            if check is not None:
                record["check"] = check
            if partition is not None:
                record["partition"] = partition
            if trial is not None:
                record["trial"] = trial
            # Journal BEFORE the window: the directory (with the dump) is
            # real, and the profiler's first start initializes CUPTI.
            self.telemetry.event("profile_captured", **record)
            t0 = time.monotonic()
            prof = _start_trace(record["activities"])
            if isinstance(prof, str):
                record["profiler"] = "unavailable"
                record["profiler_error"] = prof
                return record
            record["profiler"] = "torch"
            time.sleep(float(duration_s))
            trace = os.path.join(local, TRACE_NAME)
            _stop_trace(prof, trace)
            record["trace"] = os.path.join(target, TRACE_NAME)
            record["trace_bytes"] = os.path.getsize(trace)
            record["capture_s"] = time.monotonic() - t0
            return record
        finally:
            if staging is not None:
                upload_tree(staging, target)
            _CAPTURE_LOCK.release()

    def prime(self) -> float:
        """Start and stop one empty window with this process's activities,
        so a capture at an anomaly does not pay CUPTI's first start while
        runners step. Returns its seconds."""
        t0 = time.monotonic()
        with _CAPTURE_LOCK:
            prof = _start_trace(capture_activities())
            if not isinstance(prof, str):
                with device_gate.quiesce():
                    prof.stop()
        return time.monotonic() - t0

    # --------------------------------------------------------- auto capture

    def auto_capture(self, check: str, partition,
                     trial: Optional[str] = None) -> bool:
        """Health-engine hook: capture on the first straggler/hang raise
        per partition (max ``auto_limit`` per run). Returns whether a
        capture was started; the capture itself runs on a daemon thread
        so the health-check loop keeps its cadence."""
        if check not in AUTO_CAPTURE_CHECKS or partition is None:
            return False
        with self._lock:
            if partition in self._auto_partitions \
                    or self._auto_count >= self.auto_limit:
                return False
            self._auto_partitions.add(partition)
            self._auto_count += 1
            thread = threading.Thread(
                target=self._auto_worker, args=(check, partition, trial),
                daemon=True, name="telemetry-profile")
            self._threads.append(thread)
        thread.start()
        return True

    def join(self, timeout_s: float = 60.0) -> None:
        """Wait for the auto captures in flight (the driver's stop calls
        it, so no capture outlives its experiment)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._threads)
        for thread in threads:
            thread.join(max(0.0, deadline - time.monotonic()))

    def _auto_worker(self, check: str, partition, trial) -> None:
        """Capture for one health-flagged partition, WAITING OUT a busy
        capturer instead of losing the slot (correlated stalls flag two
        partitions in one health pass); still busy after the wait window,
        the slot is rolled back so a later re-raise can try again."""
        deadline = time.monotonic() + 30.0
        while True:
            record = self.capture(duration_s=self.auto_duration_s,
                                  reason="auto", check=check,
                                  partition=partition, trial=trial)
            if not record.get("skipped"):
                return
            if time.monotonic() > deadline:
                break
            time.sleep(0.25)
        with self._lock:
            self._auto_partitions.discard(partition)
            self._auto_count -= 1


def _start_trace(activities: List[str]):
    """A started ``torch.profiler.profile``, or, when another profiler is
    active in the process, the reason there is none."""
    import torch

    if torch.autograd.profiler._is_profiler_enabled \
            or torch._C._autograd._profiler_enabled():
        return "RuntimeError('another torch.profiler is active in this process')"
    kinds = {"cpu": torch.profiler.ProfilerActivity.CPU,
             "cuda": torch.profiler.ProfilerActivity.CUDA}
    prof = torch.profiler.profile(activities=[kinds[a] for a in activities])
    with device_gate.quiesce():
        prof.start()
    return prof


def _stop_trace(prof, path: str) -> None:
    with device_gate.quiesce():
        prof.stop()
    prof.export_chrome_trace(path)

