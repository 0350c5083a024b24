"""Per-trial TensorBoard event files, written without ``tensorboard`` or
``protobuf``.

The port's copy of ``maggy_tpu/tensorboard.py``: a logdir registered per
trial (one writer per runner THREAD, ``threading.local``, since thread
runners share this module), the HParams plugin's records for the
experiment and each trial, and the telemetry scalars. The JAX module writes
through the ``tensorboard`` package's ``EventFileWriter`` and the plugin's
protos; the card's machine has neither ``tensorboard`` nor ``protobuf``, so
this module writes the same records itself:

- an event file is a TFRecord file of ``Event`` protos, framed with the
  masked crc32c of ``train/tfrecord.py`` (native codec where built);
- the protos are hand-encoded (field numbers and types from the
  descriptors of ``tensorboard`` 2.20.0's ``compat/proto`` and
  ``plugins/hparams`` modules), for exactly the messages used: ``Event``
  (``wall_time``, ``step``, ``file_version``, ``summary``),
  ``Summary.Value`` (``tag``, ``simple_value``, ``metadata``, ``tensor``),
  ``SummaryMetadata.PluginData``, ``HParamsPluginData`` with
  ``SessionStartInfo`` (its ``hparams`` map), ``SessionEndInfo`` and
  ``Experiment``, ``HParamInfo`` with its ``Interval`` and ``ListValue``
  domains, ``MetricInfo``, ``google.protobuf.Value`` and the null
  ``TensorProto`` of the plugin's ``metadata.NULL_TENSOR``. As protobuf
  does, a proto3 scalar at its default is left out unless it belongs to a
  oneof, and a map entry is a length-delimited ``key``/``value`` message;
  none of these messages has a packed field in use.

The records are the JAX writer's: ``add_scalar`` -> a ``simple_value``
event; ``write_hparams`` -> the session start with the cleaned hparams
(bool before int); ``_close`` -> the session end (``STATUS_SUCCESS``);
``write_experiment_config`` -> the experiment's HParams config under
``<exp_dir>/tensorboard`` (continuous types as ``FLOAT64`` intervals,
discrete and categorical ones as numeric or string lists);
``write_telemetry_scalars`` -> ``telemetry/<group>_<stat>`` scalars beside
it. The first record of a file is ``file_version: "brain.Event:2"``, and
files are named ``events.out.tfevents.<secs>.<host>.<pid>.<n>`` as
``EventFileWriter`` names them, so TensorBoard's loader globs them. The
header carries no ``source_metadata`` (the messages above are the whole
encoder).

Differences, on purpose: the JAX module falls back to JSON files when the
``tensorboard`` package is absent; this one never lacks its writer, so it
has no fallback. Events are written as they come (buffered, flushed at
close) rather than by a background writer thread. ``start_trace`` /
``stop_trace`` trace with ``torch.profiler`` through
``telemetry/profiling.py`` (its ``_CAPTURE_LOCK`` and ``device_gate``'s
quiesce, so a user trace never races a trial's profile or a capture) into
a ``*.pt.trace.json`` under the trial's logdir.

A remote logdir (``://``) is staged in a local temporary directory and
uploaded through the port's environment at close (JAX ``:112-125``,
``:175-199``). TensorBoard never fails a trial: every hook is best-effort.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional

from maggy_tpu_torch.core.environment import is_remote
from maggy_tpu_torch.telemetry.profiling import upload_tree
from maggy_tpu_torch.train.tfrecord import _len_delim, _tag, _varint, frame_record

# Per-THREAD registry: trial runners are threads sharing this module; a
# module global would let concurrent trials close or steal each other's
# writers (JAX ``tensorboard.py:36-40``).
_state = threading.local()

#: Tags of the HParams plugin's records (``hparams/metadata.py``).
EXPERIMENT_TAG = "_hparams_/experiment"
SESSION_START_INFO_TAG = "_hparams_/session_start_info"
SESSION_END_INFO_TAG = "_hparams_/session_end_info"
PLUGIN_NAME = "hparams"

#: Enum values (``hparams/api.proto``).
STATUS_SUCCESS = 1
DATA_TYPE_STRING = 1
DATA_TYPE_FLOAT64 = 3

#: The first record's version string.
FILE_VERSION = "brain.Event:2"

#: Event files' name prefix, the one TensorBoard's loader globs.
EVENT_FILE_PREFIX = "events.out.tfevents."

# A file name's last part, unique in the process (EventFileWriter's
# ``_global_uid``).
_file_seq = itertools.count()


def _get(name: str):
    return getattr(_state, name, None)


def _clean_hparams(hparams: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v if isinstance(v, (int, float, str, bool)) else str(v)
            for k, v in hparams.items()}


# ------------------------------------------------------------ proto encoder


def _double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", float(value))


def _float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


def _int(field: int, value: int) -> bytes:
    """An int64 / enum / bool as a varint (negatives in two's complement)."""
    return _tag(field, 0) + _varint(int(value) & 0xFFFFFFFFFFFFFFFF)


def _str(field: int, value: str) -> bytes:
    return _len_delim(field, value.encode("utf-8"))


def _pb_value(value) -> bytes:
    """``google.protobuf.Value``: number 2, string 3, bool 4 (a oneof, so
    a default value is still written)."""
    if isinstance(value, bool):
        return _int(4, value)
    if isinstance(value, (int, float)):
        return _double(2, value)
    return _str(3, str(value))


#: The plugin's ``NULL_TENSOR``: dtype DT_FLOAT (1), shape ``[0]`` (one
#: dim of size 0, which is all defaults).
_NULL_TENSOR = _int(1, 1) + _len_delim(2, _len_delim(2, b""))


def _hparams_summary(tag: str, plugin_data: bytes) -> bytes:
    """A ``Summary`` carrying one ``HParamsPluginData`` record: its value's
    metadata names the plugin, its tensor is the null tensor."""
    meta = _len_delim(1, _str(1, PLUGIN_NAME) + _len_delim(2, plugin_data))
    value = _str(1, tag) + _len_delim(9, meta) + _len_delim(8, _NULL_TENSOR)
    return _len_delim(1, value)


def _scalar_summary(tag: str, value: float) -> bytes:
    return _len_delim(1, _str(1, tag) + _float(2, value))


def _session_start(hparams: Dict[str, Any]) -> bytes:
    info = b"".join(_len_delim(1, _str(1, name) + _len_delim(2, _pb_value(val)))
                    for name, val in hparams.items())
    info += _double(5, time.time())
    return _hparams_summary(SESSION_START_INFO_TAG, _len_delim(3, info))


def _session_end() -> bytes:
    info = _int(1, STATUS_SUCCESS) + _double(2, time.time())
    return _hparams_summary(SESSION_END_INFO_TAG, _len_delim(4, info))


def _hparam_info(name: str, hp_type: str, region) -> bytes:
    from maggy_tpu_torch.searchspace import Searchspace

    if hp_type in Searchspace.CONTINUOUS_TYPES:
        lo, hi = float(region[0]), float(region[1])
        interval = (_double(1, lo) if lo else b"") + (_double(2, hi) if hi else b"")
        return _str(1, name) + _int(4, DATA_TYPE_FLOAT64) + _len_delim(6, interval)
    numeric = all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in region)
    domain = b"".join(_len_delim(1, _double(2, float(v)) if numeric else _str(3, str(v)))
                      for v in region)
    return (_str(1, name) + _int(4, DATA_TYPE_FLOAT64 if numeric else DATA_TYPE_STRING)
            + _len_delim(5, domain))


def _experiment_summary(searchspace) -> bytes:
    """Searchspace -> the HParams plugin's experiment record (the
    dashboard's columns; JAX ``tensorboard.py:266-304``)."""
    exp = _double(3, time.time())
    for name, spec in searchspace.to_dict().items():
        exp += _len_delim(4, _hparam_info(name, spec["type"], spec["values"]))
    exp += _len_delim(5, _len_delim(1, _str(2, "metric")))
    return _hparams_summary(EXPERIMENT_TAG, _len_delim(2, exp))


def encode_event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
                 summary: Optional[bytes] = None) -> bytes:
    """One serialized ``Event`` (``summary`` already encoded)."""
    out = _double(1, wall_time)
    if step:
        out += _int(2, step)
    if file_version is not None:
        out += _str(3, file_version)
    if summary is not None:
        out += _len_delim(5, summary)
    return out


# ------------------------------------------------------------------ writer


class _EventWriter:
    """One event file: the version record first, then one record an event.
    A remote logdir is staged locally and uploaded by ``finish``."""

    def __init__(self, logdir: str):
        self._remote_dir = None
        if is_remote(logdir):
            import tempfile

            self._remote_dir = logdir
            logdir = tempfile.mkdtemp(prefix="maggy_tb_staging_")
        self._staging_dir = logdir
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "{}{:010d}.{}.{}.{}".format(
            EVENT_FILE_PREFIX, int(time.time()), socket.gethostname(), os.getpid(),
            next(_file_seq)))
        self._file = open(self.path, "wb")
        self._add(file_version=FILE_VERSION)
        self._file.flush()

    def _add(self, step: int = 0, file_version: Optional[str] = None,
             summary: Optional[bytes] = None) -> None:
        self._file.write(frame_record(encode_event(time.time(), step, file_version, summary)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._add(step=int(step), summary=_scalar_summary(tag, value))

    def write_hparams(self, hparams: Dict[str, Any],
                      metrics: Optional[Dict[str, float]]) -> None:
        self._add(summary=_session_start(_clean_hparams(hparams)))
        for tag, value in (metrics or {}).items():
            self.add_scalar(tag, value, 0)

    def write_experiment(self, summary: bytes) -> None:
        self._add(summary=summary)

    def finish(self) -> None:
        """Flush and close the file and upload a staged remote logdir: the
        teardown of every writer, without the session end."""
        self._file.close()
        if self._remote_dir is not None:
            upload_tree(self._staging_dir, self._remote_dir)

    def close(self) -> None:
        try:
            self._add(summary=_session_end())
        except Exception:  # noqa: BLE001 - close must always flush
            pass
        self.finish()


def _tb_dir(exp_dir: str) -> str:
    return "/".join((exp_dir, "tensorboard")) if is_remote(exp_dir) \
        else os.path.join(exp_dir, "tensorboard")


def _register(trial_logdir: str) -> None:
    """Called by the trial executor (in the runner's thread) when a trial
    starts; closes this thread's previous trial writer."""
    _close()
    _state.logdir = trial_logdir
    _state.writer = _EventWriter(trial_logdir)


def _close() -> None:
    writer = _get("writer")
    if writer is not None:
        try:
            writer.close()
        except Exception:  # noqa: BLE001
            pass
    _state.writer = None
    _state.logdir = None


def logdir() -> str:
    """The current trial's TensorBoard logdir (reference ``tensorboard.py:33``)."""
    current = _get("logdir")
    if current is None:
        raise RuntimeError("No trial logdir registered; are you inside a trial?")
    return current


def add_scalar(tag: str, value: float, step: int = 0) -> None:
    writer = _get("writer")
    if writer is not None:
        writer.add_scalar(tag, value, step)


def write_hparams(hparams: Dict[str, Any], metrics: Optional[Dict[str, float]] = None) -> None:
    """Per-trial hparams record (reference ``tensorboard.py:90-93``)."""
    writer = _get("writer")
    if writer is not None:
        writer.write_hparams(hparams, metrics)


def write_experiment_config(exp_dir: str, searchspace) -> None:
    """Experiment-level HParams dashboard config, written once at startup
    into ``exp_dir/tensorboard`` (TensorBoard treats each trial dir as a
    session under this root)."""
    if searchspace is None:
        return
    try:
        w = _EventWriter(_tb_dir(exp_dir))
        w.write_experiment(_experiment_summary(searchspace))
        w.finish()
    except Exception:  # noqa: BLE001 - TB must never block an experiment
        pass


def write_telemetry_scalars(exp_dir: str, snapshot: Dict[str, Any]) -> None:
    """Mirror a telemetry snapshot's derived scheduling numbers into the
    experiment-level TensorBoard dir (next to the hparams config), so the
    dashboard shows hand-off gap and early-stop reaction beside the sweep.
    Best-effort like every TensorBoard artifact."""
    spans = (snapshot or {}).get("spans") or {}
    scalars: Dict[str, float] = {}
    for group in ("handoff", "early_stop_reaction", "requeue_recovery"):
        stats = spans.get(group) or {}
        for key in ("median_ms", "p95_ms", "n"):
            if stats.get(key) is not None:
                scalars["telemetry/{}_{}".format(group, key)] = float(stats[key])
    for key, val in (spans.get("trials") or {}).items():
        scalars["telemetry/trials_{}".format(key)] = float(val)
    if not scalars:
        return
    try:
        w = _EventWriter(_tb_dir(exp_dir))
        for tag, value in sorted(scalars.items()):
            w.add_scalar(tag, value, 0)
        w.finish()
    except Exception:  # noqa: BLE001 - TB must never block an experiment
        pass


def start_trace(trace_dir: Optional[str] = None) -> None:
    """Trace with ``torch.profiler`` into ``trace_dir`` (default: the
    trial's logdir), viewable in TensorBoard's profile plugin. Raises
    RuntimeError when the process's profiler is taken (a trial's profile,
    a capture or another trace), as ``jax.profiler.start_trace`` does when
    a trace is active. A remote target is staged locally and uploaded at
    ``stop_trace``."""
    from maggy_tpu_torch.telemetry import profiling

    target = trace_dir or logdir()
    staging = None
    if is_remote(target):
        import tempfile

        staging = (tempfile.mkdtemp(prefix="maggy_trace_"), target)
        target = staging[0]
    _state.trace = (profiling.start_user_trace(), target, staging)


def stop_trace() -> None:
    """Stop the trace ``start_trace`` began in this thread and write it."""
    from maggy_tpu_torch.telemetry import profiling

    trace = _get("trace")
    if trace is None:
        raise RuntimeError("No trace started in this thread")
    _state.trace = None
    prof, target, staging = trace
    profiling.stop_user_trace(prof, target)
    if staging is not None:
        upload_tree(staging[0], staging[1])
