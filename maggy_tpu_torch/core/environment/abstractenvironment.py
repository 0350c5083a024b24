"""Environment: filesystem + experiment registry services.

The port's ``maggy_tpu/core/environment/abstractenvironment.py``:
``AbstractEnv`` (the interface the driver, the executors, the checkpointer,
the journal and the registry use), ``LocalEnv`` (the default, on the local
disk, with the resume-time sweep of orphaned atomic-dump files) and
``GCSEnv`` (the same interface over a ``gs://`` base dir through an fsspec
filesystem, gcsfs by default, for a store the hosts of a pod share).
``dump`` and ``exclusive_create`` ask an armed chaos engine's
``on_env_write`` first (``env_write_fail``; the telemetry journal's own
path is exempt there). ``connect_host`` binds the host a config names
(``DistributedConfig.bind_host``: 0.0.0.0 for remote agents).

Neither ``fsspec`` nor ``gcsfs`` is imported here: ``GCSEnv`` imports
gcsfs only when it is built without a filesystem, so ``import
maggy_tpu_torch`` and ``GCSEnv(base, fs=...)`` need neither. Parity:
reference `maggy/core/environment/abstractenvironment.py:20-169`.
"""

from __future__ import annotations

import glob
import io
import json
import os
import shutil
import socket
import threading
import time
from abc import ABC
from typing import Any, Dict, List, Optional


def is_remote(path: str) -> bool:
    """Whether ``path`` names an object store (``gs://...``): its files go
    through the environment, never the local disk."""
    return "://" in path


class AbstractEnv(ABC):
    """Filesystem + experiment-registry services used by the driver and the
    executors (JAX ``abstractenvironment.py:21-126``)."""

    #: True when ``dump`` is a cheap local write (sub-ms): the driver's
    #: inline FINAL fast path persists trial.json on the RPC event loop
    #: only then, and a checkpoint fork publishes with one tree copy and
    #: ``os.replace`` (``train/checkpoint.py``). Object stores keep their
    #: writes off that thread.
    FAST_LOCAL_WRITES = False

    @staticmethod
    def _chaos_write_check(path: str) -> None:
        """Raise the OSError of an ``env_write_fail`` fault that fires for
        ``path``; unarmed, one global read."""
        from maggy_tpu_torch.chaos.injectors import active_engine

        engine = active_engine()
        if engine is not None:
            engine.on_env_write(path)

    # ------------------------------------------------------------------- fs

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def mkdir(self, path: str) -> None:
        raise NotImplementedError

    def dump(self, data: str, path: str) -> None:
        raise NotImplementedError

    def exclusive_create(self, data: str, path: str) -> bool:
        """Create ``path`` with ``data`` only if it does not exist; False when
        another writer got there first. This default is a best-effort
        exists + dump (open to a race); ``LocalEnv`` and ``GCSEnv`` override
        it with exclusive primitives."""
        if self.exists(path):
            return False
        self.dump(data, path)
        return True

    def load(self, path: str) -> str:
        raise NotImplementedError

    def open_file(self, path: str, mode: str = "r"):
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError

    def ls(self, path: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str, recursive: bool = False) -> None:
        raise NotImplementedError

    def sweep_tmp_files(self, path: str) -> int:
        """Collect the write artifacts a crashed run orphaned under ``path``;
        returns how many went. Default: none (a backend whose ``dump``
        writes in one shot leaves none)."""
        return 0

    # -------------------------------------------------------------- registry

    def experiment_base_dir(self) -> str:
        raise NotImplementedError

    def register_experiment(self, app_id: str, run_id: int, meta: Dict[str, Any],
                            base_dir: Optional[str] = None) -> str:
        """Create the experiment directory and persist initial metadata;
        returns the experiment dir (reference `util.py:264-279`)."""
        raise NotImplementedError

    def update_experiment(self, exp_dir: str, meta: Dict[str, Any]) -> None:
        raise NotImplementedError

    def finalize_experiment(self, exp_dir: str, state: str, meta: Dict[str, Any]) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------ networking

    def get_ip_address(self) -> str:
        """This host's outward address, from the route a UDP socket picks
        (no packet is sent); 127.0.0.1 without one."""
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            ip = s.getsockname()[0]
        except OSError:
            ip = "127.0.0.1"
        finally:
            s.close()
        return ip

    def connect_host(self, server, host: Optional[str] = None, port: int = 0):
        """Bind the control-plane server; returns (host, port). ``port``
        pins the bind (a recovering driver rebinds its pre-crash port); 0
        is ephemeral."""
        return server.start(host=host or "127.0.0.1", port=port)

    @staticmethod
    def str_or_byte(value):
        return value.decode() if isinstance(value, bytes) else value


class LocalEnv(AbstractEnv):
    """Local-filesystem environment. Experiment artifacts live under
    ``base_dir`` (default ``$MAGGY_TPU_BASE_DIR`` or
    ``~/maggy_tpu_experiments``)."""

    FAST_LOCAL_WRITES = True

    def __init__(self, base_dir: Optional[str] = None):
        self.base_dir = base_dir or os.environ.get(
            "MAGGY_TPU_BASE_DIR",
            os.path.join(os.path.expanduser("~"), "maggy_tpu_experiments"),
        )

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def mkdir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def dump(self, data: str, path: str) -> None:
        # Atomic (tmp + rename): a hard kill mid-write leaves old-or-nothing.
        self._chaos_write_check(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = "{}.tmp.{}.{}".format(path, os.getpid(), threading.get_ident())
        try:
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def exclusive_create(self, data: str, path: str) -> bool:
        """Create ``path`` with ``data`` only if it does not exist; False when
        another writer got there first. A private tmp file is hard-linked into
        place: exclusive (the kernel arbitrates) and atomic."""
        self._chaos_write_check(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = "{}.tmp.{}.{}".format(path, os.getpid(), threading.get_ident())
        try:
            with open(tmp, "w") as f:
                f.write(data)
            try:
                os.link(tmp, path)
            except FileExistsError:
                return False
            return True
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def sweep_tmp_files(self, path: str, grace_s: float = 120.0) -> int:
        """Remove orphaned atomic-dump files (``<name>.tmp.<pid>.<tid>``, the
        names ``dump`` and ``exclusive_create`` write) left by a process that
        died between write and rename; called at resume start-up. Only files
        older than ``grace_s`` go: a live writer (a runner that outlived a
        crashed driver) holds its file for milliseconds, so the age, not the
        suffix, keeps the sweep off a write in flight
        (``maggy_tpu/core/environment/abstractenvironment.py:208-230``)."""
        removed = 0
        cutoff = time.time() - grace_s
        for tmp in glob.glob(os.path.join(path, "**", "*.tmp.*"), recursive=True):
            try:
                if os.path.getmtime(tmp) < cutoff:
                    os.unlink(tmp)
                    removed += 1
            except OSError:
                pass
        return removed

    def load(self, path: str) -> str:
        with open(path) as f:
            return f.read()

    def delete(self, path: str, recursive: bool = False) -> None:
        """Remove a file, or a directory (with its contents when
        ``recursive``); a missing one is not an error."""
        if os.path.isdir(path):
            if recursive:
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.rmdir(path)
            return
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass

    def open_file(self, path: str, mode: str = "r"):
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return open(path, mode)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def ls(self, path: str) -> List[str]:
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    def experiment_base_dir(self) -> str:
        return self.base_dir

    def register_experiment(self, app_id: str, run_id: int, meta: Dict[str, Any],
                            base_dir: Optional[str] = None) -> str:
        """Create the experiment directory and persist initial metadata;
        returns the experiment dir (reference `util.py:264-279`)."""
        exp_dir = os.path.join(base_dir or self.base_dir, "{}_{}".format(app_id, run_id))
        self.mkdir(exp_dir)
        self.dump(json.dumps({**meta, "state": "RUNNING"}, indent=2, default=str),
                  os.path.join(exp_dir, "experiment.json"))
        return exp_dir

    def update_experiment(self, exp_dir: str, meta: Dict[str, Any]) -> None:
        path = os.path.join(exp_dir, "experiment.json")
        current = json.loads(self.load(path)) if self.exists(path) else {}
        current.update(meta)
        self.dump(json.dumps(current, indent=2, default=str), path)

    def finalize_experiment(self, exp_dir: str, state: str, meta: Dict[str, Any]) -> None:
        self.update_experiment(exp_dir, {**meta, "state": state})


class GCSEnv(LocalEnv):
    """The environment over a ``gs://`` base dir through an fsspec
    filesystem (JAX ``abstractenvironment.py:277-382``): gcsfs by default,
    or the ``fs`` given (an in-memory filesystem in tests, a stand-in store
    on a machine without network). Writes are one-shot objects, so there
    is no tmp file to sweep and no rename."""

    FAST_LOCAL_WRITES = False  # object-store round trips, not a local disk

    def __init__(self, base_dir: str, fs=None):
        if not base_dir.startswith("gs://"):
            raise ValueError("GCSEnv requires a gs:// base dir")
        if fs is None:
            try:
                import gcsfs
            except ImportError as e:
                raise ImportError(
                    "GCSEnv requires gcsfs; install it or use LocalEnv with "
                    "an NFS-shared base dir."
                ) from e
            fs = gcsfs.GCSFileSystem()
        super().__init__(base_dir)
        self.fs = fs

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)

    def mkdir(self, path: str) -> None:
        # Real, not a no-op: fsspec emulates directories, so isdir() and
        # ls() on a freshly registered experiment dir behave as on a disk
        # before the first object lands in it.
        self.fs.makedirs(path, exist_ok=True)

    def dump(self, data: str, path: str) -> None:
        # One-shot object write: the store commits the whole object at
        # close (old-or-nothing).
        self._chaos_write_check(path)
        with self.fs.open(path, "w") as f:
            f.write(data)

    def exclusive_create(self, data: str, path: str) -> bool:
        # if_generation_match=0 is GCS's server-side O_CREAT|O_EXCL: the
        # write commits only where no object exists, so one concurrent
        # creator wins. A filesystem that ignores the keyword (fsspec's
        # memory one) is guarded by the exists() check alone.
        self._chaos_write_check(path)
        if self.fs.exists(path):
            return False
        try:
            with self.fs.open(path, "w", if_generation_match=0) as f:
                f.write(data)
        except FileExistsError:
            return False
        except (OSError, ValueError) as e:
            # gcsfs surfaces the 412 precondition failure in several
            # shapes: those mean the race was lost, anything else is a
            # real I/O error.
            msg = str(e).lower()
            if "generation" in msg or "precondition" in msg or "412" in msg:
                return False
            raise
        except TypeError:
            # The filesystem refuses the keyword: a plain write, guarded
            # by the exists() check only.
            with self.fs.open(path, "w") as f:
                f.write(data)
        return True

    def load(self, path: str) -> str:
        with self.fs.open(path, "r") as f:
            return AbstractEnv.str_or_byte(f.read())

    def open_file(self, path: str, mode: str = "r"):
        if "a" in mode:
            # An object has no append. gcsfs turns "a" into an overwrite
            # with a warning, which would keep only a journal's newest
            # flush; refused, the journal rewrites whole (ROADMAP queue 3
            # item 29: the JAX GCSEnv passes "a" through).
            raise io.UnsupportedOperation(
                "GCSEnv: an object store has no append ({!r} on {})".format(mode, path))
        return self.fs.open(path, mode)

    def isdir(self, path: str) -> bool:
        return self.fs.isdir(path)

    def ls(self, path: str) -> List[str]:
        # fsspec lists full object paths; the interface gives bare names,
        # as LocalEnv does, and [] for a missing path.
        if not self.fs.isdir(path):
            return []
        return sorted(
            os.path.basename(AbstractEnv.str_or_byte(
                p["name"] if isinstance(p, dict) else p).rstrip("/"))
            for p in self.fs.ls(path))

    def delete(self, path: str, recursive: bool = False) -> None:
        if self.fs.exists(path):
            self.fs.rm(path, recursive=recursive)

    def sweep_tmp_files(self, path: str) -> int:
        # Not LocalEnv's local glob: one-shot objects leave no tmp files.
        return 0
