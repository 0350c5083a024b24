"""Environment: filesystem + experiment registry services.

The local-filesystem environment of ``maggy_tpu/core/environment/
abstractenvironment.py``, with the resume-time sweep of orphaned atomic-dump
files and the chaos write hook: ``dump`` and ``exclusive_create`` ask an
armed engine's ``on_env_write`` first (``env_write_fail``; the telemetry
journal's own path is exempt there). ``connect_host`` binds the host a
config names (``DistributedConfig.bind_host``: 0.0.0.0 for remote agents).
The abstract interface and the GCS backend (a store shared by the hosts of
a pod) are not ported: each process of a multi-host world writes its own
files where its environment says. Parity: reference
`maggy/core/environment/abstractenvironment.py:20-169`.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional


class LocalEnv:
    """Local-filesystem environment. Experiment artifacts live under
    ``base_dir`` (default ``$MAGGY_TPU_BASE_DIR`` or
    ``~/maggy_tpu_experiments``)."""

    #: Writes land on a local filesystem: a checkpoint fork publishes with
    #: one tree copy and ``os.replace`` (``train/checkpoint.py``).
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

    @staticmethod
    def _chaos_write_check(path: str) -> None:
        """Raise the OSError of an ``env_write_fail`` fault that fires for
        ``path``; unarmed, one global read."""
        from maggy_tpu_torch.chaos.injectors import active_engine

        engine = active_engine()
        if engine is not None:
            engine.on_env_write(path)

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

    def connect_host(self, server, host: Optional[str] = None, port: int = 0):
        """Bind the control-plane server; returns (host, port)."""
        return server.start(host=host or "127.0.0.1", port=port)
