"""Environment: filesystem + experiment registry services.

The local-filesystem environment of ``maggy_tpu/core/environment/
abstractenvironment.py``; the abstract interface, the GCS backend and the
fault-injection write hook are not ported yet. Parity: reference
`maggy/core/environment/abstractenvironment.py:20-169`.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional


class LocalEnv:
    """Local-filesystem environment. Experiment artifacts live under
    ``base_dir`` (default ``$MAGGY_TPU_BASE_DIR`` or
    ``~/maggy_tpu_experiments``)."""

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

    def load(self, path: str) -> str:
        with open(path) as f:
            return f.read()

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
