"""Environment singleton (parity: reference
`maggy/core/environment/singleton.py`); the default is a working LocalEnv."""

from __future__ import annotations

import threading
from typing import Optional

from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv


class EnvSing:
    _instance: Optional[LocalEnv] = None
    _lock = threading.Lock()

    @classmethod
    def get_instance(cls) -> LocalEnv:
        with cls._lock:
            if cls._instance is None:
                cls._instance = LocalEnv()
            return cls._instance

    @classmethod
    def set_instance(cls, env: LocalEnv) -> None:
        with cls._lock:
            cls._instance = env

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None
