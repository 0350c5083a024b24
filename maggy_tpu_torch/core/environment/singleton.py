"""Environment singleton (parity: reference
`maggy/core/environment/singleton.py`): a ``GCSEnv`` when
``MAGGY_TPU_BASE_DIR`` is a ``gs://`` path, else a working ``LocalEnv``
(JAX ``singleton.py:22-28``)."""

from __future__ import annotations

import os
import threading
from typing import Optional

from maggy_tpu_torch.core.environment.abstractenvironment import AbstractEnv, GCSEnv, LocalEnv


class EnvSing:
    _instance: Optional[AbstractEnv] = None
    _lock = threading.Lock()

    @classmethod
    def get_instance(cls) -> AbstractEnv:
        with cls._lock:
            if cls._instance is None:
                base = os.environ.get("MAGGY_TPU_BASE_DIR", "")
                cls._instance = GCSEnv(base) if base.startswith("gs://") else LocalEnv()
            return cls._instance

    @classmethod
    def set_instance(cls, env: AbstractEnv) -> None:
        with cls._lock:
            cls._instance = env

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None
