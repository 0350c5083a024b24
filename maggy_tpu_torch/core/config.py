"""Runtime-mode detection.

The port's copy of ``maggy_tpu/core/config.py`` (parity: reference
`maggy/core/config.py:17-37`, which tells HOPSWORKS from SPARK_ONLY by
environment variables). The same three-way shape, with the JAX package's
TPU markers turned into a CUDA host check: LOCAL (no card), GPU_HOST (one
host with CUDA devices) or GPU_CLUSTER (several hosts, named by
MAGGY_TPU_WORKER_HOSTNAMES, the port's counterpart of
TPU_WORKER_HOSTNAMES). The card count comes from
``torch.cuda.device_count()``, which reads NVML and creates no CUDA
context. Detection is a function, not import-time state, so tests can
patch the environment.
"""

from __future__ import annotations

import os
from typing import Literal

Mode = Literal["LOCAL", "GPU_HOST", "GPU_CLUSTER"]


def detect_mode() -> Mode:
    """LOCAL (no card), GPU_HOST (one host with CUDA devices) or
    GPU_CLUSTER (several hosts)."""
    hostnames = os.environ.get("MAGGY_TPU_WORKER_HOSTNAMES", "")
    if hostnames and len(hostnames.split(",")) > 1:
        return "GPU_CLUSTER"
    if num_local_chips() > 0:
        return "GPU_HOST"
    return "LOCAL"


def default_pool_type() -> str:
    """The runner-pool default for the detected mode: "thread" on a host
    without a card, "gpu" (runner processes pinned to their devices) on
    one with cards."""
    return "thread" if detect_mode() == "LOCAL" else "gpu"


def num_local_chips() -> int:
    """CUDA devices this process sees (0 without a card or a driver)."""
    try:
        import torch

        return int(torch.cuda.device_count())
    except Exception:  # noqa: BLE001 - no usable CUDA runtime means no card
        return 0
