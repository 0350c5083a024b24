"""Framework-wide constants.

Copy of the subset of ``maggy_tpu/constants.py`` the port uses (parity:
reference `maggy/constants.py:23-28`; the prefetch lock bound of
``maggy_tpu/constants.py:31-36``).
"""

from __future__ import annotations

import numpy as np


class USER_FCT:
    """Allowed return types of a user training function."""

    RETURN_TYPES = (float, int, np.number, dict)
    NUMERIC_TYPES = (float, int, np.number)


# Control-plane defaults (see BASELINE.md "scheduling constants").
DEFAULT_HEARTBEAT_INTERVAL_S = 1.0
DRIVER_IDLE_REQUEUE_TICK_S = 0.1
# First GET retry after a miss; doubles up to DRIVER_IDLE_REQUEUE_TICK_S.
CLIENT_GET_POLL_MIN_S = 0.005
# Request retry budget and backoff (exponential with full jitter).
CLIENT_MAX_RETRIES = 3
CLIENT_RETRY_BACKOFF_BASE_S = 0.05
CLIENT_RETRY_BACKOFF_CAP_S = 2.0
RPC_RECV_BUFSIZE = 1 << 16
# Pipelined hand-off (config.prefetch): how long the FINAL fast path may
# wait for the driver's schedule lock before falling back to the worker
# queue (reply OK, runner GET-polls). The lock is only ever contended
# while the suggester thread is mid-model-fit, so this bounds the RPC
# event loop's worst-case stall per FINAL.
PREFETCH_FINAL_LOCK_TIMEOUT_S = 0.05

# Early-stop defaults (reference `maggy/experiment_config.py:33-35`).
DEFAULT_ES_INTERVAL = 1
DEFAULT_ES_MIN = 10
DEFAULT_ES_POLICY = "median"
