"""Framework-wide constants.

Copy of the subset of ``maggy_tpu/constants.py`` the port uses (parity:
reference `maggy/constants.py:23-28`; the prefetch lock bound of
``maggy_tpu/constants.py:31-36``; the fork-affinity hold of
``maggy_tpu/constants.py:38-43``; the heartbeat-loss defaults of
``maggy_tpu/constants.py:80-88``; the registration barrier, the rendezvous and the shared
listener's per-tenant queue of ``maggy_tpu/constants.py:26-30, 37, 49, 79``).
"""

from __future__ import annotations

import os

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
# Request retry budget and backoff (exponential with full jitter). The
# budget is env-overridable (MAGGY_TPU_CLIENT_MAX_RETRIES,
# ``maggy_tpu/constants.py:50-58``): runners that must outlive a driver's
# restart (the driver-kill soak, ``chaos/driver_soak.py``) keep retrying
# across the window.
CLIENT_MAX_RETRIES = int(os.environ.get("MAGGY_TPU_CLIENT_MAX_RETRIES", "3"))
CLIENT_RETRY_BACKOFF_BASE_S = 0.05
CLIENT_RETRY_BACKOFF_CAP_S = 2.0
RPC_RECV_BUFSIZE = 1 << 16
# QUERY poll of the runner's registration barrier wait.
CLIENT_POLL_INTERVAL_S = 1.0
# Heartbeat batching (``maggy_tpu/constants.py:65-73``): beats whose ship
# failed are banked client-side, coalesced per trial, and re-delivered as one
# BATCH frame on the next beat. The bounds cap memory over a long driver
# outage; beyond them the oldest entries are dropped.
CLIENT_MAX_PENDING_BEATS = 16
CLIENT_MAX_PENDING_LOG_LINES = 500
# How long the registration barrier (and a remote runner's wait for its
# join ticket) may take before it fails.
REGISTRATION_TIMEOUT_S = 600.0
#: Bound between an elastic RESIZE request and the respawned runner's REG: a
#: respawn that wedges before registering never heartbeats, so this is its
#: liveness bound (the driver kills it past it).
RESIZE_RESPAWN_TIMEOUT_S = 120.0
# A distributed worker's wait for the coordinator rendezvous (DIST_CONFIG),
# polled from CLIENT_GET_POLL_MIN_S doubling up to the cap
# (``maggy_tpu/constants.py:26-29, 49``).
RENDEZVOUS_TIMEOUT_S = 60.0
CLIENT_DIST_CONFIG_POLL_MAX_S = 0.5
# The shared listener's per-tenant dispatch queue: a tenant whose handlers
# fall behind fills its own queue, and a frame past it is shed with its
# connection (the client's retry re-delivers); other tenants are unaffected.
TENANT_DISPATCH_QUEUE_DEPTH = 512
# Pipelined hand-off (config.prefetch): how long the FINAL fast path may
# wait for the driver's schedule lock before falling back to the worker
# queue (reply OK, runner GET-polls). The lock is only ever contended
# while the suggester thread is mid-model-fit, so this bounds the RPC
# event loop's worst-case stall per FINAL.
PREFETCH_FINAL_LOCK_TIMEOUT_S = 0.05
# Failure detection: a runner whose assigned trial has gone this many
# heartbeat intervals without any message is declared lost and its trial is
# requeued to another runner (the floor keeps a sub-second hb_interval from
# declaring a runner dead while it creates its CUDA context). Defaults for
# the ``hb_loss_factor`` / ``hb_loss_min_s`` config fields.
HEARTBEAT_LOSS_FACTOR = 30.0
HEARTBEAT_LOSS_MIN_S = 10.0

# Checkpoint forking: how long a forked trial may wait for the runner that
# ran its parent (``maggy_tpu/constants.py:38-43``) before any idle runner
# takes it: that runner holds the parent's program in its warm slot
# (train/warm.py), whose retired unit the fork takes before it restores.
FORK_AFFINITY_HOLD_S = 0.5

# Multi-fidelity bracket state (Hyperband), checkpointed into the experiment
# dir on every scheduling transition so that ``resume=True`` restores it
# (``maggy_tpu/constants.py:91``; either package reads the other's file).
PRUNER_STATE_FILE = ".pruner_state.json"

# Early-stop defaults (reference `maggy/experiment_config.py:33-35`).
DEFAULT_ES_INTERVAL = 1
DEFAULT_ES_MIN = 10
DEFAULT_ES_POLICY = "median"
