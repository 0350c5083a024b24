"""Typed experiment configs; the config type selects the experiment kind.

The subset of ``maggy_tpu/config.py`` the port runs: `LagomConfig` (with the
heartbeat-loss shape) and `OptimizationConfig` with the fields of a
single-host sweep over thread, process or GPU-pinned process runners, with
heartbeat-loss requeue, the telemetry journal, the compile-once warm path
(``warm_start``), checkpoint forking (``fork``) and experiment resume
(``resume``) and vectorized lanes (``vmap_lanes``). ``chips_per_budget``
(gangs) and ``fleet`` exist only so that setting one raises "not ported
yet" with its ROADMAP item; each is replaced by the real
field in the slice that ports it. Chaos and observability fields are absent, so passing one is a
TypeError rather than a silently ignored knob. Parity: reference
`maggy/experiment_config.py:18-50`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Union

from maggy_tpu_torch import constants
from maggy_tpu_torch.searchspace import Searchspace

#: Runner pools the port runs, and the JAX package's that it does not.
POOLS = ("thread", "process", "gpu")
_UNPORTED_POOLS = ("elastic", "remote")
#: field -> (its value that keeps it off, the ROADMAP queue 1 item that
#: ports it).
_UNPORTED_FIELDS = {"chips_per_budget": (None, "8"), "fleet": (None, "9")}


@dataclass
class LagomConfig:
    """Base config (reference `experiment_config.py:18-23`). A runner is
    declared lost after max(hb_loss_min_s, hb_interval * hb_loss_factor)
    seconds of silence unless the experiment sets ``hb_loss_timeout``.
    ``telemetry`` writes the experiment's journal, ``<exp_dir>/
    telemetry.jsonl`` (``maggy_tpu/config.py:31-36``); with it off, no
    journal is written and result.json's event-derived counts (prefetch
    hits and misses, suggest latencies, hand-off gaps, requeues) are
    empty."""

    name: str = "maggyTpuTorchExperiment"
    hb_interval: float = constants.DEFAULT_HEARTBEAT_INTERVAL_S
    hb_loss_factor: float = constants.HEARTBEAT_LOSS_FACTOR
    hb_loss_min_s: float = constants.HEARTBEAT_LOSS_MIN_S
    telemetry: bool = True

    def resolved_hb_loss_timeout(self) -> float:
        """Seconds of heartbeat silence before a runner is declared lost:
        the explicit ``hb_loss_timeout`` field when set, else
        max(hb_loss_min_s, hb_interval * hb_loss_factor) — the one home of
        this resolution (``maggy_tpu/config.py:107-117``)."""
        explicit = getattr(self, "hb_loss_timeout", None)
        if explicit is not None:
            return float(explicit)
        return max(self.hb_loss_min_s, self.hb_interval * self.hb_loss_factor)


@dataclass
class OptimizationConfig(LagomConfig):
    """Hyperparameter-optimization experiment (reference
    `experiment_config.py:25-50`).

    ``optimizer`` is a registry name ("randomsearch", "asha", "gridsearch",
    "tpe", "gp", "none") or an AbstractOptimizer instance. ``pool`` picks the
    runners: "thread" (in-process threads sharing the CUDA device), "process"
    (one spawned OS process each; ``train_fn`` must be module-level) or "gpu"
    (processes pinned to ``chips_per_trial`` CUDA devices each through
    CUDA_VISIBLE_DEVICES). ``num_workers`` is the runner count, or "auto" for
    one per CUDA device; the driver clamps it to ``num_trials``.
    ``prefetch`` pipelines the trial hand-off: a suggester thread
    materializes the next suggestions while runners train, and a FINAL's
    reply carries the runner's next trial (``maggy_tpu/config.py:194``).
    ``hb_loss_timeout`` overrides the heartbeat-loss shape of LagomConfig.
    ``fork`` (``maggy_tpu/config.py:205-216``): an ASHA promotion, a PBT
    segment or a BO near-duplicate whose parent saved a checkpoint is
    dispatched with ``forked_from`` and ``resume_step``, the runner stages
    the parent's checkpoint into the child's trial dir, and a train
    function that takes ``ctx`` resumes there instead of re-training the
    parent's steps; False gives from-scratch promotions. ``resume``
    (``maggy_tpu/config.py:243-247``) re-enters the most recent run of this
    app id whose experiment has this ``name``: finalized trials are
    reloaded from their trial.json artifacts and never re-run, the trials
    in flight at the interruption are rebuilt from the telemetry journal
    and re-run, and a pruner's bracket state restores from its checkpoint;
    sampling optimizers (RandomSearch, TPE, GP) must carry a fixed seed."""

    num_trials: int = 1
    optimizer: Union[str, Any] = "randomsearch"
    searchspace: Optional[Searchspace] = None
    optimization_key: str = "metric"
    direction: str = "max"
    es_interval: int = constants.DEFAULT_ES_INTERVAL
    es_min: int = constants.DEFAULT_ES_MIN
    es_policy: Union[str, Any] = constants.DEFAULT_ES_POLICY
    num_workers: Union[int, str] = 1
    pool: str = "thread"
    chips_per_trial: int = 1
    seed: Optional[int] = None
    prefetch: bool = True
    hb_loss_timeout: Optional[float] = None
    # Compile-once hot path (train/warm.py, maggy_tpu/config.py:195-204):
    # runners keep each program's materialized model, optimizer and
    # captured step graphs across trials whose program identity matches
    # (model config, device, loss, swept-optimizer family, batch shape),
    # so a repeat trial skips the model's build and the step's capture.
    # State VALUES are always recomputed per trial: only memory and graphs
    # are reused. False restores the build-per-trial eager path.
    warm_start: bool = True
    fork: bool = True
    # Experiment artifact root; defaults to the environment's base dir.
    experiment_dir: Optional[str] = None
    resume: bool = False
    # Vectorized lanes (maggy_tpu/config.py:222-234, train/vmap.py): the
    # driver packs up to this many compatible suggestions (same non-float
    # params, no resume or checkpoint fork) into one block delivered to
    # one runner, whose train function, if it names ``lanes``, trains them
    # in lockstep as one vmapped step. Each lane keeps its own span,
    # metrics and FINAL. 1 (the default) is the scalar dispatch path.
    vmap_lanes: int = 1
    # The JAX package's fields whose slices are still to port: setting one
    # raises (see _UNPORTED_FIELDS).
    chips_per_budget: Optional[Any] = None
    fleet: Any = None

    def __post_init__(self):
        if self.direction not in ("max", "min"):
            raise ValueError("direction must be 'max' or 'min', got {!r}".format(self.direction))
        if isinstance(self.num_workers, str) and self.num_workers != "auto":
            raise ValueError(
                "num_workers must be an int or 'auto', got {!r}".format(
                    self.num_workers))
        if self.pool == "tpu":
            raise ValueError("pool='tpu' pins TPU chips; the port pins CUDA devices "
                             "with pool='gpu'")
        if self.pool in _UNPORTED_POOLS:
            raise NotImplementedError(
                "pool={!r} is not ported yet (ROADMAP queue 1 item 9); the port "
                "runs {}".format(self.pool, ", ".join(repr(p) for p in POOLS)))
        if self.pool not in POOLS:
            raise ValueError("pool must be one of {}, got {!r}".format(
                ", ".join(repr(p) for p in POOLS), self.pool))
        if not isinstance(self.vmap_lanes, int) \
                or isinstance(self.vmap_lanes, bool) or self.vmap_lanes < 1:
            raise ValueError(
                "vmap_lanes must be an int >= 1 (1 = scalar dispatch), "
                "got {!r}".format(self.vmap_lanes))
        for name, (off, item) in _UNPORTED_FIELDS.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    "{}={!r} is not ported yet (ROADMAP queue 1 item {})".format(
                        name, getattr(self, name), item))
        if not isinstance(self.chips_per_trial, int) or self.chips_per_trial < 1:
            raise ValueError("chips_per_trial must be an int >= 1, got {!r}".format(
                self.chips_per_trial))
