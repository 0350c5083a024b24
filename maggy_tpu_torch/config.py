"""Typed experiment configs; the config type selects the experiment kind.

The subset of ``maggy_tpu/config.py`` the port runs: `LagomConfig` and
`OptimizationConfig` with the fields of a single-process thread-runner
sweep. Fleet, gang, vmap, fork, chaos, observability and resume fields are
absent, so passing one is a TypeError rather than a silently ignored knob.
Parity: reference `maggy/experiment_config.py:18-50`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Union

from maggy_tpu_torch import constants
from maggy_tpu_torch.searchspace import Searchspace


@dataclass
class LagomConfig:
    """Base config (reference `experiment_config.py:18-23`)."""

    name: str = "maggyTpuTorchExperiment"
    hb_interval: float = constants.DEFAULT_HEARTBEAT_INTERVAL_S


@dataclass
class OptimizationConfig(LagomConfig):
    """Hyperparameter-optimization experiment (reference
    `experiment_config.py:25-50`).

    ``optimizer`` is a registry name ("randomsearch", "asha", "gridsearch",
    "tpe", "gp", "none") or an AbstractOptimizer instance. ``num_workers``
    is the number of concurrent thread runners, or "auto" for one per CUDA
    device; the driver clamps it to ``num_trials``. ``prefetch`` pipelines
    the trial hand-off: a suggester thread materializes the next
    suggestions while runners train, and a FINAL's reply carries the
    runner's next trial (``maggy_tpu/config.py:194``)."""

    num_trials: int = 1
    optimizer: Union[str, Any] = "randomsearch"
    searchspace: Optional[Searchspace] = None
    optimization_key: str = "metric"
    direction: str = "max"
    es_interval: int = constants.DEFAULT_ES_INTERVAL
    es_min: int = constants.DEFAULT_ES_MIN
    es_policy: Union[str, Any] = constants.DEFAULT_ES_POLICY
    num_workers: Union[int, str] = 1
    seed: Optional[int] = None
    prefetch: bool = True
    # Experiment artifact root; defaults to the environment's base dir.
    experiment_dir: Optional[str] = None

    def __post_init__(self):
        if self.direction not in ("max", "min"):
            raise ValueError("direction must be 'max' or 'min', got {!r}".format(self.direction))
        if isinstance(self.num_workers, str) and self.num_workers != "auto":
            raise ValueError(
                "num_workers must be an int or 'auto', got {!r}".format(
                    self.num_workers))
