"""`lagom` — the experiment entry point.

Counterpart of ``maggy_tpu/experiment.py`` for optimization experiments
(parity: reference `maggy/experiment.py` — one experiment at a time per
process (:42-45), `lagom(train_fn, config)` (:48-83), `@singledispatch`
driver dispatch on the config type (:86-108)). With ``config.resume`` it
re-enters the most recent run of the app id (``MAGGY_TPU_APP_ID``) whose
experiment has the config's name (``maggy_tpu/experiment.py:76-95``), so a
resume in a new process finds its run. An ``AblationConfig`` runs a LOCO
study through the ``AblationDriver`` (``core/driver/ablation_driver.py``).
Distributed training and fleet submission are not ported yet.
"""

from __future__ import annotations

import os
import threading
import time
from functools import singledispatch
from typing import Any, Callable

from maggy_tpu_torch import util
from maggy_tpu_torch.config import AblationConfig, LagomConfig, OptimizationConfig
from maggy_tpu_torch.core.environment import EnvSing

_state_lock = threading.Lock()
_running = False  # guarded-by: _state_lock


def lagom(train_fn: Callable, config: LagomConfig) -> Any:
    """Run an experiment selected by the config type; returns its result.
    One experiment at a time per process."""
    global _running
    env = EnvSing.get_instance()
    with _state_lock:
        if _running:
            raise RuntimeError("An experiment is already running in this process.")
        _running = True
    try:
        app_id = os.environ.get("MAGGY_TPU_APP_ID",
                                "app-{}".format(time.strftime("%Y%m%d-%H%M%S")))
        base = config.experiment_dir or env.experiment_base_dir()
        if getattr(config, "resume", False):
            run_id = util.find_resume_run_id(base, app_id, config.name, env)
        else:
            run_id = util.claim_run_id(base, app_id, env)
        return lagom_driver(config, app_id, run_id).run_experiment(train_fn)
    finally:
        with _state_lock:
            _running = False


@singledispatch
def lagom_driver(config, app_id: str, run_id: int):
    raise TypeError("Unsupported config type {}; the port runs "
                    "OptimizationConfig and AblationConfig.".format(type(config)))


@lagom_driver.register(OptimizationConfig)
def _(config: OptimizationConfig, app_id: str, run_id: int):
    from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver

    return OptimizationDriver(config, app_id, run_id)


@lagom_driver.register(AblationConfig)
def _(config: AblationConfig, app_id: str, run_id: int):
    from maggy_tpu_torch.core.driver.ablation_driver import AblationDriver

    return AblationDriver(config, app_id, run_id)
