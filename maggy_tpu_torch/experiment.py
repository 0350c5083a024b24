"""`lagom` — the experiment entry point.

Counterpart of ``maggy_tpu/experiment.py`` for optimization experiments
(parity: reference `maggy/experiment.py` — one experiment at a time per
process (:42-45), `lagom(train_fn, config)` (:48-83), `@singledispatch`
driver dispatch on the config type (:86-108)). With ``config.resume`` it
re-enters the most recent run of the app id (``MAGGY_TPU_APP_ID``) whose
experiment has the config's name (``maggy_tpu/experiment.py:76-95``), so a
resume in a new process finds its run. An ``AblationConfig`` runs a LOCO
study through the ``AblationDriver`` (``core/driver/ablation_driver.py``).
``lagom_submit`` (``maggy_tpu/experiment.py:155-200``) submits an experiment
to a shared ``fleet.Fleet`` instead: any number run at once in one process,
leasing the fleet's runners by priority, weight and quota. A
``DistributedConfig`` trains one model on a world of ranks through the
``DistributedDriver`` (``core/driver/distributed_driver.py``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from functools import singledispatch
from typing import Any, Callable, Optional

from maggy_tpu_torch import util
from maggy_tpu_torch.config import (AblationConfig, DistributedConfig, LagomConfig,
                                    OptimizationConfig)
from maggy_tpu_torch.core.environment import EnvSing

_state_lock = threading.Lock()
_active_runs: set = set()  # guarded-by: _state_lock
_token_counter = itertools.count()


class _Submission:
    """One claimed run: (app_id, run_id) and the token that marks it active
    until ``_end_run`` (``maggy_tpu/experiment.py:51-62``)."""

    __slots__ = ("token", "app_id", "run_id")

    def __init__(self, token: int, app_id: str, run_id: int):
        self.token = token
        self.app_id = app_id
        self.run_id = run_id


def _begin_run(config, env, exclusive: bool) -> _Submission:
    """Claim a run under the lock (``maggy_tpu/experiment.py:65-103``):
    the app id (MAGGY_TPU_APP_ID, else the time), a run id claimed
    atomically (or, with ``config.resume``, the most recent run of this
    app whose experiment has the config's name), and the run marked active.
    ``exclusive`` is ``lagom``'s rule, one experiment at a time in the
    process; fleet submissions pass False."""
    with _state_lock:
        if exclusive and _active_runs:
            raise RuntimeError("An experiment is already running in this process.")
        app_id = os.environ.get("MAGGY_TPU_APP_ID",
                                "app-{}".format(time.strftime("%Y%m%d-%H%M%S")))
        base = config.experiment_dir or env.experiment_base_dir()
        if getattr(config, "resume", False):
            run_id = util.find_resume_run_id(base, app_id, config.name, env)
        else:
            run_id = util.claim_run_id(base, app_id, env)
        token = next(_token_counter)
        _active_runs.add(token)
        return _Submission(token, app_id, run_id)


def _end_run(sub: _Submission) -> None:
    with _state_lock:
        _active_runs.discard(sub.token)


def lagom(train_fn: Callable, config: LagomConfig) -> Any:
    """Run an experiment selected by the config type; returns its result.
    One experiment at a time per process (``lagom_submit`` runs many)."""
    sub = _begin_run(config, EnvSing.get_instance(), exclusive=True)
    try:
        return lagom_driver(config, sub.app_id, sub.run_id).run_experiment(train_fn)
    finally:
        _end_run(sub)


def lagom_submit(train_fn: Callable, config: LagomConfig, *, fleet, priority="normal",
                 weight: float = 1.0, min_runners: int = 0,
                 max_runners: Optional[int] = None, name: Optional[str] = None,
                 block: bool = True) -> Any:
    """Submit an experiment to a shared runner fleet (``fleet.Fleet``). Any
    number of submissions run at once in one process: the fleet's scheduler
    shares its runners by ``priority`` class ("high"/"normal"/"low" or an
    int; lower wins), weighted fair share (``weight``) and quotas
    (``min_runners`` guaranteed, by preempting over-share or lower-class
    trials when needed; ``max_runners`` capped). A preempted trial resumes
    from its last checkpoint step on its next runner (from scratch when it
    never saved). ``block=True`` waits and returns what ``lagom`` would;
    ``block=False`` returns the ``FleetSubmission`` handle (``.result()``,
    ``.done()``). With ``config.resume`` the submission re-enters its run,
    and two submissions racing for one run dir are arbitrated by the
    driver's incarnation marker (``util.claim_driver_epoch``): the loser's
    handle raises ``RunAdoptionError``."""
    handle = fleet.submit(train_fn, config, priority=priority, weight=weight,
                          min_runners=min_runners, max_runners=max_runners, name=name)
    return handle.result() if block else handle


@singledispatch
def lagom_driver(config, app_id: str, run_id: int):
    raise TypeError("Unsupported config type {}; the port runs OptimizationConfig, "
                    "AblationConfig and DistributedConfig.".format(type(config)))


@lagom_driver.register(OptimizationConfig)
def _(config: OptimizationConfig, app_id: str, run_id: int):
    from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver

    return OptimizationDriver(config, app_id, run_id)


@lagom_driver.register(AblationConfig)
def _(config: AblationConfig, app_id: str, run_id: int):
    from maggy_tpu_torch.core.driver.ablation_driver import AblationDriver

    return AblationDriver(config, app_id, run_id)


@lagom_driver.register(DistributedConfig)
def _(config: DistributedConfig, app_id: str, run_id: int):
    from maggy_tpu_torch.core.driver.distributed_driver import DistributedDriver

    return DistributedDriver(config, app_id, run_id)
