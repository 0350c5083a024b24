"""Ablation-study driver.

Copy of ``maggy_tpu/core/driver/ablation_driver.py`` (parity: reference
`maggy/core/experiment_driver/ablation_driver.py` — subclasses the HPO
driver (:26), forces no early stopping (:33), controller = LOCO over the
study with num_trials from the ablator (:46-49), executor runs in ablation
mode (:95-106), resolving declarative specs to dataset and model
generators). ``pool="remote"`` is refused, as in the JAX package
(``:23-28``): the study's generators are local callables that do not
travel to a remote agent.
"""

from __future__ import annotations

import time

from maggy_tpu_torch.ablation.ablator import LOCO, AbstractAblator
from maggy_tpu_torch.config import AblationConfig
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
from maggy_tpu_torch.core.executors.trial_executor import trial_executor_fn
from maggy_tpu_torch.earlystop import NoStoppingRule

ABLATOR_REGISTRY = {"loco": LOCO}


class AblationDriver(OptimizationDriver):
    def __init__(self, config: AblationConfig, app_id: str, run_id: int):
        if config.pool == "remote":
            raise ValueError(
                "pool='remote' is not supported for ablation studies: the study's "
                "model/dataset generators are local callables and cannot be shipped to "
                "remote agents. Use a local pool.")
        super().__init__(config, app_id, run_id)
        # Early stopping is meaningless for a fixed ablation schedule
        # (reference `ablation_driver.py:33`).
        self.earlystop_check = NoStoppingRule

    @staticmethod
    def _init_controller(config):
        ablator = config.ablator
        if isinstance(ablator, str):
            key = ablator.lower()
            if key not in ABLATOR_REGISTRY:
                raise ValueError(
                    "Unknown ablator '{}'; choose from {} or pass an AbstractAblator "
                    "instance.".format(ablator, sorted(ABLATOR_REGISTRY)))
            return ABLATOR_REGISTRY[key](config.ablation_study)
        if not isinstance(ablator, AbstractAblator):
            raise TypeError("ablator must be a name or AbstractAblator instance")
        return ablator

    def _resolve_num_trials(self, config) -> int:
        return self.controller.get_number_of_trials()

    def _executor_fn(self, train_fn):
        return trial_executor_fn(
            server_addr=self.server_addr, secret=self.server.secret_hex,
            hb_interval=self.hb_interval, exp_dir=self.exp_dir,
            optimization_key=self.optimization_key, train_fn=train_fn,
            warm_start=self.config.warm_start, trial_type="ablation",
            ablation_resolver=self.controller.make_resolver(),
            profile=self.config.profile, ship_prints=self.config.ship_prints)

    def _exp_startup_callback(self) -> None:
        self.job_start = time.time()
        self.env.update_experiment(
            self.exp_dir, {"ablation_study": self.config.ablation_study.to_dict()})
