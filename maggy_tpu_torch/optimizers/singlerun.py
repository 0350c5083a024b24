"""SingleRun: N empty-parameter trials for plain parallel execution.

Copy of ``maggy_tpu/optimizers/singlerun.py`` without resume (parity:
reference `maggy/optimizer/singlerun.py:21-37`); selected by
optimizer="none" in the driver registry.
"""

from __future__ import annotations

from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.trial import Trial


class SingleRun(AbstractOptimizer):
    def __init__(self, seed=None, pruner=None, pruner_kwargs=None):
        if pruner is not None:
            raise ValueError("SingleRun does not support pruners.")
        super().__init__(seed=seed)
        self._pending = []

    def initialize(self) -> None:
        # An index tells otherwise identical empty-param trials apart, so
        # their md5 ids differ.
        self._pending = list(range(self.num_trials))

    def suggest(self):
        if not self._pending:
            return None
        return self.create_trial({"run_index": self._pending.pop(0)}, sample_type="random")

    def recycle(self, trial: Trial) -> None:
        self._pending.insert(0, trial.params.get("run_index"))
