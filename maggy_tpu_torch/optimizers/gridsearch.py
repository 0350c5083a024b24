"""Grid search over DISCRETE/CATEGORICAL spaces.

Copy of ``maggy_tpu/optimizers/gridsearch.py`` (parity:
reference `maggy/optimizer/gridsearch.py` — cartesian product (:72-79),
continuous-param rejection (:81-90), `get_num_trials` classmethod used by
the driver (:33-43), no pruner support (:47-51)).
"""

from __future__ import annotations

from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial


class GridSearch(AbstractOptimizer):
    def __init__(self, seed=None, pruner=None, pruner_kwargs=None):
        if pruner is not None:
            raise ValueError("GridSearch does not support pruners.")
        super().__init__(seed=seed)
        self.config_buffer = []

    @classmethod
    def get_num_trials(cls, searchspace: Searchspace) -> int:
        return len(searchspace.grid())

    def initialize(self) -> None:
        self.config_buffer = self.searchspace.grid()

    def suggest(self):
        # report() is a no-op: the grid is fixed, so suggestions may be
        # prefetched ahead.
        if not self.config_buffer:
            return None
        return self.create_trial(self.config_buffer.pop(0), sample_type="grid")

    def recycle(self, trial: Trial) -> None:
        # The schedule is exactly the grid: an invalidated prefetch goes
        # back so no cell is lost.
        self.config_buffer.insert(0, self._strip_budget(trial.params))

    def restore(self, finalized) -> None:
        # The grid is deterministic: drop the cells the previous run covered.
        self.config_buffer = self._drop_executed(self.config_buffer, finalized)
