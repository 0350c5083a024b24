"""Random search over a pre-sampled buffer.

Copy of ``maggy_tpu/optimizers/randomsearch.py`` without pruner delegation
(parity: reference `maggy/optimizer/randomsearch.py:28-40,93-106`).
"""

from __future__ import annotations

from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.searchspace import Searchspace


class RandomSearch(AbstractOptimizer):
    def __init__(self, seed=None):
        super().__init__(seed=seed)
        self.config_buffer = []

    def initialize(self) -> None:
        types = set(self.searchspace._hparam_types.values())
        if not types & set(Searchspace.CONTINUOUS_TYPES):
            raise ValueError(
                "RandomSearch requires at least one continuous (DOUBLE/INTEGER) "
                "parameter; use GridSearch for purely discrete spaces."
            )
        self.config_buffer = self.searchspace.get_random_parameter_values(
            self.num_trials, rng=self.rng)

    def suggest(self):
        if not self.config_buffer:
            return None
        return self.create_trial(self.config_buffer.pop(0), sample_type="random")
