"""Random search, with optional multi-fidelity pruning.

Copy of ``maggy_tpu/optimizers/randomsearch.py`` without resume (parity:
reference `maggy/optimizer/randomsearch.py` — pre-sampled buffer (:28-40),
continuous-param requirement (:30-36), pruner delegation handling
IDLE/None/promoted/fresh (:47-90), plain buffer pop otherwise (:93-106)).
"""

from __future__ import annotations

from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial


class RandomSearch(AbstractOptimizer):
    def __init__(self, seed=None, pruner=None, pruner_kwargs=None):
        super().__init__(seed=seed, pruner=pruner, pruner_kwargs=pruner_kwargs)
        self.config_buffer = []

    def initialize(self) -> None:
        types = set(self.searchspace._hparam_types.values())
        if not types & set(Searchspace.CONTINUOUS_TYPES):
            raise ValueError(
                "RandomSearch requires at least one continuous (DOUBLE/INTEGER) "
                "parameter; use GridSearch for purely discrete spaces."
            )
        if self.pruner is None:
            self.config_buffer = self.searchspace.get_random_parameter_values(
                self.num_trials, rng=self.rng)

    def suggest(self):
        # report() is a no-op: the schedule is a pre-sampled buffer (or
        # pruner-delegated), so suggestions may be prefetched ahead.
        if self.pruner is not None:
            return self._pruner_suggestion()
        if not self.config_buffer:
            return None
        return self.create_trial(self.config_buffer.pop(0), sample_type="random")

    def recycle(self, trial: Trial) -> None:
        # The non-pruner schedule is exactly num_trials buffer entries; the
        # pruner path never invalidates (report is a no-op).
        if self.pruner is None:
            self.config_buffer.insert(0, self._strip_budget(trial.params))

    def _pruner_suggestion(self):
        """Delegate budget/promotion decisions to the pruner (reference
        `randomsearch.py:47-90`)."""
        next_run = self.pruner.pruning_routine()
        if next_run in (None, "IDLE"):
            return next_run
        parent_id, budget = next_run["trial_id"], next_run["budget"]
        if parent_id is None:
            params = self.searchspace.get_random_parameter_values(1, rng=self.rng)[0]
            for _ in range(32):
                if not self.hparams_exist(Trial(dict(params))):
                    break
                params = self.searchspace.get_random_parameter_values(1, rng=self.rng)[0]
            new_trial = self.create_trial(params, sample_type="random", run_budget=budget)
        else:
            params = self._strip_budget(self._lookup_params(parent_id))
            new_trial = self.create_trial(params, sample_type="promoted",
                                          run_budget=budget, parent=parent_id)
        self.pruner.report_trial(original_trial_id=parent_id, new_trial_id=new_trial.trial_id)
        return new_trial
