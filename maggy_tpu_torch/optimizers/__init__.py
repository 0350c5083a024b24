"""Driver-side search/scheduling algorithm plugins. The Bayesian optimizers
live in ``optimizers.bayes`` (imported on demand: they pull scipy)."""

from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.optimizers.asha import Asha
from maggy_tpu_torch.optimizers.gridsearch import GridSearch
from maggy_tpu_torch.optimizers.randomsearch import RandomSearch
from maggy_tpu_torch.optimizers.singlerun import SingleRun

__all__ = ["AbstractOptimizer", "Asha", "GridSearch", "RandomSearch", "SingleRun"]
