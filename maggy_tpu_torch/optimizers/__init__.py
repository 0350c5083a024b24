"""Driver-side search/scheduling algorithm plugins."""

from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.optimizers.asha import Asha
from maggy_tpu_torch.optimizers.randomsearch import RandomSearch

__all__ = ["AbstractOptimizer", "Asha", "RandomSearch"]
