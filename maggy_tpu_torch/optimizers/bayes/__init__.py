"""Asynchronous Bayesian optimization: TPE and GP (numpy and scipy on the
host; no scikit-learn)."""

from maggy_tpu_torch.optimizers.bayes.base import BaseAsyncBO
from maggy_tpu_torch.optimizers.bayes.gp import GP
from maggy_tpu_torch.optimizers.bayes.tpe import TPE

__all__ = ["BaseAsyncBO", "GP", "TPE"]
