"""Acquisition functions for GP-based async Bayesian optimization.

Copy of ``maggy_tpu/optimizers/bayes/acquisitions.py``; ``model`` is the
port's regressor (``gpr.GaussianProcessRegressor``), which has the same
``predict``/``sample_y`` as scikit-learn's. Parity: reference
`maggy/optimizer/bayes/acquisitions.py` — strategy objects with `evaluate(X,
model, y_opt)` and an lbfgs-compatible value+gradient form (:25-62);
EI/PI/LCB (:68-135) and async Thompson sampling (:158-179). The reference
wraps skopt's `_gaussian_acquisition`; these are direct closed-form
implementations (all convention: LOWER metric is better, acquisitions are
MINIMIZED).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm


class AbstractAcquisition:
    def evaluate(self, X: np.ndarray, model, y_opt: float) -> np.ndarray:
        """Return acquisition values at X (lower = more desirable)."""
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


class GaussianProcess_EI(AbstractAcquisition):
    """Negative expected improvement below the incumbent y_opt."""

    def __init__(self, xi: float = 0.01):
        self.xi = xi

    def evaluate(self, X, model, y_opt):
        mu, std = model.predict(np.atleast_2d(X), return_std=True)
        std = np.maximum(std, 1e-12)
        imp = y_opt - self.xi - mu
        z = imp / std
        ei = imp * norm.cdf(z) + std * norm.pdf(z)
        return -ei


class GaussianProcess_PI(AbstractAcquisition):
    """Negative probability of improvement."""

    def __init__(self, xi: float = 0.01):
        self.xi = xi

    def evaluate(self, X, model, y_opt):
        mu, std = model.predict(np.atleast_2d(X), return_std=True)
        std = np.maximum(std, 1e-12)
        return -norm.cdf((y_opt - self.xi - mu) / std)


class GaussianProcess_LCB(AbstractAcquisition):
    """Lower confidence bound mu - kappa * sigma (already a minimization)."""

    def __init__(self, kappa: float = 1.96):
        self.kappa = kappa

    def evaluate(self, X, model, y_opt):
        mu, std = model.predict(np.atleast_2d(X), return_std=True)
        return mu - self.kappa * std


class AsyTS(AbstractAcquisition):
    """Async Thompson sampling: one joint posterior draw over the candidate
    set; the argmin of the sample is the proposal (reference
    `acquisitions.py:158-179`)."""

    def __init__(self, seed=None):
        self.rng = np.random.default_rng(seed)

    def evaluate(self, X, model, y_opt):
        sample = model.sample_y(np.atleast_2d(X),
                                random_state=int(self.rng.integers(0, 2 ** 31)))
        return sample.reshape(X.shape[0] if X.ndim > 1 else 1, -1)[:, 0]


ACQUISITIONS = {
    "ei": GaussianProcess_EI,
    "pi": GaussianProcess_PI,
    "lcb": GaussianProcess_LCB,
    "asy_ts": AsyTS,
}
