"""Gaussian-process regressor for the GP optimizer's surrogate.

The JAX package fits scikit-learn's ``GaussianProcessRegressor`` with the
kernel ``ConstantKernel * Matern(nu=2.5, ARD) + WhiteKernel`` and
``normalize_y=True`` (``maggy_tpu/optimizers/bayes/gp.py:59-71``). The
machine the port runs on has numpy and scipy but no scikit-learn, so this
module is that regressor for that one kernel, with the same semantics and
the same order of operations:

- ``alpha`` (default 1e-10) added to the training covariance's diagonal;
- ``normalize_y``: targets centred by their mean and scaled by their
  standard deviation (a deviation of exactly 0 counts as 1);
- ML-II: the log marginal likelihood maximized over the log-
  hyperparameters ``theta = [log c, log l_1..l_d, log w]`` within their
  bounds by scipy's L-BFGS-B with the exact gradient, from the initial
  ``theta`` and then from ``n_restarts_optimizer`` starts drawn
  log-uniformly within the bounds from ``np.random.RandomState(
  random_state)``; the run with the highest likelihood wins;
- ``predict(return_std=True)`` clips negative variances to 0;
  ``predict(return_cov=True)`` gives the joint covariance; ``sample_y``
  draws jointly with ``RandomState(random_state).multivariate_normal``.

It is driver-side control logic on the host (numpy float64), as the JAX
package's is: the card is left to the trials' training.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.optimize
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.spatial.distance import cdist, pdist, squareform


def kernel(theta: np.ndarray, X: np.ndarray, Y: Optional[np.ndarray] = None,
           eval_gradient: bool = False):
    """c * Matern52(X, Y; l) + w * I (the noise term only when Y is None).

    ``theta = [log c, log l_1..l_d, log w]``. With ``eval_gradient`` (Y
    None) also returns dK/dtheta, shape (n, n, d + 2)."""
    params = np.exp(theta)
    c, ls, w = params[0], params[1:-1], params[-1]
    X = np.atleast_2d(X)
    if Y is None:
        dists = pdist(X / ls, metric="euclidean")
    else:
        dists = cdist(X / ls, Y / ls, metric="euclidean")
    M = dists * math.sqrt(5)
    M = (1.0 + M + M ** 2 / 3.0) * np.exp(-M)
    if Y is None:
        M = squareform(M)
        np.fill_diagonal(M, 1)
    n, m = X.shape[0], (X if Y is None else Y).shape[0]
    K = np.full((n, m), c) * M
    if Y is not None:
        return K + np.zeros((n, m))
    K = K + w * np.eye(n)
    if not eval_gradient:
        return K
    D = (X[:, np.newaxis, :] - X[np.newaxis, :, :]) ** 2 / (ls ** 2)
    tmp = np.sqrt(5 * D.sum(-1))[..., np.newaxis]
    M_grad = 5.0 / 3.0 * D * (tmp + 1) * np.exp(-tmp)
    C = np.full((n, n), c)
    grad = np.dstack((np.dstack((np.full((n, n, 1), c) * M[:, :, np.newaxis],
                                 M_grad * C[:, :, np.newaxis])),
                      w * np.eye(n)[:, :, np.newaxis]))
    return K, grad


def kernel_diag(theta: np.ndarray, X: np.ndarray) -> np.ndarray:
    """The diagonal of ``kernel(theta, X)``: c + w."""
    n, params = np.atleast_2d(X).shape[0], np.exp(theta)
    return np.full(n, params[0]) * np.ones(n) + np.full(n, params[-1])


def log_marginal_likelihood(theta: np.ndarray, X: np.ndarray, y: np.ndarray,
                            alpha: float = 1e-10, eval_gradient: bool = False):
    """log p(y | X, theta) of the (already normalized) targets ``y``, and
    its gradient in ``theta`` when asked (Rasmussen & Williams Alg. 2.1 and
    eq. 5.9)."""
    if eval_gradient:
        K, K_gradient = kernel(theta, X, eval_gradient=True)
    else:
        K = kernel(theta, X)
    K[np.diag_indices_from(K)] += alpha
    try:
        L = cholesky(K, lower=True, check_finite=False)
    except np.linalg.LinAlgError:
        return (-np.inf, np.zeros_like(theta)) if eval_gradient else -np.inf
    y_train = y[:, np.newaxis] if y.ndim == 1 else y
    a = cho_solve((L, True), y_train, check_finite=False)
    lml = -0.5 * np.einsum("ik,ik->k", y_train, a)
    lml -= np.log(np.diag(L)).sum()
    lml -= K.shape[0] / 2 * np.log(2 * np.pi)
    lml = lml.sum(axis=-1)
    if not eval_gradient:
        return lml
    inner = np.einsum("ik,jk->ijk", a, a)
    K_inv = cho_solve((L, True), np.eye(K.shape[0]), check_finite=False)
    inner -= K_inv[..., np.newaxis]
    grad = 0.5 * np.einsum("ijl,jik->kl", inner, K_gradient)
    return lml, grad.sum(axis=-1)


class GaussianProcessRegressor:
    """GP regression with c * Matern52(ARD) + white noise, fit by ML-II."""

    def __init__(self, length_scale: Sequence[float], constant: float = 1.0,
                 constant_bounds: Tuple[float, float] = (0.01, 100.0),
                 length_scale_bounds: Tuple[float, float] = (0.01, 10.0),
                 noise: float = 1e-4, noise_bounds: Tuple[float, float] = (1e-8, 1e-1),
                 alpha: float = 1e-10, n_restarts_optimizer: int = 1,
                 random_state: Optional[int] = None, optimize: bool = True):
        ls = np.atleast_1d(np.asarray(length_scale, dtype=np.float64))
        self.theta = np.log(np.concatenate([[constant], ls, [noise]]))
        self.bounds = np.log(np.asarray([constant_bounds] + [length_scale_bounds] * len(ls)
                                        + [noise_bounds], dtype=np.float64))
        self.alpha = alpha
        self.n_restarts_optimizer = n_restarts_optimizer
        self.random_state = random_state
        self.optimize = optimize

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GaussianProcessRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.RandomState(self.random_state)
        self.y_mean = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        self.y_std = 1.0 if std == 0.0 else std
        y = (y - self.y_mean) / self.y_std
        self.X_train, self.y_train = np.copy(X), np.copy(y)
        if self.optimize:
            def neg_lml(theta):
                lml, grad = log_marginal_likelihood(theta, X, y, self.alpha, True)
                return -lml, -grad

            starts = [self.theta] + [rng.uniform(self.bounds[:, 0], self.bounds[:, 1])
                                     for _ in range(self.n_restarts_optimizer)]
            optima = []
            for theta0 in starts:
                res = scipy.optimize.minimize(neg_lml, theta0, method="L-BFGS-B",
                                              jac=True, bounds=self.bounds)
                optima.append((res.x, res.fun))
            self.theta = optima[int(np.argmin([f for _, f in optima]))][0]
        K = kernel(self.theta, X)
        K[np.diag_indices_from(K)] += self.alpha
        self.L = cholesky(K, lower=True, check_finite=False)
        self.dual_coef = cho_solve((self.L, True), self.y_train, check_finite=False)
        return self

    def predict(self, X: np.ndarray, return_std: bool = False, return_cov: bool = False):
        """Posterior mean at X, with its standard deviation or the joint
        covariance (in the original target units)."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        K_trans = kernel(self.theta, X, self.X_train)
        mean = self.y_std * (K_trans @ self.dual_coef) + self.y_mean
        if not (return_std or return_cov):
            return mean
        V = solve_triangular(self.L, K_trans.T, lower=True, check_finite=False)
        if return_cov:
            cov = kernel(self.theta, X) - V.T @ V
            return mean, cov * self.y_std ** 2
        var = kernel_diag(self.theta, X).copy()
        var -= np.einsum("ij,ji->i", V.T, V)
        var[var < 0] = 0.0
        return mean, np.sqrt(var * self.y_std ** 2)

    def sample_y(self, X: np.ndarray, n_samples: int = 1, random_state: int = 0) -> np.ndarray:
        """Joint posterior draws at X, shape (len(X), n_samples)."""
        mean, cov = self.predict(X, return_cov=True)
        return np.random.RandomState(random_state).multivariate_normal(mean, cov, n_samples).T
