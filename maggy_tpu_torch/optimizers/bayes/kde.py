"""Mixed-type multivariate kernel density estimation.

Copy of ``maggy_tpu/optimizers/bayes/kde.py``. The reference delegates to
``statsmodels.nonparametric.KDEMultivariate`` (`tpe.py:223-251`) with
var_type 'c' (continuous, Gaussian kernel) and 'u' (unordered categorical,
Aitchison-Aitken kernel). statsmodels is not a dependency, so this is
a from-scratch implementation of exactly the two kernels TPE needs, with
normal-reference-rule bandwidths.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def normal_reference_bw(x: np.ndarray) -> float:
    """Silverman's normal-reference rule for a 1-d continuous sample."""
    n = len(x)
    if n < 2:
        return 1.0
    sigma = np.std(x, ddof=1)
    iqr = np.subtract(*np.percentile(x, [75, 25])) / 1.349
    spread = min(sigma, iqr) if iqr > 0 else sigma
    if spread <= 0:
        spread = max(np.abs(x).max(), 1.0) * 0.1
    return 1.06 * spread * n ** (-1.0 / 5.0)


class MixedKDE:
    """KDE over vectors with continuous ('c') and categorical ('u') dims.

    Continuous dims use Gaussian kernels; categorical dims (encoded as
    integer category indices) use the Aitchison-Aitken kernel
    ``K(x, xi) = 1 - lam + lam/c`` if x == xi else ``lam/c`` — matching
    statsmodels' behavior the reference relies on.
    """

    def __init__(self, data: np.ndarray, var_types: Sequence[str],
                 n_categories: Sequence[int] | None = None):
        self.data = np.atleast_2d(np.asarray(data, dtype=np.float64))
        self.var_types = list(var_types)
        assert self.data.shape[1] == len(self.var_types)
        self.n, self.d = self.data.shape
        self.n_categories = list(n_categories) if n_categories is not None else [
            int(self.data[:, j].max()) + 1 if t == "u" else 0
            for j, t in enumerate(self.var_types)
        ]
        self.bw = np.empty(self.d)
        for j, t in enumerate(self.var_types):
            if t == "c":
                self.bw[j] = max(normal_reference_bw(self.data[:, j]), 1e-3)
            else:
                # Aitchison-Aitken lambda in [0, (c-1)/c]; normal-reference-
                # style shrink with n.
                c = max(self.n_categories[j], 2)
                lam = min((c - 1) / c, 0.5 * self.n ** (-2.0 / (self.d + 4)) + 0.1)
                self.bw[j] = lam

    def pdf(self, X: np.ndarray) -> np.ndarray:
        """Density at each row of X, shape (m,)."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        m = X.shape[0]
        # (m, n) product of per-dim kernels
        logk = np.zeros((m, self.n))
        for j, t in enumerate(self.var_types):
            diff = X[:, j:j + 1] - self.data[np.newaxis, :, j]
            if t == "c":
                h = self.bw[j]
                logk += -0.5 * (diff / h) ** 2 - np.log(h * np.sqrt(2 * np.pi))
            else:
                lam = self.bw[j]
                c = max(self.n_categories[j], 2)
                same = np.isclose(diff, 0.0)
                k = np.where(same, 1.0 - lam + lam / c, lam / c)
                logk += np.log(k)
        # logsumexp over data points
        mx = logk.max(axis=1, keepdims=True)
        return np.exp(mx.squeeze(1) + np.log(np.exp(logk - mx).sum(axis=1))) / self.n

    def sample_around(self, rng: np.random.Generator, idx: int,
                      bw_factor: float = 1.0) -> np.ndarray:
        """Draw one candidate around data point ``idx`` (TPE's proposal move,
        reference `tpe.py:75-119`): truncated-normal-like draw for continuous
        dims, bandwidth-probability resample for categorical dims."""
        x = np.empty(self.d)
        base = self.data[idx]
        for j, t in enumerate(self.var_types):
            if t == "c":
                h = self.bw[j] * bw_factor
                # rejection-free truncation to [0, 1] (codec range)
                for _ in range(16):
                    v = rng.normal(base[j], h)
                    if 0.0 <= v <= 1.0:
                        break
                x[j] = np.clip(v, 0.0, 1.0)
            else:
                lam = self.bw[j]
                c = max(self.n_categories[j], 2)
                if rng.random() < 1.0 - lam + lam / c:
                    x[j] = base[j]
                else:
                    x[j] = float(rng.integers(0, c))
        return x
