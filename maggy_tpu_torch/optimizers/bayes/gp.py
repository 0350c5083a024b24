"""GP-surrogate async Bayesian optimization.

Copy of ``maggy_tpu/optimizers/bayes/gp.py`` on the port's own regressor
(``gpr.py``) in place of scikit-learn's, the warm-started-neighbor tilt of
checkpoint forking (``fork_eps``, JAX `gp.py:110-141`) included. Parity: reference
`maggy/optimizer/bayes/gp.py` — surrogate is a Gaussian process with
ConstantKernel x Matern(nu=2.5) + white noise, normalize_y (:262-287); async
strategies 'impute' (constant liar cl_min/cl_max/cl_mean or kriging believer
'kb') and 'asy_ts' (async Thompson sampling) (:110-161, :325-369); sampling
routine: evaluate the acquisition on n_points random candidates (10k
default, 100 for asy_ts), refine the best starts with L-BFGS-B over
[0,1]^d, clip and inverse-transform (:183-260).

The fit and the acquisition run on the host in numpy and scipy, as in the
JAX package: the driver's suggester thread runs them while the card trains.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.optimize import fmin_l_bfgs_b

from maggy_tpu_torch.optimizers.bayes.acquisitions import ACQUISITIONS, AsyTS
from maggy_tpu_torch.optimizers.bayes.base import BaseAsyncBO
from maggy_tpu_torch.optimizers.bayes.gpr import GaussianProcessRegressor


class GP(BaseAsyncBO):
    def __init__(self, acquisition: str = "ei", async_strategy: str = "impute",
                 impute_strategy: str = "cl_min", n_points: Optional[int] = None,
                 n_restarts_optimizer: int = 5, **kwargs):
        super().__init__(**kwargs)
        if async_strategy not in ("impute", "asy_ts"):
            raise ValueError("async_strategy must be 'impute' or 'asy_ts'")
        if impute_strategy not in ("cl_min", "cl_max", "cl_mean", "kb"):
            raise ValueError("Unknown impute_strategy {!r}".format(impute_strategy))
        self.async_strategy = async_strategy
        self.impute_strategy = impute_strategy
        if async_strategy == "asy_ts":
            self.acquisition = AsyTS(seed=kwargs.get("seed"))
            self.n_points = n_points or 100
        else:
            if acquisition not in ACQUISITIONS or acquisition == "asy_ts":
                raise ValueError("Unknown acquisition {!r}".format(acquisition))
            self.acquisition = ACQUISITIONS[acquisition]()
            self.n_points = n_points or 10000
        self.n_restarts_optimizer = n_restarts_optimizer
        #: budget -> incumbent (lowest normalized metric) the model saw
        self._y_opt = {}

    # ------------------------------------------------------------- surrogate

    def _make_gp(self) -> GaussianProcessRegressor:
        d = len(self.searchspace) + (1 if self.interim_results else 0)
        return GaussianProcessRegressor(length_scale=np.full(d, 0.3), n_restarts_optimizer=1,
                                        random_state=int(self.rng.integers(0, 2 ** 31)))

    def update_model(self, budget: float = 0) -> None:
        X, y = self.get_XY(budget=budget,
                           include_busy_locations=self.async_strategy == "impute"
                           and len(self.trial_store) > 0,
                           impute_strategy=self.impute_strategy,
                           interim=self.interim_results)
        if len(X) < 2:
            return
        self.models[budget] = self._make_gp().fit(X, y)
        self._y_opt[budget] = float(np.min(y))

    # -------------------------------------------------------------- sampling

    def sampling_routine(self, budget: float = 0) -> dict:
        model = self.models[budget]
        d = len(self.searchspace)
        y_opt = self._y_opt[budget]

        X_cand = self.rng.uniform(size=(self.n_points, d))
        # interim results: evaluate at full fidelity n = 1
        X_acq = np.hstack([X_cand, np.ones((len(X_cand), 1))]) if self.interim_results \
            else X_cand
        values = self.acquisition.evaluate(X_acq, model, y_opt)
        # Warm-neighbor discount (fork_eps): candidates near an executed
        # config are cheaper (a checkpoint fork), so tilt the lower-is-better
        # acquisition toward them, scaled by its spread so the tilt is a
        # preference, never a takeover of the ranking.
        prox = self.warm_neighbor_proximity(X_cand)
        tilt_scale = 0.0
        if prox is not None:
            v = np.asarray(values, dtype=np.float64).reshape(-1)
            spread = float(np.max(v) - np.min(v))
            if spread > 0.0:
                tilt_scale = self.fork_discount_weight() * spread
                values = (v - tilt_scale * prox).reshape(np.shape(values))
        if isinstance(self.acquisition, AsyTS):
            x_best = X_cand[int(np.argmin(values))]
        else:
            # L-BFGS-B refinement from the top starts (reference `gp.py:183-246`).
            order = np.argsort(values.reshape(-1))[: self.n_restarts_optimizer]
            x_best, f_best = X_cand[order[0]], float(values.reshape(-1)[order[0]])

            def objective(x):
                xq = np.concatenate([x, [1.0]]) if self.interim_results else x
                val = float(self.acquisition.evaluate(xq[np.newaxis, :], model, y_opt)[0])
                if tilt_scale > 0.0:
                    p = self.warm_neighbor_proximity(x[np.newaxis, :])
                    if p is not None:
                        val -= tilt_scale * float(p[0])
                return val

            for i in order:
                xo, fo, _ = fmin_l_bfgs_b(objective, X_cand[i], approx_grad=True,
                                          bounds=[(0.0, 1.0)] * d, maxfun=50)
                if fo < f_best:
                    x_best, f_best = xo, fo
        return self.searchspace.inverse_transform(np.clip(x_best, 0.0, 1.0))
