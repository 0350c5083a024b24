"""Tree-structured Parzen Estimator (BOHB/HpBandSter-style).

Copy of ``maggy_tpu/optimizers/bayes/tpe.py``, the warm-started-neighbor
discount of checkpoint forking (``fork_eps``, JAX `tpe.py:111-122`)
included. Given the same seed and the same observations it proposes the
same configs. Parity: reference
`maggy/optimizer/bayes/tpe.py` — γ=0.15 good/bad split with n_good/n_bad
floors of d+1 (:191-221), two mixed-type KDEs with var_type c/u per hparam
(:180-189, :223-251), candidate sampling: 24 draws around random good-KDE
datapoints via truncated normals (bandwidth clipped to 1e-3, scaled by
bw_factor=3) for continuous dims and bandwidth-probability resampling for
categorical dims (:75-119), EI = max(good.pdf, 1e-32) / max(bad.pdf, 1e-32)
maximized over candidates (:253-266), interim-results mode rejected
(:62-66).

statsmodels is unavailable; the KDE is a from-scratch implementation of the
same two kernels in `kde.py`.
"""

from __future__ import annotations

import numpy as np

from maggy_tpu_torch.optimizers.bayes.base import BaseAsyncBO
from maggy_tpu_torch.optimizers.bayes.kde import MixedKDE
from maggy_tpu_torch.searchspace import Searchspace


class TPE(BaseAsyncBO):
    def __init__(
        self,
        gamma: float = 0.15,
        num_samples: int = 24,
        bw_factor: float = 3.0,
        **kwargs,
    ):
        if kwargs.get("interim_results"):
            raise ValueError("TPE does not support interim_results.")
        super().__init__(**kwargs)
        self.gamma = gamma
        self.num_samples = num_samples
        self.bw_factor = bw_factor

    # --------------------------------------------------------------- helpers

    def _encode(self, params_list):
        """Encode params: continuous dims via the unit-cube codec, categorical
        dims as integer category indices (what the AA kernel expects)."""
        sp = self.searchspace
        rows = []
        for params in params_list:
            row = []
            for name, hp_type in sp._hparam_types.items():
                region = sp._hparams[name]
                v = params[name]
                if hp_type in Searchspace.CONTINUOUS_TYPES:
                    row.append(sp.encode_continuous(name, v))
                else:
                    row.append(float(region.index(v)))
            rows.append(row)
        return np.asarray(rows, dtype=np.float64)

    def _decode(self, x: np.ndarray) -> dict:
        sp = self.searchspace
        params = {}
        for j, (name, hp_type) in enumerate(sp._hparam_types.items()):
            region = sp._hparams[name]
            if hp_type in Searchspace.CONTINUOUS_TYPES:
                params[name] = sp.decode_continuous(name, x[j])
            else:
                params[name] = region[int(np.clip(x[j], 0, len(region) - 1))]
        return params

    def _n_categories(self):
        sp = self.searchspace
        return [
            len(sp._hparams[name])
            if t in (Searchspace.DISCRETE, Searchspace.CATEGORICAL) else 0
            for name, t in sp._hparam_types.items()
        ]

    # -------------------------------------------------------------- contract

    def update_model(self, budget: float = 0) -> None:
        trials = self._finalized(budget if budget else None)
        d = len(self.searchspace)
        if len(trials) < 2 * (d + 1):
            self.models.pop(budget, None)
            return
        sign = self._sign()
        y = np.asarray([sign * t.final_metric for t in trials])
        order = np.argsort(y)  # ascending: best first
        n_good = max(d + 1, int(np.ceil(self.gamma * len(trials))))
        n_bad = max(d + 1, len(trials) - n_good)
        X = self._encode([self._strip_budget(t.params) for t in trials])
        var_types = self.searchspace.var_types()
        ncat = self._n_categories()
        good = MixedKDE(X[order[:n_good]], var_types, ncat)
        bad = MixedKDE(X[order[-n_bad:]], var_types, ncat)
        self.models[budget] = {"good": good, "bad": bad}

    def sampling_routine(self, budget: float = 0) -> dict:
        kdes = self.models[budget]
        good, bad = kdes["good"], kdes["bad"]
        best_x, best_ei = None, -np.inf
        weight = self.fork_discount_weight()
        for _ in range(self.num_samples):
            idx = int(self.rng.integers(0, good.n))
            x = good.sample_around(self.rng, idx, bw_factor=self.bw_factor)
            ei = max(good.pdf(x[np.newaxis, :])[0], 1e-32) / max(
                bad.pdf(x[np.newaxis, :])[0], 1e-32
            )
            # Warm-neighbor discount (fork_eps): the l/g ratio is higher-is-
            # better, so a candidate near an executed config (a checkpoint
            # fork, or a fork lane in the parent's block) gets a
            # multiplicative boost. Proximity is measured in the
            # searchspace's normalized transform, not the KDE's encoding.
            prox = None
            if weight > 0 and self.fork_eps is not None:
                prox = self.warm_neighbor_proximity(self.searchspace.transform(self._decode(x)))
            if prox is not None and prox[0] > 0:
                ei *= 1.0 + weight * float(prox[0])
            if ei > best_ei:
                best_x, best_ei = x, ei
        return self._decode(best_x)
