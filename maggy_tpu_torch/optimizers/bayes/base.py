"""Asynchronous Bayesian optimization skeleton.

Copy of ``maggy_tpu/optimizers/bayes/base.py``, with its resume
(``restore``: the warmup buffer drops executed configs; the surrogate
refits on the restored final_store) and its checkpoint-forking
near-duplicate warm start (``fork_eps``, JAX `base.py:39-58, 160-230`): a
model proposal within ``fork_eps`` of a finalized config takes that trial
as its fork ``parent``, and the warm-neighbor proximity that TPE and GP
fold into their acquisitions. Parity: reference `maggy/optimizer/bayes/base.py` — warmup
buffer (:358-373), ε-random exploration with random_fraction=0.33
(:239-245), per-budget surrogate `models` dict with key 0 = single-fidelity
(:135-139), pruner delegation identical to RandomSearch (:187-226),
duplicate rejection ending the experiment after 4 forced-random collisions
(:285-298), finished check (:375-395), busy locations with imputed metrics
for in-flight trials (:397-454), `get_XY` with optional interim results
where configs are augmented with a normalized fidelity coordinate
z=[x, n] (:456-638).

The surrogate is driver-side control logic and runs on the host in numpy
and scipy, as in the JAX package; the card stays with the trials' training.

Subclasses implement ``update_model(budget)`` and
``sampling_routine(budget) -> params_dict``.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Dict, List, Optional

import numpy as np

from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.trial import Trial


class BaseAsyncBO(AbstractOptimizer):
    #: A GP/TPE fit takes long enough that the driver must never run
    #: suggest() inline on the RPC dispatch thread.
    SUGGEST_COST = "expensive"

    def __init__(self, num_warmup_trials: int = 15, random_fraction: float = 0.33,
                 interim_results: bool = False, interim_results_interval: int = 10,
                 fork_eps: Optional[float] = None, seed=None, pruner=None,
                 pruner_kwargs=None):
        super().__init__(seed=seed, pruner=pruner, pruner_kwargs=pruner_kwargs)
        self.num_warmup_trials = num_warmup_trials
        self.random_fraction = random_fraction
        self.interim_results = interim_results
        self.interim_results_interval = interim_results_interval
        #: Near-duplicate warm start (config.fork): a MODEL-proposed config
        #: within ``fork_eps`` (L2 in the searchspace's normalized transform)
        #: of a finalized config takes that trial as its ``parent``, so the
        #: driver forks the neighbor's checkpoint. None (default) = off.
        self.fork_eps = fork_eps
        self.warmup_buffer: List[dict] = []
        #: budget -> fitted surrogate (0 = single fidelity), set by update_model
        self.models: Dict[float, object] = {}
        #: trial_id -> imputed metric for busy locations (diagnostics)
        self.imputed_metrics: Dict[str, float] = {}
        self._forced_random_failures = 0

    # ------------------------------------------------------------- contract

    @abstractmethod
    def update_model(self, budget: float = 0) -> None:
        """(Re)fit the surrogate for ``budget`` from current observations."""

    @abstractmethod
    def sampling_routine(self, budget: float = 0) -> dict:
        """Propose the next hyperparameter dict by optimizing the surrogate."""

    # ----------------------------------------------------------- main logic

    def initialize(self) -> None:
        n = min(self.num_warmup_trials, self.num_trials) if self.pruner is None \
            else self.num_warmup_trials
        self.warmup_buffer = self.searchspace.get_random_parameter_values(n, rng=self.rng)

    def suggest(self):
        # report() is a no-op: the surrogate trains on final_store and the
        # in-flight configs come from trial_store, which holds prefetched
        # trials too, so a suggestion made ahead of time is imputed as a
        # busy location like a dispatched one.
        if self._experiment_finished():
            return None
        budget = 0
        if self.pruner is None:
            # In-flight trials count against the budget, else N concurrent
            # runners overshoot num_trials by up to N-1.
            if len(self.final_store) + len(self.trial_store) >= self.num_trials:
                return "IDLE" if self.trial_store else None
        else:
            next_run = self.pruner.pruning_routine()
            if next_run in (None, "IDLE"):
                return next_run
            parent_id, budget = next_run["trial_id"], next_run["budget"]
            if parent_id is not None:
                # Promotion: re-run the parent's config at the new budget.
                params = self._strip_budget(self._lookup_params(parent_id))
                new_trial = self.create_trial(params, sample_type="promoted",
                                              run_budget=budget, parent=parent_id)
                self.pruner.report_trial(parent_id, new_trial.trial_id)
                return new_trial

        new_trial = self._propose(budget)
        if new_trial is None:
            return None
        if self.pruner is not None:
            self.pruner.report_trial(None, new_trial.trial_id)
        return new_trial

    def restore(self, finalized) -> None:
        # final_store (already refilled by the driver) is the surrogate's
        # training data, refitted on the next model proposal; only the
        # warmup buffer needs dedup (resume requires a fixed seed, so the
        # rerun presamples the same warmup configs).
        self.warmup_buffer = self._drop_executed(self.warmup_buffer, finalized)

    def _propose(self, budget: float) -> Optional[Trial]:
        # 1. warmup buffer
        if self.warmup_buffer:
            return self.create_trial(self.warmup_buffer.pop(0), sample_type="random",
                                     run_budget=budget)
        # 2. ε-random exploration / not enough data for a model
        model_budget = self._model_budget(budget)
        have_data = len(self._finalized(model_budget if model_budget else None)) >= max(
            3, len(self.searchspace) + 1)
        trial = None
        if self.rng.random() >= self.random_fraction and have_data:
            self.update_model(model_budget)
            if self.models.get(model_budget) is not None:
                params = self.sampling_routine(model_budget)
                trial = self.create_trial(params, sample_type="model", run_budget=budget,
                                          model_budget=model_budget)
        if trial is None:
            params = self.searchspace.get_random_parameter_values(1, rng=self.rng)[0]
            trial = self.create_trial(params, sample_type="random", run_budget=budget)
        # 3. duplicate rejection: up to 4 forced-random retries (reference
        #    `base.py:285-298`).
        retries = 0
        while self.hparams_exist(trial) and retries < 4:
            retries += 1
            params = self.searchspace.get_random_parameter_values(1, rng=self.rng)[0]
            trial = self.create_trial(params, sample_type="random_forced", run_budget=budget)
        if self.hparams_exist(trial):
            self._forced_random_failures += 1
            return None
        # Near-duplicate warm start (fork_eps): a model proposal next to an
        # executed config inherits its checkpoint as a fork parent. Model
        # proposals only: random samples are exploration.
        if self.fork_eps is not None and trial.info_dict.get("sample_type") == "model":
            donor = self._near_duplicate(trial)
            if donor is not None:
                trial.info_dict["parent"] = donor
                trial.info_dict["near_duplicate"] = True
        return trial

    #: Weight of the warm-neighbor acquisition discount: a candidate near an
    #: executed config is favored because it is cheaper to evaluate (it
    #: forks the neighbor's checkpoint), not better. The port has no
    #: vectorized lanes (ROADMAP queue 1 item 7), so every fork is a scalar
    #: checkpoint fork, which gets half this weight (JAX `base.py:199-206`).
    FORK_DISCOUNT = 0.25

    def warm_neighbor_proximity(self, X_cand) -> Optional[np.ndarray]:
        """Per-candidate proximity in [0, 1] to the nearest finalized config,
        linear within ``fork_eps`` of the normalized transform (1 = an exact
        re-run, 0 = at or beyond the fork radius). None when the discount is
        inactive (``fork_eps`` unset, or nothing finalized yet)."""
        if self.fork_eps is None or not np.isfinite(float(self.fork_eps)) \
                or float(self.fork_eps) <= 0:
            return None
        finalized = self._finalized()
        if not finalized:
            return None
        X = np.asarray(self.searchspace.transform_batch(
            [self._strip_budget(t.params) for t in finalized]), dtype=np.float64)
        Xc = np.asarray(X_cand, dtype=np.float64)
        if Xc.ndim == 1:
            Xc = Xc[np.newaxis, :]
        d = np.sqrt(((Xc[:, None, :] - X[None, :, :]) ** 2).sum(axis=2)).min(axis=1)
        return np.clip(1.0 - d / float(self.fork_eps), 0.0, 1.0)

    def fork_discount_weight(self) -> float:
        """The discount weight of a scalar checkpoint fork."""
        return self.FORK_DISCOUNT * 0.5

    def _near_duplicate(self, trial: Trial) -> Optional[str]:
        """The nearest finalized trial within ``fork_eps``, or None."""
        finalized = self._finalized()
        if not finalized:
            return None
        X = self.searchspace.transform_batch([self._strip_budget(t.params) for t in finalized])
        x = self.searchspace.transform_batch([self._strip_budget(trial.params)])[0]
        d = np.linalg.norm(np.asarray(X) - np.asarray(x), axis=1)
        i = int(np.argmin(d))
        if float(d[i]) <= float(self.fork_eps):
            return finalized[i].trial_id
        return None

    def _model_budget(self, run_budget: float) -> float:
        """Which surrogate to use for a run budget: the largest budget with
        enough observations, else the run budget itself."""
        if self.pruner is None:
            return 0
        for b in sorted({t.params.get("budget", 0) for t in self.final_store}, reverse=True):
            if len(self._finalized(b)) >= max(3, len(self.searchspace) + 1):
                return b
        return run_budget

    def _experiment_finished(self) -> bool:
        if self.pruner is not None:
            return self.pruner.finished()
        return len(self.final_store) >= self.num_trials

    # ------------------------------------------------- training-matrix build

    def busy_locations(self, budget: float = 0) -> List[tuple]:
        """(trial_id, config) of in-flight trials at this budget."""
        return [(t.trial_id, self._strip_budget(t.params)) for t in self.trial_store.values()
                if budget in (0, t.params.get("budget", 0))]

    def get_XY(self, budget: float = 0, include_busy_locations: bool = False,
               impute_strategy: str = "cl_min", interim: bool = False):
        """Build (X, y) for surrogate training (reference `base.py:456-638`).

        - metrics are direction-normalized (lower better)
        - ``include_busy_locations``: append in-flight configs with an imputed
          metric — constant liar cl_min/cl_max/cl_mean, or 'kb' (kriging
          believer: posterior mean of the current model)
        - ``interim``: one row per interim observation, config augmented with
          a normalized fidelity coordinate n ∈ (0, 1]
        """
        trials = self._finalized(budget if budget else None)
        sign = self._sign()
        if not interim:
            X = self.searchspace.transform_batch([self._strip_budget(t.params) for t in trials])
            y = np.asarray([sign * t.final_metric for t in trials], dtype=np.float64)
        else:
            rows, ys = [], []
            for t in trials:
                hist = t.metric_history
                if not hist:
                    continue
                x = self.searchspace.transform(self._strip_budget(t.params))
                steps = list(range(0, len(hist), self.interim_results_interval))
                if (len(hist) - 1) not in steps:
                    steps.append(len(hist) - 1)
                for s in steps:
                    rows.append(np.concatenate([x, [(s + 1) / len(hist)]]))
                    ys.append(sign * hist[s])
            X = np.asarray(rows) if rows else np.zeros((0, len(self.searchspace) + 1))
            y = np.asarray(ys, dtype=np.float64)

        if include_busy_locations and not interim:
            busy = self.busy_locations(budget)
            if busy:
                Xb = self.searchspace.transform_batch([cfg for _, cfg in busy])
                yb = self._impute(Xb, y, impute_strategy, budget)
                for (tid, _), m in zip(busy, yb):
                    self.imputed_metrics[tid] = float(m)
                X = np.vstack([X, Xb]) if X.size else Xb
                y = np.concatenate([y, yb])
        return X, y

    def _impute(self, Xb: np.ndarray, y_obs: np.ndarray, strategy: str, budget: float):
        if y_obs.size == 0:
            return np.zeros(len(Xb))
        if strategy == "cl_min":
            return np.full(len(Xb), float(np.min(y_obs)))
        if strategy == "cl_max":
            return np.full(len(Xb), float(np.max(y_obs)))
        if strategy == "cl_mean":
            return np.full(len(Xb), float(np.mean(y_obs)))
        if strategy == "kb":
            model = self.models.get(budget)
            if model is None:
                return np.full(len(Xb), float(np.mean(y_obs)))
            return np.asarray(model.predict(Xb)).reshape(-1)
        raise ValueError("Unknown impute strategy {!r}".format(strategy))
