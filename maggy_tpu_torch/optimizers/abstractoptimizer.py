"""Abstract optimizer: the driver-side search-algorithm plugin contract.

Copy of ``maggy_tpu/optimizers/abstractoptimizer.py``, with its
resume/restore contract (``restore``, ``restore_from_finals``). Parity: reference
`maggy/optimizer/abstractoptimizer.py` — contract at :54-79;
driver-injected attributes at :36-40; observation getters with direction
normalization at :136-252; duplicate detection at :254-295; pruner init at
:297-315; trial factory with budget injection at :317-376; ybest/yworst/
ymean at :378-443.

All optimizers take an optional ``seed`` and draw from their own
``numpy.random.Generator`` — reproducible schedules.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Union

import numpy as np

from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial


class AbstractOptimizer(ABC):
    #: Cost class of one ``suggest()`` call: "cheap" (dict ops — the driver
    #: may run it inline on the RPC dispatch thread to piggyback a reply)
    #: or "expensive" (model fit — never on the RPC thread).
    SUGGEST_COST = "cheap"

    def __init__(self, seed: Optional[int] = None, pruner=None, pruner_kwargs=None):
        # Neither suggest() nor get_suggestion() can be abstract (each has a
        # default in terms of the other side of the split), so a subclass
        # with neither fails here rather than mid-experiment.
        cls = type(self)
        if cls.get_suggestion is AbstractOptimizer.get_suggestion and \
                cls.suggest is AbstractOptimizer.suggest:
            raise TypeError(
                "{} must implement suggest() (and optionally report()/"
                "recycle()), or override get_suggestion() wholesale".format(
                    cls.__name__))
        # Injected by the driver after construction (reference
        # `optimization_driver.py:87-93`).
        self.searchspace: Optional[Searchspace] = None
        self.num_trials: int = 0
        self.trial_store: Dict[str, Trial] = {}
        self.final_store: List[Trial] = []
        self.direction: str = "max"
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        #: Bumped by ``report`` whenever a FINAL changes the upcoming
        #: schedule (promotion available, experiment done). The driver
        #: stamps prefetched suggestions with the version at suggest time
        #: and refuses to dispatch a stale one.
        self.schedule_version = 0
        self.pruner = None
        self._pruner_name = pruner
        self._pruner_kwargs = pruner_kwargs or {}

    # ------------------------------------------------------------- contract
    #
    # The contract is split so the driver can pipeline trial hand-offs:
    # ``report(trial)`` ingests a just-finalized trial on the FINAL path
    # before the freed runner is handed new work (cheap, dict ops);
    # ``suggest()`` proposes the next Trial, "IDLE" (ask again later) or
    # None (no more work) and may run ahead of FINALs on the driver's
    # suggester thread; ``recycle(trial)`` takes back a prefetched
    # suggestion the driver invalidated before dispatch. ``get_suggestion``
    # is the single-call form; overriding it wholesale opts out of
    # prefetching.

    @abstractmethod
    def initialize(self) -> None:
        """Called once by the driver before any suggestions are requested."""

    def report(self, trial: Trial) -> None:
        """Ingest a finalized (or errored) trial. Implementations that
        change the upcoming schedule must bump ``schedule_version``."""

    def suggest(self):
        """Return the next Trial, "IDLE", or None. The driver serializes
        all calls."""
        raise NotImplementedError

    def recycle(self, trial: Trial) -> None:
        """Take back a prefetched suggestion the driver invalidated before
        dispatch. Default: drop it (samplers re-draw); buffer-backed
        controllers re-queue the config."""

    def get_suggestion(self, trial: Optional[Trial] = None):
        """Report the just-finalized ``trial`` (if any), then suggest."""
        if trial is not None:
            self.report(trial)
        return self.suggest()

    def supports_prefetch(self) -> bool:
        """True when this controller implements the split contract (the
        default ``get_suggestion`` is untouched)."""
        return type(self).get_suggestion is AbstractOptimizer.get_suggestion \
            and type(self).suggest is not AbstractOptimizer.suggest

    def fork_gc_eligible(self) -> List[str]:
        """Checkpoint GC (config.fork): ids of trials whose checkpoints no
        live or schedulable child can still fork from; the driver retires
        their ``checkpoints/`` dirs. Must be conservative. Default: nothing
        is ever eligible (a controller that forks says which parents are
        spent)."""
        return []

    def finalize_experiment(self, trials: List[Trial]) -> None:
        """Called once after the experiment completes."""

    def restore(self, finalized: List[Trial]) -> None:
        """Rebuild schedule state from a previous run's finalized trials
        (experiment resume). The driver has already filled final_store;
        subclasses drop executed configs from their sampling buffers or
        rebuild their bookkeeping. Default: final_store alone."""

    def restore_from_finals(self, finalized: List[Trial],
                            inflight: List[Trial] = ()) -> None:
        """Crash-only recovery: ``restore`` over the finalized and the
        in-flight trials (the driver rebuilt the in-flight ones, so a
        buffer-backed sampler must not suggest them again), then ``report``
        each finalized trial in completion order, the bookkeeping the live
        FINAL path would have done. Prefetched suggestions died with the
        crashed process uncommitted and are simply derived again.
        Controllers whose ``restore`` rebuilds the ledgers ``report`` writes
        (ASHA rungs, PBT chains) override this (JAX
        `abstractoptimizer.py:143-175`)."""
        self.restore(list(finalized) + list(inflight))
        for trial in finalized:
            self.report(trial)

    @staticmethod
    def _drop_executed(buffer: List[dict], finalized: List[Trial]) -> List[dict]:
        """The configs of ``buffer`` the previous run did not execute (trial
        ids are content hashes of the params)."""
        done = {t.trial_id for t in finalized}
        return [c for c in buffer if Trial._compute_id(dict(c), "optimization") not in done]

    # ------------------------------------------------------------- plumbing

    def _initialize(self) -> None:
        """Driver-side init hook: sets up the pruner, then initialize()."""
        self.init_pruner()
        self.initialize()

    def init_pruner(self):
        """Instantiate the pruner by name; only 'hyperband' exists.
        Idempotent: the driver calls it early to size the schedule."""
        if self.pruner is not None or self._pruner_name is None:
            return self.pruner
        if isinstance(self._pruner_name, str):
            if self._pruner_name.lower() != "hyperband":
                raise ValueError(
                    "Unknown pruner '{}'; supported: 'hyperband'.".format(self._pruner_name))
            from maggy_tpu_torch.pruner.hyperband import Hyperband

            self.pruner = Hyperband(trial_metric_getter=self.get_metrics_dict,
                                    **self._pruner_kwargs)
        else:
            self.pruner = self._pruner_name  # pre-built instance
            self.pruner.trial_metric_getter = self.get_metrics_dict
        return self.pruner

    # --------------------------------------------------------- observations
    #
    # Everything is normalized to a MINIMIZATION problem: metrics are negated
    # when direction == "max" (reference `abstractoptimizer.py:136-252`).

    def _sign(self) -> float:
        return -1.0 if self.direction == "max" else 1.0

    def get_hparams_array(self, budget: Optional[float] = None) -> np.ndarray:
        trials = self._finalized(budget)
        return self.searchspace.transform_batch([self._strip_budget(t.params) for t in trials])

    def get_metrics_dict(self, trial_ids: Union[str, List[str], None] = None) -> Dict[str, float]:
        ids = self._select_ids(trial_ids)
        sign = self._sign()
        return {t.trial_id: sign * t.final_metric for t in self.final_store
                if t.trial_id in ids and t.final_metric is not None}

    def get_metrics_array(self, budget: Optional[float] = None) -> np.ndarray:
        sign = self._sign()
        return np.asarray([sign * t.final_metric for t in self._finalized(budget)],
                          dtype=np.float64)

    def _finalized(self, budget: Optional[float] = None) -> List[Trial]:
        out = [t for t in self.final_store if t.final_metric is not None]
        if budget is not None and budget != 0:
            out = [t for t in out if t.params.get("budget") == budget]
        return out

    def _select_ids(self, trial_ids) -> set:
        if trial_ids is None:
            return {t.trial_id for t in self.final_store}
        if isinstance(trial_ids, str):
            return {trial_ids}
        return set(trial_ids)

    # Scheduler-injected params that are NOT hyperparameters: stripped from
    # reported best_hp/worst_hp and from duplicate/encoding comparisons.
    SYNTHETIC_PARAMS = ("budget",)

    def _strip_budget(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in params.items() if k not in self.SYNTHETIC_PARAMS}

    def hparams_exist(self, trial: Trial) -> bool:
        """True if this trial's budget-stripped params match any finalized or
        in-flight trial (reference `abstractoptimizer.py:254-295`)."""
        target = self._strip_budget(trial.params)
        return any(self._strip_budget(t.params) == target
                   for t in list(self.final_store) + list(self.trial_store.values()))

    def _lookup_params(self, trial_id: str) -> dict:
        for t in self.final_store:
            if t.trial_id == trial_id:
                return dict(t.params)
        if trial_id in self.trial_store:
            return dict(self.trial_store[trial_id].params)
        raise KeyError("Unknown trial id {}".format(trial_id))

    # ----------------------------------------------------------- trial factory

    def create_trial(self, hparams: Dict[str, Any], sample_type: str = "random",
                     run_budget: float = 0, model_budget: Optional[float] = None,
                     parent: Optional[str] = None) -> Trial:
        """Build a Trial with provenance info (reference
        `abstractoptimizer.py:317-376`): info_dict carries run_budget,
        sample_type ∈ {random, random_forced, model, promoted, grid},
        sampling_time and model_budget; the budget is injected into the
        params when multi-fidelity (pruner active), so the train function
        receives it as a keyword."""
        info: Dict[str, Any] = {"run_budget": run_budget, "sample_type": sample_type,
                                "sampling_time": time.time()}
        if model_budget is not None:
            info["model_budget"] = model_budget
        if parent is not None:
            info["parent"] = parent
        params = dict(hparams)
        if self.pruner is not None and run_budget:
            params["budget"] = run_budget
        return Trial(params, trial_type="optimization", info_dict=info)

    def get_max_budget(self) -> float:
        if self.pruner is None:
            raise ValueError("get_max_budget requires a pruner.")
        return self.pruner.max_budget

    # ------------------------------------------------------------- aggregates

    def ybest(self, budget: Optional[float] = None) -> float:
        y = self.get_metrics_array(budget=budget)
        return float(np.min(y)) if y.size else float("inf")

    def yworst(self, budget: Optional[float] = None) -> float:
        y = self.get_metrics_array(budget=budget)
        return float(np.max(y)) if y.size else float("-inf")

    def ymean(self, budget: Optional[float] = None) -> float:
        y = self.get_metrics_array(budget=budget)
        return float(np.mean(y)) if y.size else float("nan")
