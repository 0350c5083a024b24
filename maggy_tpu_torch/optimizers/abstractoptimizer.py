"""Abstract optimizer: the driver-side search-algorithm plugin contract.

Copy of ``maggy_tpu/optimizers/abstractoptimizer.py`` without the pruner
(Hyperband) hook, the resume/restore contract and checkpoint-fork GC.
Parity: reference `maggy/optimizer/abstractoptimizer.py` — contract at
:54-79; driver-injected attributes at :36-40; observation getters with
direction normalization at :136-252; trial factory at :317-376.

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
    def __init__(self, seed: Optional[int] = None):
        # Injected by the driver after construction (reference
        # `optimization_driver.py:87-93`).
        self.searchspace: Optional[Searchspace] = None
        self.num_trials: int = 0
        self.trial_store: Dict[str, Trial] = {}
        self.final_store: List[Trial] = []
        self.direction: str = "max"
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------- contract
    #
    # ``report(trial)`` ingests a just-finalized trial (rung bookkeeping) and
    # runs on the FINAL path before the freed runner is handed new work;
    # ``suggest()`` proposes the next Trial, "IDLE" (ask again later) or
    # None (no more work). ``get_suggestion`` is the single-call form.

    @abstractmethod
    def initialize(self) -> None:
        """Called once by the driver before any suggestions are requested."""

    def report(self, trial: Trial) -> None:
        """Ingest a finalized (or errored) trial."""

    @abstractmethod
    def suggest(self):
        """Return the next Trial, "IDLE", or None."""

    def get_suggestion(self, trial: Optional[Trial] = None):
        """Report the just-finalized ``trial`` (if any), then suggest."""
        if trial is not None:
            self.report(trial)
        return self.suggest()

    def finalize_experiment(self, trials: List[Trial]) -> None:
        """Called once after the experiment completes."""

    # --------------------------------------------------------- observations
    #
    # Everything is normalized to a MINIMIZATION problem: metrics are negated
    # when direction == "max" (reference `abstractoptimizer.py:136-252`).

    def _sign(self) -> float:
        return -1.0 if self.direction == "max" else 1.0

    def get_metrics_dict(self, trial_ids: Union[str, List[str], None] = None) -> Dict[str, float]:
        ids = self._select_ids(trial_ids)
        sign = self._sign()
        return {t.trial_id: sign * t.final_metric for t in self.final_store
                if t.trial_id in ids and t.final_metric is not None}

    def _select_ids(self, trial_ids) -> set:
        if trial_ids is None:
            return {t.trial_id for t in self.final_store}
        if isinstance(trial_ids, str):
            return {trial_ids}
        return set(trial_ids)

    # Scheduler-injected params that are NOT hyperparameters: stripped from
    # reported best_hp/worst_hp.
    SYNTHETIC_PARAMS = ("budget",)

    def _strip_budget(self, params: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in params.items() if k not in self.SYNTHETIC_PARAMS}

    def create_trial(self, hparams: Dict[str, Any], sample_type: str = "random") -> Trial:
        """Build a Trial with provenance info (reference
        `abstractoptimizer.py:317-376`)."""
        info = {"run_budget": 0, "sample_type": sample_type,
                "sampling_time": time.time()}
        return Trial(dict(hparams), trial_type="optimization", info_dict=info)
