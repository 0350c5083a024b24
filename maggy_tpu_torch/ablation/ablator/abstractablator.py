"""Ablator plugin contract.

Copy of ``maggy_tpu/ablation/ablator/abstractablator.py`` (reference
`maggy/ablation/ablator/abstractablator.py:20-86`). An ablator also answers
the slice of the controller interface the ``OptimizationDriver`` drives, so
an ablation study reuses the whole scheduling machinery (the reference
subclasses the driver, `ablation_driver.py:108-109`). Beside the JAX
contract: ``supports_prefetch`` is False (the JAX driver reads a missing
one so), so trials leave the buffer one FINAL at a time, in the JAX
package's order, and the prefetch hooks are never called; ``report`` (a
lane block's non-final lanes) and ``fork_gc_eligible`` answer the driver's
FINAL path; ``restore_from_finals`` serves ``AblationConfig(resume=True)``,
which the JAX ablator lacks (ROADMAP queue 3 item 20).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional

from maggy_tpu_torch.trial import Trial


class AbstractAblator(ABC):
    def __init__(self, ablation_study, final_store: Optional[List[Trial]] = None):
        self.ablation_study = ablation_study
        self.final_store = final_store if final_store is not None else []
        self.trial_buffer: List[Trial] = []
        self.pruner = None
        self.trial_store = {}
        self.searchspace = None
        self.num_trials = 0
        self.direction = "max"

    @abstractmethod
    def get_number_of_trials(self) -> int:
        ...

    @abstractmethod
    def initialize(self) -> None:
        """Fill the trial buffer with the full ablation schedule."""

    @abstractmethod
    def get_trial(self, last_trial: Optional[Trial] = None) -> Optional[Trial]:
        """Pop the next trial, or None when the study is complete."""

    def finalize_experiment(self, trials: List[Trial]) -> None:
        pass

    def restore_from_finals(self, finalized: List[Trial], inflight: List[Trial] = ()) -> None:
        """Experiment resume: drop from the buffer every trial the previous
        run finalized and every one the driver rebuilt as in flight (trial
        ids hash the ablated components, so the schedule's ids match)."""
        done = {t.trial_id for t in finalized} | {t.trial_id for t in inflight}
        self.trial_buffer = [t for t in self.trial_buffer if t.trial_id not in done]

    # ----------------------------------------------- controller-shim methods

    def _initialize(self) -> None:
        self.initialize()

    def get_suggestion(self, trial: Optional[Trial] = None) -> Optional[Trial]:
        return self.get_trial(trial)

    def supports_prefetch(self) -> bool:
        return False

    def report(self, trial: Trial) -> None:
        pass

    def fork_gc_eligible(self) -> List[str]:
        return []

    def init_pruner(self):
        return None

    @staticmethod
    def _strip_budget(params):
        return {k: v for k, v in params.items() if k != "budget"}
