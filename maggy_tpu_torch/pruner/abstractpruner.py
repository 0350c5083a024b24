"""Pruner plugin contract.

Copy of ``maggy_tpu/pruner/abstractpruner.py`` (parity: reference
`maggy/pruner/abstractpruner.py:23-95`). A pruner owns the multi-fidelity
schedule; the optimizer delegates budget/promotion decisions to
`pruning_routine()` and reports spawned trial ids back via `report_trial()`.
The pruner reads trial outcomes through ``trial_metric_getter`` (the
optimizer's `get_metrics_dict`, direction-normalized so lower is better).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Dict, Optional


class AbstractPruner(ABC):
    def __init__(self, trial_metric_getter: Callable[..., Dict[str, float]]):
        self.trial_metric_getter = trial_metric_getter

    @abstractmethod
    def pruning_routine(self):
        """Return {"trial_id": parent_or_None, "budget": b}, "IDLE", or None."""

    @abstractmethod
    def report_trial(self, original_trial_id: Optional[str], new_trial_id: str) -> None:
        """Associate the trial the optimizer created with the slot just handed out."""

    @abstractmethod
    def finished(self) -> bool:
        """True once the full multi-fidelity schedule has been executed."""

    @abstractmethod
    def num_trials(self) -> int:
        """Total number of trial runs the schedule will execute."""
