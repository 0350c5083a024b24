"""Early-stopping rule contract.

Parity: reference `maggy/earlystop/abstractearlystop.py:20-42`. The driver
calls `earlystop_check` on METRIC messages, gated by es_min/es_interval
(`optimization_driver.py:346-361`); trials returned are flagged for stopping.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List

from maggy_tpu_torch.trial import Trial


class AbstractEarlyStop(ABC):
    @staticmethod
    @abstractmethod
    def earlystop_check(
        to_check: Dict[str, Trial], finalized_trials: List[Trial], direction: str
    ) -> List[Trial]:
        """Return the subset of ``to_check`` trials that should stop early."""
