"""Median stopping rule.

Parity: reference `maggy/earlystop/medianrule.py:21-60`: stop a running trial
if its best-so-far metric is worse than the median of finalized trials'
running averages truncated at the same step.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

from maggy_tpu_torch.earlystop.abstractearlystop import AbstractEarlyStop
from maggy_tpu_torch.trial import Trial


class MedianStoppingRule(AbstractEarlyStop):
    @staticmethod
    def earlystop_check(
        to_check: Dict[str, Trial], finalized_trials: List[Trial], direction: str
    ) -> List[Trial]:
        stop_list: List[Trial] = []
        maximize = direction == "max"
        for trial in to_check.values():
            with trial.lock:
                history = list(trial.metric_history)
            if not history:
                continue
            step = len(history)
            # Running averages of finalized trials truncated at this step.
            # Only trials that actually reached this step contribute —
            # shorter (e.g. early-stopped) histories would bias the median
            # toward warm-up values (reference `medianrule.py:38-44`).
            running_avgs = []
            for fin in finalized_trials:
                if len(fin.metric_history) >= step:
                    fh = fin.metric_history[:step]
                    running_avgs.append(sum(fh) / len(fh))
            if not running_avgs:
                continue
            median = statistics.median(running_avgs)
            best = max(history) if maximize else min(history)
            worse = best < median if maximize else best > median
            if worse:
                stop_list.append(trial)
        return stop_list
