"""ASHA — Asynchronous Successive Halving (arXiv:1810.05934).

Copy of ``maggy_tpu/optimizers/asha.py`` without the vectorized-lane rung
drain, checkpoint-fork GC and resume restore. ``report`` bumps
``schedule_version`` and ``recycle`` un-commits a promotion, as the JAX
controller does for the driver's prefetch pipeline. Parity: reference
`maggy/optimizer/asha.py` — params and validation (:39-69), rung
bookkeeping (:71-82), stop at max rung (:89-92), top-down promotion scan
(:94-147), fresh rung-0 sampling (:149-156). Promotion uses the
direction-normalized metrics of `AbstractOptimizer.get_metrics_dict`, so
ASHA is correct for both directions (the reference's `_top_k` assumes
"max", SURVEY.md §2.5).
"""

from __future__ import annotations

from typing import Dict, List

from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.trial import Trial


class Asha(AbstractOptimizer):
    def __init__(self, reduction_factor: int = 2, resource_min: float = 1,
                 resource_max: float = 4, seed=None):
        super().__init__(seed=seed)
        if reduction_factor < 2:
            raise ValueError("reduction_factor must be >= 2, got {}".format(reduction_factor))
        if resource_min <= 0 or resource_max < resource_min:
            raise ValueError(
                "Require 0 < resource_min <= resource_max, got min={} max={}".format(
                    resource_min, resource_max))
        self.reduction_factor = reduction_factor
        self.resource_min = resource_min
        self.resource_max = resource_max
        # rung index k -> trial ids finalized at that rung
        self.rungs: Dict[int, List[str]] = {0: []}
        # rung index k -> trial ids already promoted out of rung k
        self.promoted: Dict[int, List[str]] = {}
        # Exact integer loop, not floor(log()): float error would drop a rung
        # for exact eta-power ratios (log(243, 3) == 4.9999...).
        self.max_rung, b = 0, float(resource_min)
        while b * reduction_factor <= resource_max * (1 + 1e-9):
            b *= reduction_factor
            self.max_rung += 1
        # A survivor reached the top rung: the experiment is over.
        self._exhausted = False

    def initialize(self) -> None:
        # rf^max_rung rung-0 samples are the minimum that lets one trial
        # climb the full ladder.
        needed = self.reduction_factor ** self.max_rung
        if self.num_trials < needed:
            raise ValueError(
                "ASHA with rf={} and {} rungs needs num_trials >= {}, got {}.".format(
                    self.reduction_factor, self.max_rung + 1, needed, self.num_trials))

    def rung_budget(self, rung: int) -> float:
        return self.resource_min * (self.reduction_factor ** rung)

    def report(self, trial: Trial) -> None:
        """Bookkeep the just-finalized trial into its rung. Bumps
        ``schedule_version`` when the FINAL changes what suggest() would
        return next — a survivor reaching the top rung (experiment done) or
        a promotion becoming available — so the driver invalidates any
        prefetched rung-0 sample instead of dispatching it ahead of the
        promotion."""
        if trial.final_metric is None:
            return
        rung = trial.info_dict.get("rung", 0)
        self.rungs.setdefault(rung, []).append(trial.trial_id)
        if rung == self.max_rung:
            self._exhausted = True
            self.schedule_version += 1
        elif self._promotable() is not None:
            self.schedule_version += 1

    def recycle(self, trial: Trial) -> None:
        """Take back an invalidated prefetched suggestion. A promoted trial
        un-commits its parent from the promoted ledger, or the parent's next
        rung would never run. A dropped rung-0 sample needs nothing: the
        sampling budget counts final_store + trial_store."""
        parent = trial.info_dict.get("parent")
        rung = trial.info_dict.get("rung", 0)
        if parent is not None and rung > 0 and parent in self.promoted.get(rung - 1, []):
            self.promoted[rung - 1].remove(parent)

    def _promotable(self):
        """Top-down scan for a promotable (not-yet-promoted) trial: (rung,
        parent_id), best metric first within a rung, or None."""
        metrics = self.get_metrics_dict()  # normalized: lower is better
        for rung in sorted(self.rungs.keys(), reverse=True):
            if rung >= self.max_rung:
                continue
            finalized = [tid for tid in self.rungs[rung] if tid in metrics]
            k = len(finalized) // self.reduction_factor
            top_k = sorted(finalized, key=lambda tid: metrics[tid])[:k]
            for tid in top_k:
                if tid not in self.promoted.get(rung, []):
                    return rung, tid
        return None

    def _rung0_budget_left(self) -> bool:
        sampled = sum(1 for t in self.final_store if t.info_dict.get("rung", 0) == 0)
        in_flight = sum(1 for t in self.trial_store.values()
                        if t.info_dict.get("rung", 0) == 0)
        return sampled + in_flight < self.num_trials

    def suggest(self):
        if self._exhausted:
            return None  # a survivor reached the top — experiment done
        promotable = self._promotable()
        if promotable is not None:
            rung, parent_id = promotable
            self.promoted.setdefault(rung, []).append(parent_id)
            params = self._strip_budget(self._lookup_params(parent_id))
            params["budget"] = self.rung_budget(rung + 1)
            return Trial(params, info_dict={"sample_type": "promoted",
                                            "rung": rung + 1, "parent": parent_id})
        if not self._rung0_budget_left():
            # Everything sampled; wait for in-flight trials to enable promotion.
            return "IDLE" if self.trial_store else None
        params = self.searchspace.get_random_parameter_values(1, rng=self.rng)[0]
        params["budget"] = self.rung_budget(0)
        return Trial(params, info_dict={"sample_type": "random", "rung": 0})
