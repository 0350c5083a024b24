"""ASHA — Asynchronous Successive Halving (arXiv:1810.05934).

Copy of ``maggy_tpu/optimizers/asha.py``, with the vectorized lanes' rung
drain (JAX `asha.py:57-62, 130-158`); its checkpoint-fork GC (``fork_gc_eligible``, JAX `asha.py:190-215`)
and its resume (``restore``, ``restore_from_finals``, JAX `:219-256`) are
ported. As in the JAX package, the restore leaves ``rng`` where a fresh
controller starts it: a seeded ASHA resumed after a crash draws its rung-0
samples from the start of the pre-crash sequence again, and so may suggest
a config that already finalized (ROADMAP queue 3 item 8). ``report`` bumps
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
        # K-at-a-time rung drain (config.vmap_lanes > 1, which the driver
        # sets as ``self.vmap_lanes``): once a drain starts, the promotable
        # backlog empties before rung-0 sampling resumes.
        self._draining = False

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

    def _promotable_all(self) -> List[tuple]:
        """Every promotable (rung, parent_id), top rung first and best
        metric first within a rung: the order of both the single-step scan
        and the drain."""
        metrics = self.get_metrics_dict()  # normalized: lower is better
        out: List[tuple] = []
        for rung in sorted(self.rungs.keys(), reverse=True):
            if rung >= self.max_rung:
                continue
            finalized = [tid for tid in self.rungs[rung] if tid in metrics]
            k = len(finalized) // self.reduction_factor
            top_k = sorted(finalized, key=lambda tid: metrics[tid])[:k]
            out.extend((rung, tid) for tid in top_k if tid not in self.promoted.get(rung, []))
        return out

    def _promotable(self):
        """Top-down scan for a promotable (not-yet-promoted) trial: (rung,
        parent_id), best metric first within a rung, or None."""
        candidates = self._promotable_all()
        return candidates[0] if candidates else None

    def _rung0_budget_left(self) -> bool:
        sampled = sum(1 for t in self.final_store if t.info_dict.get("rung", 0) == 0)
        in_flight = sum(1 for t in self.trial_store.values()
                        if t.info_dict.get("rung", 0) == 0)
        return sampled + in_flight < self.num_trials

    def suggest(self):
        if self._exhausted:
            return None  # a survivor reached the top — experiment done
        promotable = self._promotable_all()
        if promotable:
            # The rung drain under vectorized lanes: a lone promotion (it
            # restores a checkpoint, so it never rides a block) would split
            # the rung-0 stream that blocks assemble from. While rung-0
            # sampling can still fill lanes, promotions wait until K pile
            # up, then the backlog drains back to back. With one lane they
            # go at once, the scalar schedule.
            lanes = max(1, int(getattr(self, "vmap_lanes", 1) or 1))
            defer = (lanes > 1 and not self._draining and len(promotable) < lanes
                     and self._rung0_budget_left())
            if not defer:
                self._draining = len(promotable) > 1
                rung, parent_id = promotable[0]
                self.promoted.setdefault(rung, []).append(parent_id)
                params = self._strip_budget(self._lookup_params(parent_id))
                params["budget"] = self.rung_budget(rung + 1)
                return Trial(params, info_dict={"sample_type": "promoted",
                                                "rung": rung + 1, "parent": parent_id})
        else:
            self._draining = False
        if not self._rung0_budget_left():
            # Everything sampled; wait for in-flight trials to enable promotion.
            return "IDLE" if self.trial_store else None
        params = self.searchspace.get_random_parameter_values(1, rng=self.rng)[0]
        params["budget"] = self.rung_budget(0)
        return Trial(params, info_dict={"sample_type": "random", "rung": 0})

    def fork_gc_eligible(self):
        """Checkpoint GC: a rung parent's checkpoint is spent once its
        promotion child has finalized (a trial leaves a rung at most once).
        A not-yet-promoted trial stays: promotion eligibility grows as rungs
        fill. Once the experiment is exhausted every finalized trial's
        checkpoint is spent except the top-rung survivors': the winner's
        trained state is what the sweep is for."""
        metrics = self.get_metrics_dict()
        if self._exhausted:
            keep = set(self.rungs.get(self.max_rung, []))
            return sorted(tid for tid in metrics if tid not in keep)
        finalized_children: Dict[str, int] = {}
        for t in self.final_store:
            parent = t.info_dict.get("parent")
            if parent is not None and t.final_metric is not None:
                finalized_children[parent] = finalized_children.get(parent, 0) + 1
        return [parent for parents in self.promoted.values() for parent in parents
                if finalized_children.get(parent)]

    def restore(self, finalized) -> None:
        """Rebuild the rung ladder from a previous run: each finalized trial
        re-enters its rung, and a promoted child marks its parent promoted
        out of the rung below."""
        for t in finalized:
            rung = t.info_dict.get("rung", 0)
            self.rungs.setdefault(rung, []).append(t.trial_id)
            parent = t.info_dict.get("parent")
            if parent is not None and rung > 0:
                self.promoted.setdefault(rung - 1, []).append(parent)

    def restore_from_finals(self, finalized, inflight=()) -> None:
        """Crash-only recovery: ``restore`` rebuilds the ledgers ``report``
        writes (re-reporting would enter every rung twice) plus the promoted
        ledger. An in-flight promoted child was committed by the dead
        incarnation's suggest(): its parent re-enters the promoted ledger, or
        it would be promoted into a duplicate child. A survivor that reached
        the top rung before the crash leaves the controller exhausted.
        Rung-0 sampling counts the stores the driver refilled."""
        self.restore(finalized)
        for t in inflight:
            parent = t.info_dict.get("parent")
            rung = t.info_dict.get("rung", 0)
            if parent is not None and rung > 0 and parent not in self.promoted.get(rung - 1, []):
                self.promoted.setdefault(rung - 1, []).append(parent)
        if any(t.info_dict.get("rung", 0) >= self.max_rung
               for t in finalized if t.final_metric is not None):
            self._exhausted = True
            self.schedule_version += 1
