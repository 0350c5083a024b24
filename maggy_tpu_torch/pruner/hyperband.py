"""Hyperband: multi-bracket successive halving (BOHB-style).

Copy of ``maggy_tpu/pruner/hyperband.py``, with its resume contract
(``state_dict`` / ``load_state_dict`` / ``restore``; the JSON has the JAX
package's keys, so either package reads the other's bracket file). Parity: reference
`maggy/pruner/hyperband.py` — geometric budget ladder and max rung count
(:114-125), bracket construction with per-bracket (n_configs, budgets)
(:197-218), `pruning_routine` scanning active iterations then starting the
next bracket, else IDLE, else None (:137-195), `report_trial` routing
(:266-279), `SHIteration` with INIT/RUNNING/FINISHED states and rung
bookkeeping {rung -> [{original, actual}]} (:299-594).

Bracket sizing follows HpBandSter/BOHB: bracket ``s`` runs
``n0 = ceil(max_rungs/(s+1) * eta^s)`` configs over ``s+1`` rungs with
``n_j = floor(n0 * eta^-j)`` survivors at rung j.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from maggy_tpu_torch.pruner.abstractpruner import AbstractPruner


def _geometric_rungs(min_budget: float, max_budget: float, eta: float) -> int:
    """Number of rungs in the ladder min*eta^k <= max, computed exactly."""
    rungs, b = 1, float(min_budget)
    while b * eta <= max_budget * (1 + 1e-9):
        b *= eta
        rungs += 1
    return rungs


class SHIteration:
    """One successive-halving bracket."""

    INIT = "INIT"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"

    def __init__(self, iteration_id: int, n_configs: List[int], budgets: List[float]):
        assert len(n_configs) == len(budgets)
        self.iteration_id = iteration_id
        self.n_configs = n_configs  # survivors per rung
        self.budgets = budgets  # budget per rung
        self.state = SHIteration.INIT
        # rung -> list of slots {"original": rung0-lineage id, "actual": run id}
        self.configs: Dict[int, List[dict]] = {r: [] for r in range(len(budgets))}
        # Slot handed out by get_next_run but not yet bound via report_trial.
        self._pending: Optional[dict] = None

    @property
    def num_rungs(self) -> int:
        return len(self.budgets)

    def actual_ids(self, rung: int) -> List[str]:
        return [s["actual"] for s in self.configs[rung] if s["actual"] is not None]

    def rung_full(self, rung: int) -> bool:
        return len(self.configs[rung]) >= self.n_configs[rung]

    def rung_finalized(self, rung: int, metrics: Dict[str, float]) -> bool:
        ids = self.actual_ids(rung)
        return (
            self.rung_full(rung)
            and len(ids) == self.n_configs[rung]
            and all(tid in metrics for tid in ids)
        )

    def get_next_run(self, metrics: Dict[str, float]) -> Optional[dict]:
        """Return the next schedulable run in this bracket, or None.

        Rung-0 slots first ({"trial_id": None} → optimizer samples fresh);
        then promotions of finalized lower rungs (reference
        `hyperband.py:377-443,487-527`).
        """
        if self._pending is not None:
            return None  # one outstanding hand-out at a time
        self.state = SHIteration.RUNNING
        if not self.rung_full(0):
            self._pending = {"rung": 0, "original": None}
            return {"trial_id": None, "budget": self.budgets[0]}
        for rung in range(self.num_rungs - 1):
            if not self.rung_finalized(rung, metrics):
                continue
            if self.rung_full(rung + 1):
                continue
            promoted_originals = {s["original"] for s in self.configs[rung + 1]}
            # Top-k of this rung by normalized metric (lower is better).
            ranked = sorted(self.configs[rung], key=lambda s: metrics[s["actual"]])
            for slot in ranked[: self.n_configs[rung + 1]]:
                if slot["original"] not in promoted_originals:
                    self._pending = {"rung": rung + 1, "original": slot["original"]}
                    return {"trial_id": slot["actual"], "budget": self.budgets[rung + 1]}
        return None

    def report_trial(self, new_trial_id: str) -> None:
        assert self._pending is not None, "report_trial without a pending slot"
        rung = self._pending["rung"]
        original = self._pending["original"] or new_trial_id
        self.configs[rung].append({"original": original, "actual": new_trial_id})
        self._pending = None

    def check_finished(self, metrics: Dict[str, float]) -> bool:
        if self.state == SHIteration.FINISHED:
            return True
        if self._pending is None and self.rung_finalized(self.num_rungs - 1, metrics):
            self.state = SHIteration.FINISHED
            return True
        return False


class Hyperband(AbstractPruner):
    def __init__(
        self,
        trial_metric_getter,
        min_budget: float = 1,
        max_budget: float = 9,
        eta: int = 3,
        n_iterations: Optional[int] = None,
    ):
        super().__init__(trial_metric_getter)
        if eta < 2:
            raise ValueError("eta must be >= 2")
        if min_budget <= 0 or max_budget < min_budget:
            raise ValueError("Require 0 < min_budget <= max_budget")
        self.min_budget = min_budget
        self.max_budget = max_budget
        self.eta = eta
        # Geometric ladder ending at max_budget (reference `hyperband.py:114-125`).
        # Exact integer loop, not floor(log()): float error makes
        # math.log(243, 3) == 4.9999... and would drop a rung.
        self.max_sh_rungs = _geometric_rungs(min_budget, max_budget, eta)
        self.budgets = [
            max_budget * eta ** (-(self.max_sh_rungs - 1 - j)) for j in range(self.max_sh_rungs)
        ]
        self.n_iterations = n_iterations if n_iterations is not None else self.max_sh_rungs
        self.iterations: List[SHIteration] = []

    # ------------------------------------------------------------- schedule

    def _bracket_plan(self, iteration_id: int):
        """(n_configs, budgets) for bracket i, cycling s = max-1 ... 0."""
        s = self.max_sh_rungs - 1 - (iteration_id % self.max_sh_rungs)
        n0 = int(math.ceil(self.max_sh_rungs / (s + 1) * self.eta ** s))
        n_configs = [max(1, int(n0 * self.eta ** (-j))) for j in range(s + 1)]
        budgets = self.budgets[-(s + 1):]
        return n_configs, budgets

    def num_trials(self) -> int:
        return sum(sum(self._bracket_plan(i)[0]) for i in range(self.n_iterations))

    # -------------------------------------------------------------- routine

    def pruning_routine(self):
        metrics = self.trial_metric_getter()
        # Scan active iterations for a schedulable run (reference :137-195).
        for it in self.iterations:
            if it.check_finished(metrics):
                continue
            run = it.get_next_run(metrics)
            if run is not None:
                self._updating_iteration = it
                return run
        # Start the next bracket if any remain.
        if len(self.iterations) < self.n_iterations:
            n_configs, budgets = self._bracket_plan(len(self.iterations))
            it = SHIteration(len(self.iterations), n_configs, budgets)
            self.iterations.append(it)
            run = it.get_next_run(metrics)
            assert run is not None
            self._updating_iteration = it
            return run
        if self.finished():
            return None
        return "IDLE"

    def report_trial(self, original_trial_id: Optional[str], new_trial_id: str) -> None:
        self._updating_iteration.report_trial(new_trial_id)

    def report_failure(self, trial_id: str) -> None:
        """Remove a failed run's slot so its rung can be re-issued.

        Without this, a trial finalized without a metric (ERROR path) would
        block `rung_finalized` forever and hang the schedule in IDLE. The
        driver calls this when a trial lands in `Trial.ERROR`.
        """
        for it in self.iterations:
            for rung, slots in it.configs.items():
                for slot in slots:
                    if slot["actual"] == trial_id:
                        slots.remove(slot)
                        if it.state == SHIteration.FINISHED:
                            it.state = SHIteration.RUNNING
                        return

    def finished(self) -> bool:
        if len(self.iterations) < self.n_iterations:
            return False
        metrics = self.trial_metric_getter()
        return all(it.check_finished(metrics) for it in self.iterations)

    # ------------------------------------------------------ checkpoint/resume

    def state_dict(self) -> dict:
        """The bracket state as JSON-able data; the driver checkpoints it on
        every scheduling transition so that ``resume=True`` works with a
        pruner. The pending hand-out is not saved: an unfinalized hand-out
        is issued again at restore."""
        return {"iterations": [
            {"iteration_id": it.iteration_id, "n_configs": it.n_configs,
             "budgets": it.budgets, "state": it.state,
             "configs": {str(r): list(slots) for r, slots in it.configs.items()}}
            for it in self.iterations]}

    def load_state_dict(self, state: dict) -> None:
        self.iterations = []
        for rec in state.get("iterations", []):
            it = SHIteration(rec["iteration_id"], list(rec["n_configs"]), list(rec["budgets"]))
            it.state = rec["state"]
            it.configs = {int(r): list(slots) for r, slots in rec["configs"].items()}
            self.iterations.append(it)

    def restore(self, finalized_ids) -> None:
        """Reconcile restored bracket state with the trials that finalized:
        slots bound to runs the interrupted experiment never finished are
        dropped (their rungs issue them again), and each bracket's state is
        recomputed from the surviving metrics."""
        finalized_ids = set(finalized_ids)
        metrics = self.trial_metric_getter()
        for it in self.iterations:
            it._pending = None
            for rung in list(it.configs):
                it.configs[rung] = [s for s in it.configs[rung] if s["actual"] in finalized_ids]
            it.state = SHIteration.INIT if not any(it.configs.values()) else SHIteration.RUNNING
            it.check_finished(metrics)
