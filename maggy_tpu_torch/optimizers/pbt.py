"""PBT — asynchronous Population Based Training (arXiv:1711.09846).

Copy of ``maggy_tpu/optimizers/pbt.py:1-266``. Each population member runs
``generations`` consecutive trials ("segments") of
``resource_per_generation`` budget each. When member m's generation-g
segment finalizes, its next segment is decided at once against the
population's latest finalized segments (no generation barrier):

- in the bottom ``exploit_quantile`` -> EXPLOIT: adopt a top-quantile
  peer's hparams, perturbed, with ``parent`` = that peer's segment;
- otherwise -> CONTINUE: same hparams, ``parent`` = its own segment.

With ``config.fork`` (the default) the driver stamps each parented segment
with its parent's checkpoint, the runner stages it, and a train function
that takes ``ctx`` resumes from it (``ctx.restore_parent`` or
``ctx.restore_checkpoint``). The train function sees ``generation``,
``member`` and ``budget`` as hparams. ``fork_gc_eligible`` says which
segments' checkpoints are spent; ``restore`` and ``restore_from_finals``
(JAX `pbt.py:267-313`) resume an interrupted run.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from maggy_tpu_torch.optimizers.abstractoptimizer import AbstractOptimizer
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial


class PBT(AbstractOptimizer):
    SYNTHETIC_PARAMS = ("budget", "generation", "member")

    def __init__(
        self,
        population: int = 8,
        generations: int = 4,
        resource_per_generation: float = 1,
        exploit_quantile: float = 0.25,
        perturb_factors=(0.8, 1.2),
        resample_probability: float = 0.25,
        seed=None,
    ):
        super().__init__(seed=seed)
        if population < 2:
            raise ValueError("population must be >= 2, got {}".format(population))
        if generations < 2:
            raise ValueError("generations must be >= 2, got {}".format(generations))
        if not 0.0 < exploit_quantile <= 0.5:
            raise ValueError(
                "exploit_quantile must be in (0, 0.5], got {}".format(exploit_quantile))
        self.population = population
        self.generations = generations
        self.resource_per_generation = resource_per_generation
        self.exploit_quantile = exploit_quantile
        self.perturb_factors = tuple(perturb_factors)
        self.resample_probability = resample_probability
        self._pending: List[Trial] = []
        # member -> consecutive segment errors; a member that errors twice
        # in a row is retired (dead) so the experiment can still finish.
        self._errors: Dict[int, int] = {}
        self._dead: set = set()

    # ------------------------------------------------------------- lifecycle

    def schedule_size(self) -> int:
        """Total segments = population x generations (the driver-side
        num_trials; same role as GridSearch.get_num_trials)."""
        return self.population * self.generations

    def max_concurrency(self) -> int:
        """Members are sequential segment chains: at most ``population``
        trials are ever in flight, whatever num_workers says."""
        return self.population

    def initialize(self) -> None:
        # All-categorical spaces are fine (explore = resample; the member
        # key keeps same-hparam segments id-unique), so unlike RandomSearch
        # there is no continuous-parameter requirement.
        for member, params in enumerate(
                self.searchspace.get_random_parameter_values(
                    self.population, rng=self.rng)):
            self._pending.append(self._segment(member, 0, params, parent=None,
                                               sample_type="random"))

    # ------------------------------------------------------------ scheduling

    def report(self, trial: Trial) -> None:
        """Decide the member's next segment against the population seen so
        far (the async exploit/continue step) — on the FINAL path, so the
        decision uses this FINAL's metric. Pending segments are appended
        here, never invalidated: each is a committed link of a member's
        sequential chain, so a prefetched segment stays valid whatever
        later FINALs decide (schedule_version is never bumped)."""
        member = trial.info_dict.get("member")
        if member is None:
            return
        if trial.final_metric is not None:
            self._errors.pop(member, None)
            if trial.info_dict.get("generation", 0) + 1 < self.generations:
                self._pending.append(self._next_segment(trial))
        else:
            self._handle_segment_error(trial, member)

    def suggest(self):
        if self._pending:
            return self._pending.pop(0)
        if self._finished():
            return None
        return "IDLE" if self._in_flight() else None

    def recycle(self, trial: Trial) -> None:
        # A member's chain is sequential: a taken-back segment goes to the
        # FRONT so the chain cannot reorder.
        self._pending.insert(0, trial)

    def _handle_segment_error(self, trial: Trial, member: int) -> None:
        """A segment ERRORed (train_fn raised). Retry once from the member's
        last finalized state — or a fresh config if it has none — then
        retire the member so a deterministically-broken lineage cannot spin
        the experiment forever. Without this, one errored segment silently
        ends the whole member (SURVEY.md §5.3's requeue covers runner DEATH,
        not train-side errors)."""
        errors = self._errors.get(member, 0) + 1
        self._errors[member] = errors
        if errors > 1:
            self._dead.add(member)
            return
        prev = self._population_state().get(member)
        if prev is not None:
            self._pending.append(self._next_segment(prev))
        else:
            params = self.searchspace.get_random_parameter_values(
                1, rng=self.rng)[0]
            self._pending.append(self._segment(member, 0, params, parent=None,
                                               sample_type="random"))

    def _finished(self) -> bool:
        done = {t.info_dict.get("member") for t in self.final_store
                if t.info_dict.get("generation", 0) == self.generations - 1
                and t.final_metric is not None}
        return len(done | self._dead) >= self.population

    def _in_flight(self) -> bool:
        return bool(self.trial_store)

    # -------------------------------------------------------------- segments

    def _segment(self, member: int, generation: int, hparams: dict,
                 parent: Optional[str], sample_type: str) -> Trial:
        params = dict(hparams)
        params["generation"] = generation
        # member rides in params so segment ids stay unique: trial ids hash
        # params only, and two members exploiting the same donor with the
        # same perturb draw produce IDENTICAL hparams — without the member
        # key their segments collapse into one driver-store entry and a
        # lineage silently dies (observed: 7 of 9 segments run).
        params["member"] = member
        params["budget"] = self.resource_per_generation
        info = {"sample_type": sample_type, "member": member,
                "generation": generation}
        if parent is not None:
            info["parent"] = parent
        return Trial(params, info_dict=info)

    def _population_state(self) -> Dict[int, Trial]:
        """Each member's LATEST finalized segment — the population the
        paper's exploit step compares against. Comparing only
        same-generation peers would let the first finisher of every
        generation escape unchallenged (it has no peers yet) while later
        finishers compare against a bottom already held by that early
        weak member; the population view is also what makes the decision
        sound when members drift generations apart (async)."""
        latest: Dict[int, Trial] = {}
        for t in self.final_store:
            member = t.info_dict.get("member")
            # final_store also holds ERRORED segments (final_metric None):
            # they are not population state — using one as a member's
            # "latest" would skip a generation and point warm-starts at a
            # checkpoint that may not exist.
            if member is None or t.final_metric is None:
                continue
            if (member not in latest
                    or t.info_dict.get("generation", 0)
                    > latest[member].info_dict.get("generation", 0)):
                latest[member] = t
        return latest

    def _next_segment(self, finalized: Trial) -> Trial:
        member = finalized.info_dict["member"]
        generation = finalized.info_dict.get("generation", 0)
        metrics = self.get_metrics_dict()  # normalized: lower is better
        population = self._population_state()
        population[member] = finalized
        ranked = sorted((t for t in population.values()
                         if t.trial_id in metrics),
                        key=lambda t: metrics[t.trial_id])
        k = max(1, math.ceil(len(ranked) * self.exploit_quantile))
        bottom = {t.trial_id for t in ranked[-k:]} if len(ranked) > 1 else set()
        if finalized.trial_id in bottom:
            donor = ranked[int(self.rng.integers(0, k))]
            if donor.info_dict.get("member") != member:
                return self._segment(
                    member, generation + 1,
                    self._perturb(self._hparams_of(donor)),
                    parent=donor.trial_id, sample_type="exploit")
        return self._segment(member, generation + 1,
                             self._hparams_of(finalized),
                             parent=finalized.trial_id, sample_type="continue")

    def _hparams_of(self, trial: Trial) -> dict:
        return self._strip_budget(trial.params)

    def _perturb(self, hparams: dict) -> dict:
        """Explore step: scale continuous params by a perturb factor (clipped
        to the space), resample discrete/categorical with small probability."""
        out = {}
        for name in self.searchspace.names():
            hp_type = self.searchspace.get_type(name)
            value = hparams[name]
            spec = self.searchspace.get(name)
            if hp_type in Searchspace.CONTINUOUS_TYPES:
                factor = self.perturb_factors[
                    int(self.rng.integers(0, len(self.perturb_factors)))]
                lo, hi = min(spec), max(spec)
                scaled = min(max(value * factor, lo), hi)
                out[name] = int(round(scaled)) \
                    if hp_type == Searchspace.INTEGER else float(scaled)
            else:
                if self.rng.random() < self.resample_probability:
                    out[name] = spec[int(self.rng.integers(0, len(spec)))]
                else:
                    out[name] = value
        return out

    def fork_gc_eligible(self):
        """Checkpoint GC (checkpoint-forking search): a segment's
        checkpoint is spent once it is SUPERSEDED — it is no longer any
        member's latest finalized segment (exploit donors and continue
        parents are always drawn from ``_population_state``), and no
        pending or in-flight segment still names it as parent (a queued
        exploit must be able to stage its donor's checkpoint when it
        finally dispatches)."""
        keep = {t.trial_id for t in self._population_state().values()}
        for pending in self._pending:
            parent = pending.info_dict.get("parent")
            if parent is not None:
                keep.add(parent)
        for t in self.trial_store.values():
            parent = t.info_dict.get("parent")
            if parent is not None:
                keep.add(parent)
        return [t.trial_id for t in self.final_store
                if t.final_metric is not None and t.trial_id not in keep]

    # ---------------------------------------------------------------- resume

    def restore(self, finalized) -> None:
        """Rebuild the schedule from a previous run; segments in flight at the
        crash are derived again as their parents' successors below.

        Error state (``_errors``/``_dead``) is not restored: errored segments
        write no final_metric, so the resume never hands them back and the
        retry ledger is gone. A member retired by the two-consecutive-error
        rule re-enters with a fresh retry budget: its lineage re-runs from its
        last finalized state and is retired again after two more errors if it
        is broken. Bounded re-work, never a livelock within one run."""
        # Drop the initial segments of members that already ran generation 0.
        done0 = {t.info_dict.get("member") for t in finalized
                 if t.info_dict.get("generation", 0) == 0}
        self._pending = [p for p in self._pending if p.info_dict["member"] not in done0]
        # Queue the next segment of each member whose last finalized
        # generation has no successor yet.
        latest: Dict[int, Trial] = {}
        for t in finalized:
            member = t.info_dict.get("member")
            if member is None:
                continue
            generation = t.info_dict.get("generation", 0)
            if member not in latest or generation > latest[member].info_dict.get("generation", 0):
                latest[member] = t
        for t in latest.values():
            if t.info_dict.get("generation", 0) + 1 < self.generations:
                self._pending.append(self._next_segment(t))

    def restore_from_finals(self, finalized, inflight=()) -> None:
        """Crash-only recovery: ``restore`` already derives each member's next
        segment from its last finalized generation, the segments ``report``
        would have appended, so re-reporting would append every chain link
        twice. The in-flight segments the driver rebuilt from the journal are
        those successors (same member, generation and content-addressed id):
        they leave the pending queue, or the chain would run its next link
        twice."""
        self.restore(finalized)
        have = {t.trial_id for t in inflight}
        if have:
            self._pending = [p for p in self._pending if p.trial_id not in have]
