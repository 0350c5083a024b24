"""Per-trial execution context handed to user train functions.

Counterpart of ``maggy_tpu/core/executors/context.py:29-196``. A train
function opts into a ``ctx`` argument by naming it, as it names
``reporter``, and gets:

- the trial's identity (``trial_id``, ``trial_dir``, ``exp_dir``, raw
  ``params``), its multi-fidelity ``budget`` and, for a promotion or a PBT
  segment, its ``parent_trial_id``;
- its checkpoint lineage: ``forked_from`` (the parent's checkpoint the
  driver stamped, which the executor stages into this trial's dir before
  the call) and ``resume_step`` (the step to resume from, set for a fork
  and for a preempted trial that checkpointed);
- checkpoints in its trial dir (``save_checkpoint`` /
  ``restore_checkpoint``, ``torch.save`` underneath) and
  ``restore_parent``, timed into the runner's telemetry with each call's
  wait for the process's checkpoint lock apart (``*_lock_ms``).

The state saved is anything ``torch.save`` writes with tensors and numbers
in nested dicts, lists and tuples — typically ``{"model":
model.state_dict(), "optimizer": optimizer.state_dict(), ...}``; a restore
takes the same structure from a freshly built trainer as its template.
A gang trial's function gets ``ctx.gang``, a ``gang.GangContext`` (JAX
``:124-140``): the member chips, the mesh axes, the strategy and
``sharding_env()`` over the gang's world; None for a 1-chip trial. A train
function that names ``lanes`` gets a ``LaneSet`` for a vectorized block
instead of one trial (JAX ``:199-245``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional


def _note_ckpt(**fields: Any) -> None:
    """Route checkpoint I/O timing into the current trial's RunnerStats via
    the trial scope. Never fatal: accounting must not break checkpointing."""
    try:
        from maggy_tpu_torch.train.warm import note_ckpt

        note_ckpt(**fields)
    except Exception:  # noqa: BLE001 - accounting is best-effort
        pass


def info_needs_fresh_state(info: Dict[str, Any]) -> bool:
    """Does an assignment's ``info`` mark the trial as continuing saved
    state (a preemption resume, a promoted parent or a checkpoint fork)?
    The one home of this rule: ``TrialContext.needs_fresh_state`` and the
    executor's trial scope both read it."""
    return (info.get("resume_step") is not None
            or info.get("parent") is not None
            or info.get("forked_from") is not None)


class TrialContext:
    def __init__(self, trial_id: str, trial_dir: str, exp_dir: str,
                 params: Dict[str, Any], info: Optional[Dict[str, Any]] = None):
        info = dict(info or {})
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.exp_dir = exp_dir
        self.params = dict(params)
        self.info: Dict[str, Any] = info
        self._checkpointer = None

    # ----------------------------------------------------------- identity
    @property
    def budget(self) -> Optional[float]:
        """Multi-fidelity budget of this run (None if single-fidelity)."""
        b = self.info.get("run_budget", self.params.get("budget"))
        return None if b in (None, 0) else b

    @property
    def parent_trial_id(self) -> Optional[str]:
        """For a promoted ASHA/Hyperband trial or a PBT segment: the trial
        it continues."""
        return self.info.get("parent")

    @property
    def forked_from(self) -> Optional[Dict[str, Any]]:
        """``{"trial": <parent id>, "step": <checkpoint step>}`` when the
        driver dispatched this trial to resume from another trial's
        checkpoint (config.fork), else None (a from-scratch run)."""
        fork = self.info.get("forked_from")
        return dict(fork) if fork else None

    def stage_fork(self) -> Optional[int]:
        """Stage the forked-from parent's checkpoint into this trial's dir
        (idempotent, ``train.checkpoint.fork_checkpoint``). Returns the
        staged step, or None when there is nothing to fork. The executor
        calls it before the train function."""
        fork = self.info.get("forked_from")
        if not fork or not fork.get("trial"):
            return None
        from maggy_tpu_torch.core.environment import EnvSing
        from maggy_tpu_torch.train.checkpoint import fork_checkpoint

        return fork_checkpoint(EnvSing.get_instance(), self.exp_dir, fork["trial"],
                               self.trial_dir, step=fork.get("step"))

    @property
    def resume_step(self) -> Optional[int]:
        """The checkpoint step to resume from (restore with
        ``restore_checkpoint`` and continue at ``resume_step + 1``): a
        fork's step, or the step a preempted trial had checkpointed. None =
        a fresh run."""
        step = self.info.get("resume_step")
        return None if step is None else int(step)

    @property
    def gang(self):
        """For a gang-scheduled multi-chip trial: the assembled
        ``gang.GangContext`` the driver stamped into the assignment (member
        chips, mesh axes, strategy, ``sharding_env()``). None for a 1-chip
        trial, so a train function can branch on it."""
        info = self.info.get("gang")
        if not info:
            return None
        from maggy_tpu_torch.gang import GangContext

        # This member's own partition rides along: a remote gang resolves
        # its process's rank from it.
        return GangContext({**info, "partition": info.get("partition",
                                                          self.info.get("partition"))})

    @property
    def needs_fresh_state(self) -> bool:
        """True when this trial continues saved state (a resume, a
        promotion or a fork): it restores its checkpoint into freshly
        built state."""
        return info_needs_fresh_state(self.info)

    # ------------------------------------------------------- checkpointing
    def checkpointer(self):
        if self._checkpointer is None:
            from maggy_tpu_torch.train.checkpoint import TrialCheckpointer

            self._checkpointer = TrialCheckpointer(self.trial_dir)
        return self._checkpointer

    def save_checkpoint(self, step: int, state: Any) -> None:
        """Checkpoint ``step`` (skipped when this trial already holds that
        step or a later one, as a staged fork may). The time is recorded
        whole (``save_ms``) and, apart, its wait for the process's
        checkpoint lock (``save_lock_ms``)."""
        from maggy_tpu_torch.train.checkpoint import last_lock_wait_ms

        t0 = time.perf_counter()
        try:
            self.checkpointer().save(step, state)
        finally:
            _note_ckpt(save_ms=(time.perf_counter() - t0) * 1e3,
                       save_lock_ms=last_lock_wait_ms(), saves=1)

    def restore_checkpoint(self, template: Any) -> Optional[Any]:
        """This trial's newest checkpoint on the template's device (None if
        absent)."""
        from maggy_tpu_torch.train.checkpoint import has_checkpoints, last_lock_wait_ms

        if not has_checkpoints(self.trial_dir):
            return None

        t0 = time.perf_counter()
        try:
            return self.checkpointer().restore(template)
        finally:
            _note_ckpt(restore_ms=(time.perf_counter() - t0) * 1e3,
                       restore_lock_ms=last_lock_wait_ms(), restores=1)

    def restore_parent(self, template: Any) -> Optional[Any]:
        """Warm-start from the parent's newest checkpoint (None if this
        trial has no parent or the parent saved nothing)."""
        parent = self.parent_trial_id
        if parent is None:
            return None
        from maggy_tpu_torch.train.checkpoint import last_lock_wait_ms, restore_parent_state

        t0 = time.perf_counter()
        try:
            return restore_parent_state(self.exp_dir, parent, template)
        finally:
            _note_ckpt(restore_ms=(time.perf_counter() - t0) * 1e3,
                       restore_lock_ms=last_lock_wait_ms(), restores=1)

    def close(self) -> None:
        if self._checkpointer is not None:
            self._checkpointer.close()
            self._checkpointer = None


class LaneSet:
    """The train function's view of a vectorized K-lane block
    (``config.vmap_lanes`` > 1; JAX ``context.py:199-245``): the lanes'
    hyperparameters to stack into a ``VmapTrainer``, the lanes the driver
    stopped, and ``retire``, which sends a lane's own FINAL. A train
    function opts in by naming a ``lanes`` parameter; without it the
    executor runs the block's lanes one after another as scalar trials."""

    def __init__(self, lanes, reporter, finalize):
        # Lane descriptors in lane order: {"trial_id", "lane", "params",
        # "span", "epoch", "fork_lane"} from the block's TRIAL info.
        self.lanes = [dict(entry) for entry in lanes]
        self.reporter = reporter
        self._finalize = finalize
        self._by_id = {entry["trial_id"]: i for i, entry in enumerate(self.lanes)}

    def __len__(self) -> int:
        return len(self.lanes)

    @property
    def trial_ids(self):
        return [entry["trial_id"] for entry in self.lanes]

    @property
    def hparams(self):
        """Each lane's params, in lane order."""
        return [dict(entry.get("params") or {}) for entry in self.lanes]

    def lane_of(self, trial_id: str) -> int:
        return self._by_id[trial_id]

    def take_stopped(self):
        """Lane indices newly stopped by the driver, each once: mask them
        (``VmapTrainer.mask_lane``), then ``retire`` each with its metric."""
        return [self._by_id[tid] for tid in self.reporter.take_stopped_lanes()
                if tid in self._by_id]

    def retire(self, lane: int, metric) -> None:
        """Send lane ``lane``'s FINAL now, mid-block: its span closes when it
        stopped contributing, so the masked tail is billed as ``lane_idle``.
        Lanes never retired here are finalized when the function returns."""
        self._finalize(self.lanes[lane], metric)
