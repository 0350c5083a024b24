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
Gang contexts and the vectorized ``LaneSet`` are not ported yet (ROADMAP
queue 1 items 8 and 7).
"""

from __future__ import annotations

import os
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
        if info.get("gang"):
            raise NotImplementedError(
                "gang-scheduled trials are not ported yet (ROADMAP queue 1 item 8)")
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
        if not os.path.isdir(os.path.join(self.trial_dir, "checkpoints")):
            return None
        from maggy_tpu_torch.train.checkpoint import last_lock_wait_ms

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
