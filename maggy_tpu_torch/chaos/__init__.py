"""Chaos engine: deterministic fault injection + journal-checked recovery.

The port's ``maggy_tpu/chaos``: the fault-tolerance claims (runner death
survived, trials requeued, RPC retried, preemption tolerated) become seeded
inputs instead of incidental races.

- ``plan``      — the declarative JSON ``FaultPlan`` (kill, stall or preempt
                  a runner, drop, delay or sever messages, fail env writes),
                  expanded deterministically from one seed; a plan file
                  drives either package the same way;
- ``injectors`` — the ``ChaosEngine`` behind no-op-by-default hooks in the
                  RPC server and client, the runner pools, the heartbeat
                  bookkeeping and the environment's writes; armed through
                  ``config.chaos`` or ``MAGGY_TPU_CHAOS=<plan.json>``;
- ``harness``   — soaks that run a lagom experiment under a plan, journal
                  every injection, replay the telemetry journal and check
                  the recovery invariants;
- CLI           — ``python -m maggy_tpu_torch.chaos --seed 7 [--plan p.json]``.
"""

from maggy_tpu_torch.chaos.injectors import (ChaosEngine, ChaosKilled,
                                             active_engine, arm, disarm)
from maggy_tpu_torch.chaos.plan import KINDS, RUNNER_KINDS, FaultPlan, FaultSpec

__all__ = [
    "FaultPlan", "FaultSpec", "KINDS", "RUNNER_KINDS",
    "ChaosEngine", "ChaosKilled", "active_engine", "arm", "disarm",
    # lazy (import cycle: the harness pulls in the experiment stack, which
    # pulls in the RPC layer, which imports chaos.injectors):
    "default_plan", "run_soak", "check_invariants", "assert_invariants",
]

_HARNESS_NAMES = ("default_plan", "run_soak", "check_invariants",
                  "assert_invariants")


def __getattr__(name):
    if name in _HARNESS_NAMES:
        from maggy_tpu_torch.chaos import harness

        return getattr(harness, name)
    raise AttributeError("module {!r} has no attribute {!r}".format(
        __name__, name))
