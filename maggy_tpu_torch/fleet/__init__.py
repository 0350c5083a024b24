"""Shared-fleet scheduling: multiplex concurrent experiments over one
persistent runner fleet (see scheduler.py for the design).

    from maggy_tpu_torch.fleet import Fleet
    from maggy_tpu_torch import experiment

    with Fleet(runners=8) as fleet:
        a = experiment.lagom_submit(train_a, cfg_a, fleet=fleet,
                                    weight=2.0, block=False)
        b = experiment.lagom_submit(train_b, cfg_b, fleet=fleet,
                                    priority="high", min_runners=2,
                                    block=False)
        results = a.result(), b.result()

CLI: ``python -m maggy_tpu_torch.fleet start|submit|status|soak|agent``
(spool-file submissions for use from other processes, and agent processes
that ``Fleet(max_agents=N)`` leases like runners); live view:
``python -m maggy_tpu_torch.monitor --fleet <home_dir>``. The port's copy of
``maggy_tpu/fleet/__init__.py``.
"""

from maggy_tpu_torch.fleet.agent import (AGENT_TICKET_NAME, AgentPlane, FleetAgent,
                                         read_fleet_ticket)

from maggy_tpu_torch.fleet.scheduler import (FLEET_JOURNAL_NAME, ExperimentEntry, Fleet,
                                             FleetBinding, FleetLeasedPool, FleetPolicy,
                                             FleetSaturated, FleetScheduler, FleetSubmission,
                                             priority_rank, replay_fleet_journal)

__all__ = [
    "Fleet", "FleetPolicy", "FleetSaturated", "FleetScheduler",
    "FleetBinding", "FleetLeasedPool", "FleetSubmission",
    "ExperimentEntry", "FLEET_JOURNAL_NAME", "priority_rank",
    "replay_fleet_journal",
    "AgentPlane", "FleetAgent", "AGENT_TICKET_NAME", "read_fleet_ticket",
]
