"""The port's weighted-share and slow-tenant fleet soaks against maggy_tpu's
on the CPU, at their defaults and one seed: both packages' soaks pass,
finish every tenant's trials, and journal what each other's replay and
invariant checker read back to the same numbers. The port's slow-tenant
soak runs through ``python -m maggy_tpu_torch.fleet soak --slow-tenant``.
Shares and round trips are wall-clock measurements, so they are held to
the soaks' own bounds, not compared across the packages; every other
comparison is exact."""

import json
import tempfile

import pytest

from maggy_tpu.chaos.harness import check_invariants as jax_check_invariants
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.fleet import scheduler as jax_scheduler
from maggy_tpu.fleet import soak as jax_soak
from maggy_tpu.telemetry import read_events as jax_read_events

from maggy_tpu_torch.chaos.harness import check_invariants
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv
from maggy_tpu_torch.fleet import scheduler, soak
from maggy_tpu_torch.fleet.__main__ import main as fleet_main
from maggy_tpu_torch.telemetry import read_events

pytestmark = [pytest.mark.torch, pytest.mark.timeout(90)]


@pytest.fixture(autouse=True)
def envs(tmp_path):
    EnvSing.set_instance(LocalEnv(base_dir=str(tmp_path / "port_env")))
    JaxEnvSing.set_instance(JaxLocalEnv(base_dir=str(tmp_path / "jax_env")))
    yield
    EnvSing.reset()
    JaxEnvSing.reset()


def test_weighted_share_soak_as_jax(tmp_path):
    """Three resident tenants weighted 1/1/2 on four runners: both soaks
    pass (12 trials a tenant, within the 0.35 share-error bound), and each
    fleet journal replays to the same shares through either package."""
    weights = {"res_a": 1.0, "res_b": 1.0, "res_c": 2.0}
    out = {name: mod.run_weighted_share_soak(seed=7, base_dir=str(tmp_path / name))
           for name, mod in (("port", soak), ("jax", jax_soak))}
    for name, report in out.items():
        assert report["ok"], (name, report["violations"])
        assert report["detail"]["expected_share"] == \
            {"res_a": 0.25, "res_b": 0.25, "res_c": 0.5}, name
        assert report["detail"]["share_error"] <= 0.35, name
        journal = report["journal"]
        port = scheduler.replay_fleet_journal(journal, share_names=set(weights))
        jax = jax_scheduler.replay_fleet_journal(journal, share_names=set(weights))
        assert port == jax, name
        assert port["share"] == report["detail"]["share"], name
        assert set(port["experiments"]) == set(weights), name


def test_slow_tenant_soak_through_the_cli_as_jax(tmp_path, capsys, monkeypatch):
    """One tenant's handlers delayed 150 ms a message beside two victims on
    the shared listener: both soaks pass (victims' hand-off p95 under
    150 ms, heartbeat round trips under 50 ms, single FINALs), the fault
    was injected, and each tenant journal gives the same invariant report
    through either package's checker."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "cli"))
    (tmp_path / "cli").mkdir()
    capsys.readouterr()
    rc = fleet_main(["soak", "--slow-tenant", "--seed", "7"])
    port = json.loads(capsys.readouterr().out)
    assert rc == 0, port["violations"]
    jax = jax_soak.run_slow_tenant_soak(seed=7, base_dir=str(tmp_path / "jax"))
    for name, report in (("port", port), ("jax", jax)):
        assert report["ok"], (name, report["violations"])
        detail = report["detail"]
        assert detail["injections"] > 0, name
        assert set(detail["victim_handoff_p95_ms"]) == {"victim0", "victim1"}, name
        assert max(detail["victim_handoff_p95_ms"].values()) <= 150.0, name
        assert max(detail["victim_reply_rtt_ms"].values()) <= 50.0, name
        assert set(report["journals"]) == {"slow", "victim0", "victim1"}, name
        for tenant, journal in report["journals"].items():
            events = read_events(journal)
            assert events == jax_read_events(journal), (name, tenant)
            mine = check_invariants(events, stall_flag_bound_s=None)
            assert mine == jax_check_invariants(events, stall_flag_bound_s=None), \
                (name, tenant)
            assert mine["violations"] == [], (name, tenant)
            want = 2 if tenant == "slow" else 6
            assert mine["trials"] == {"queued": want, "finalized": want,
                                      "requeued": 0}, (name, tenant)


def test_scale_churn_with_the_sink_replays_as_jax(tmp_path):
    """A small churn (16 cheap tenants, 4 through the spool) with every
    tenant shipping its journal to the sink: all complete, and the fleet
    journal (its jsink ingest records included) replays to the same
    numbers through either package."""
    report = soak.run_scale_churn(experiments=16, runners=2, max_active=4, spool_specs=4,
                                  base_dir=str(tmp_path), sink=True, result_timeout_s=60.0,
                                  min_decisions_per_s=0.0)
    assert report["ok"], report["violations"]
    assert report["detail"]["completed"] == 16 and report["detail"]["spooled"] == 4
    replay = scheduler.replay_fleet_journal(report["journal"])
    assert replay == jax_scheduler.replay_fleet_journal(report["journal"])
    assert replay["sink"]["sources"] == 16 and replay["sink"]["dup"] == 0


def test_remote_scale_soak_on_agent_processes(tmp_path):
    """The churn driven by two agent processes (--device cpu) with the
    sink on: every tenant completes, remote leases happened, and the
    unified trace carries both agents' process groups and flow arrows."""
    report = soak.run_remote_scale_soak(experiments=6, agents=2, runners=1, max_active=3,
                                        base_dir=str(tmp_path), result_timeout_s=60.0)
    assert report["ok"], report["violations"]
    detail = report["detail"]
    assert detail["completed"] == 6 and detail["agent_joins"] == 2
    assert detail["remote_leases"] >= 1
    assert detail["unified"]["agents"] == 2 and detail["unified"]["flows"] >= 1


def test_scale_soak_composes_its_parts(tmp_path):
    """The scale scenario at a small size without its sink A/B: the churn,
    the weighted share and the slow-tenant soak each pass."""
    report = soak.run_scale_soak(experiments=8, runners=2, max_active=4, sink_ab=False,
                                 base_dir=str(tmp_path),
                                 churn_kwargs={"spool_specs": 2, "min_decisions_per_s": 0.0,
                                               "result_timeout_s": 60.0})
    assert report["ok"], report["violations"]
    assert report["detail"]["churn"]["completed"] == 8
    assert report["detail"]["sink"] is None
    assert set(report["detail"]) == {"churn", "sink", "share", "slow_tenant"}
