"""The port's chaos engine against the JAX package's on the CPU: plan
fingerprints and the engine's live decisions equal for the same plan and
seed, ``check_invariants`` equal as dicts on synthetic journals (the gang,
fleet and driver-kill shapes included) and on one journal made by each
package's soak, each injector kind in isolation, the client's counted
backoff, and every ported soak run with closed-form trials (default,
piggyback, preempt, fork, goodput and vmap on thread runners, the default
soak on process runners) with zero violations. The stall soak is in
tests/test_torch_health.py, the stall soak with the obs plane in
tests/test_torch_obs.py."""

import json
import socket
import threading
import time

import pytest

from maggy_tpu.chaos import FaultPlan as JaxFaultPlan
from maggy_tpu.chaos import FaultSpec as JaxFaultSpec
from maggy_tpu.chaos import disarm as jax_disarm
from maggy_tpu.chaos import harness as jax_harness
from maggy_tpu.chaos.injectors import ChaosEngine as JaxChaosEngine
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv

from maggy_tpu_torch.chaos import (ChaosEngine, ChaosKilled, FaultPlan, FaultSpec, arm,
                                   disarm)
from maggy_tpu_torch.chaos import harness
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.core.rpc import Client, Reservations
from maggy_tpu_torch.core.runner_pool import ProcessRunnerPool, ThreadRunnerPool
from maggy_tpu_torch.telemetry import Telemetry, read_events

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

PLAN_FACTORIES = ("default_plan", "piggyback_plan", "stall_plan", "preempt_plan",
                  "fork_plan", "vmap_plan")


@pytest.fixture(autouse=True)
def local_env(tmp_path):
    env = LocalEnv(base_dir=str(tmp_path / "exp"))
    EnvSing.set_instance(env)
    JaxEnvSing.set_instance(JaxLocalEnv(base_dir=str(tmp_path / "jax_exp")))
    yield env
    EnvSing.reset()
    JaxEnvSing.reset()


@pytest.fixture(autouse=True)
def no_stale_engine():
    """Every test starts and ends unarmed in both packages."""
    disarm()
    jax_disarm()
    yield
    disarm()
    jax_disarm()


def _engine(*specs, seed=0):
    return ChaosEngine(FaultPlan(list(specs), seed=seed))


# --------------------------------------------------------------------- plans


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("factory", PLAN_FACTORIES)
def test_builtin_plans_and_schedules_equal_jax(factory, seed):
    port, jax = getattr(harness, factory)(seed), getattr(jax_harness, factory)(seed)
    assert port.to_json() == jax.to_json()
    assert json.dumps(port.fingerprint(draws=256)) == json.dumps(jax.fingerprint(draws=256))


@pytest.mark.parametrize("seed", [1, 9, 2024])
def test_plan_json_drives_both_engines_identically(seed):
    """One plan file, both packages: the same fingerprint and, over one
    message stream, the same live decisions in the same order."""
    text = json.dumps({"seed": seed, "faults": [
        {"kind": "drop_msg", "target": {"verb": "METRIC"}, "trigger": {"probability": 0.3}},
        {"kind": "delay_msg", "target": {"verb": "FINAL"}, "trigger": {"every_nth": 3},
         "delay_s": 0.01},
        {"kind": "sever_conn", "target": {"verb": "GET", "partition": 1},
         "trigger": {"probability": 0.5}},
        {"kind": "kill_runner", "trigger": {"on_phase": "running", "nth": 2}}]})
    port, jax = FaultPlan.from_json(text), JaxFaultPlan.from_json(text)
    assert port.to_json() == jax.to_json()
    assert json.dumps(port.fingerprint()) == json.dumps(jax.fingerprint())
    engines = ChaosEngine(port), JaxChaosEngine(jax)
    stream = [{"type": verb, "partition_id": pid}
              for i in range(200)
              for verb, pid in [(("METRIC", "FINAL", "GET")[i % 3], i % 3)]]
    decisions = [[e.on_server_message(dict(m)) for m in stream] for e in engines]
    assert decisions[0] == decisions[1]
    assert [{k: v for k, v in r.items() if k != "t"} for r in engines[0].injected] == \
        [{k: v for k, v in r.items() if k != "t"} for r in engines[1].injected]


BAD_SPECS = [
    dict(kind="no_such_kind", trigger={"nth": 1}),
    dict(kind="drop_msg", trigger={"bogus": 1}),
    dict(kind="drop_msg"),
    dict(kind="drop_msg", trigger={"nth": 1, "probability": 0.5}),
    dict(kind="kill_runner", trigger={"nth": 1}),
    dict(kind="kill_runner", trigger={"after_s": 1.0}),
    dict(kind="drop_msg", trigger={"after_s": 1.0}),
    dict(kind="stall_runner", trigger={"on_phase": "not_a_phase"}),
]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_invalid_specs_refused_like_jax(spec):
    with pytest.raises(ValueError) as port_err:
        FaultSpec(**spec)
    with pytest.raises(ValueError) as jax_err:
        JaxFaultSpec(**spec)
    assert str(port_err.value) == str(jax_err.value)


def test_plan_load_through_env(local_env, tmp_path):
    path = str(tmp_path / "plan.json")
    local_env.dump(harness.default_plan(5).to_json(), path)
    assert FaultPlan.load(path, env=local_env).to_json() == harness.default_plan(5).to_json()


# ------------------------------------------------------------------ injectors


def test_drop_probability_matches_fingerprint():
    plan = FaultPlan([FaultSpec("drop_msg", target={"verb": "METRIC"},
                                trigger={"probability": 0.3})], seed=9)
    engine = ChaosEngine(plan)
    decisions = [engine.on_server_message({"type": "METRIC", "partition_id": 0}) is not None
                 for _ in range(64)]
    assert decisions == plan.fingerprint(draws=64)[0]["decisions"]
    # A verb that does not match consumes no draw.
    assert engine.on_server_message({"type": "GET"}) is None


def test_delay_sever_and_partition_target():
    engine = _engine(FaultSpec("delay_msg", target={"verb": "FINAL"}, trigger={"nth": 1},
                               delay_s=0.25),
                     FaultSpec("sever_conn", target={"verb": "GET"}, trigger={"every_nth": 2}),
                     FaultSpec("drop_msg", target={"verb": "METRIC", "partition": 1},
                               trigger={"every_nth": 1}))
    assert engine.on_server_message({"type": "FINAL"}) == ("delay", 0.25)
    assert engine.on_server_message({"type": "FINAL"}) is None
    assert engine.on_server_message({"type": "GET"}) is None
    assert engine.on_server_message({"type": "GET"}) == ("sever",)
    assert engine.on_server_message({"type": "METRIC", "partition_id": 0}) is None
    assert engine.on_server_message({"type": "METRIC", "partition_id": 1}) == ("drop",)


def test_cooperative_kill_raises_chaos_killed():
    engine = _engine(FaultSpec("kill_runner", trigger={"on_phase": "running"}))
    engine.on_trial_phase("t1", "running", partition=2)
    assert engine.injected[0]["kind"] == "kill_runner"
    assert engine.injected[0]["trial"] == "t1"
    assert engine.injected[0]["mechanism"] == "cooperative"
    with pytest.raises(ChaosKilled):
        engine.on_client_request({"type": "GET", "partition_id": 2})
    engine.on_client_request({"type": "GET", "partition_id": 0})
    # The heartbeat loop swallows ConnectionError: a condemned runner's
    # beats go silent instead of crashing its beat thread.
    assert issubclass(ChaosKilled, ConnectionError)


def test_cooperative_stall_blocks_then_releases():
    engine = _engine(FaultSpec("stall_runner", target={"partition": 0},
                               trigger={"on_phase": "running"}, duration_s=0.2))
    engine.on_trial_phase("t1", "running", partition=0)
    t0 = time.monotonic()
    engine.on_client_request({"type": "METRIC", "partition_id": 0})
    assert time.monotonic() - t0 >= 0.15
    t1 = time.monotonic()
    engine.on_client_request({"type": "METRIC", "partition_id": 0})
    assert time.monotonic() - t1 < 0.1


def test_fake_preemption_ages_mutes_and_suppresses_reap():
    res = Reservations()
    res.add({"partition_id": 0})
    engine = _engine(FaultSpec("fake_preemption", target={"partition": 0},
                               trigger={"on_phase": "first_metric"}, duration_s=0.3))
    engine.attach(reservations=res)
    assert not res.is_silent(0, 1.0) and not engine.suppress_reap(0)
    engine.on_trial_phase("t1", "first_metric", partition=0)
    assert res.is_silent(0, 1.0)
    # Beats are muted for the fault's window: the silence sticks.
    res.touch(0)
    assert res.is_silent(0, 1.0)
    assert engine.suppress_reap(0) and not engine.suppress_reap(1)
    time.sleep(0.35)
    res.touch(0)
    assert not res.is_silent(0, 1.0) and not engine.suppress_reap(0)


def test_env_write_fail_is_transient_and_spares_the_journal(local_env, tmp_path):
    jpath = str(tmp_path / "exp" / "telemetry.jsonl")
    telem = Telemetry(env=local_env, journal_path=jpath)
    try:
        arm(ChaosEngine(FaultPlan([FaultSpec("env_write_fail", target={"path": ".hparams"},
                                             trigger={"nth": 1}, count=1),
                                   FaultSpec("env_write_fail", target={"path": "telemetry"},
                                             trigger={"every_nth": 1})], seed=0),
                        telemetry=telem))
        local_env.dump("{}", jpath)  # the journal's own path: exempt
        target = str(tmp_path / "x" / ".hparams.json")
        with pytest.raises(OSError, match="chaos"):
            local_env.dump("{}", target)
        local_env.dump("{}", str(tmp_path / "x" / "other.json"))
        local_env.dump("{}", target)
        with pytest.raises(OSError, match="chaos"):
            local_env.exclusive_create("{}", str(tmp_path / "telemetry.claim"))
    finally:
        disarm()
        telem.close()


def test_kill_prefers_pool_kill_and_after_s_is_one_shot():
    class FakePool(ThreadRunnerPool):
        def __init__(self):
            super().__init__(1)
            self.killed = []

        def kill_worker(self, pid):
            self.killed.append(pid)
            return True

    pool = FakePool()
    res = Reservations()
    res.add({"partition_id": 3})
    res.assign_trial(3, "t_held")
    engine = _engine(FaultSpec("kill_runner", target={"partition": 3},
                               trigger={"after_s": 0.0}))
    engine.attach(pool=pool, reservations=res)
    engine.tick()
    engine.tick()
    assert pool.killed == [3]
    # A timed kill names the trial its partition holds.
    assert [(e["mechanism"], e["trial"]) for e in engine.injected] == [("sigkill", "t_held")]


def test_after_s_rearms_per_interval():
    engine = _engine(FaultSpec("fake_preemption", target={"partition": 0},
                               trigger={"after_s": 3600.0}, count=3))
    engine._t0 -= 3700.0  # one interval elapsed, not two
    engine.tick()
    engine.tick()
    assert len(engine.injected) == 1


def test_pools_stall_only_processes():
    assert ThreadRunnerPool(2).stall_worker(0, 0.1) is False
    assert ThreadRunnerPool(2).kill_worker(0) is False
    # No process started yet: nothing to stop.
    assert ProcessRunnerPool(2).stall_worker(0, 0.1) is False


def test_partitionless_phase_event_does_not_misfire():
    engine = _engine(FaultSpec("kill_runner", trigger={"on_phase": "running", "nth": 1}))
    engine.on_trial_phase("t1", "running", partition=None)
    assert engine.injected == []
    engine.on_trial_phase("t2", "running", partition=1)
    assert [e["partition"] for e in engine.injected] == [1]


def test_gang_member_kill_is_refused():
    """The fault fires: it kills the lowest non-leader member of the gang
    the driver reports, cooperatively on a thread pool, and journals the
    leader beside the victim, as the JAX engine does. (The name is kept
    from when the port refused the fault, so the test's history stays
    one.)"""
    class _Driver:
        def gang_members(self, trial):
            return [0, 2, 3] if trial == "t1" else []

    engine = _engine(FaultSpec("kill_gang_member",
                               trigger={"on_phase": "gang_assembled"}))
    engine.driver = _Driver()
    engine.on_trial_phase("t1", "gang_assembled", partition=0)
    (fired,) = engine.injected
    assert fired["partition"] == 2 and fired["leader"] == 0
    assert fired["mechanism"] == "cooperative"


def test_a_unit_that_drops_its_graphs_takes_a_fresh_pool():
    """Found by the fork and preempt soaks on the card: a restored
    checkpoint reloads the optimizer, the unit drops its graphs, and a
    capture into the retired pool's handle failed in the allocator."""
    import torch

    from maggy_tpu_torch.train.trainer import _Unit

    model = torch.nn.Linear(2, 2)
    unit = _Unit(model, torch.optim.SGD(model.parameters(), lr=0.1), {})
    unit.pool, unit.graphs[("x",)], unit.warmed = (0, 1), object(), {("x",)}
    unit.drop_graphs()
    assert unit.pool is None and not unit.graphs and not unit.warmed


def test_telemetry_forwards_phases_to_the_armed_engine():
    telem = Telemetry()
    engine = _engine(FaultSpec("kill_runner", trigger={"on_phase": "running", "nth": 2}))
    telem.chaos_hook = engine.on_trial_phase
    for i in range(3):
        telem.trial_event("t{}".format(i), "running", partition=i)
    assert [(e["trial"], e["partition"]) for e in engine.injected] == [("t1", 1)]
    # The event stamps the partition's progress for the hang watchdog.
    assert telem.last_progress(2) is not None and telem.last_progress(7) is None


# ------------------------------------------------------------ client backoff


def _flaky_server():
    """A listener that accepts and at once closes every connection."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                srv.settimeout(0.2)
                conn, _ = srv.accept()
                conn.close()
            except OSError:
                continue

    threading.Thread(target=loop, daemon=True).start()
    return srv, stop


def test_retries_exhaust_with_counted_backoff(monkeypatch):
    """The backoff patched through the rpc module's own sleep, counted for
    this thread alone: another client's backoff in the same process (a
    soak's leftover thread) cannot add to the count."""
    from maggy_tpu_torch import constants

    srv, stop = _flaky_server()
    me, delays = threading.get_ident(), []

    def fake_sleep(s):
        if threading.get_ident() == me:
            delays.append(s)

    monkeypatch.setattr(rpc, "_sleep", fake_sleep)
    try:
        client = Client(srv.getsockname(), partition_id=0, hb_interval=1.0, secret="s")
        r0, c0 = (rpc.CLIENT_METRICS.counter(k).value
                  for k in ("rpc.client.retries", "rpc.client.reconnects"))
        with pytest.raises(ConnectionError, match="after retries"):
            client._request({"type": "GET"})
        assert rpc.CLIENT_METRICS.counter("rpc.client.reconnects").value - c0 \
            >= constants.CLIENT_MAX_RETRIES
        assert rpc.CLIENT_METRICS.counter("rpc.client.retries").value - r0 \
            >= constants.CLIENT_MAX_RETRIES
        assert len(delays) == constants.CLIENT_MAX_RETRIES
        for i, d in enumerate(delays):
            lo = constants.CLIENT_RETRY_BACKOFF_BASE_S * (2 ** i) / 2
            hi = min(constants.CLIENT_RETRY_BACKOFF_BASE_S * (2 ** i),
                     constants.CLIENT_RETRY_BACKOFF_CAP_S)
            assert lo <= d <= hi, (i, d)
    finally:
        stop.set()
        srv.close()


def test_a_condemned_client_dies_without_retrying(monkeypatch):
    """No backoff (counted for this thread alone, through the rpc
    module's sleep) and so no reconnect before ChaosKilled."""
    srv, stop = _flaky_server()
    me, delays = threading.get_ident(), []
    monkeypatch.setattr(rpc, "_sleep",
                        lambda s: delays.append(s) if threading.get_ident() == me else None)
    try:
        client = Client(srv.getsockname(), partition_id=4, hb_interval=1.0, secret="s")
        engine = _engine(FaultSpec("kill_runner", trigger={"on_phase": "running"}))
        engine.on_trial_phase("t", "running", partition=4)
        arm(engine)
        with pytest.raises(ChaosKilled):
            client._request({"type": "GET"})
        assert delays == []
    finally:
        stop.set()
        srv.close()


# ------------------------------------------------------------ the checker


def _t(t, trial, phase, **kw):
    return {"t": t, "ev": "trial", "trial": trial, "phase": phase, **kw}


END = {"t": 99.0, "ev": "experiment", "phase": "end"}
ENGINE = {"t": 0.1, "ev": "health", "check": "engine", "status": "started"}

JOURNALS = {
    "clean": [_t(1.0, "a", "queued"), _t(1.1, "a", "running", partition=0),
              _t(2.0, "a", "finalized", partition=0), END],
    "lost_and_duplicate": [_t(1.0, "a", "queued"), _t(1.0, "b", "queued"),
                           _t(2.0, "b", "finalized"), _t(2.5, "b", "finalized"),
                           _t(3.0, "c", "finalized"), END],
    "no_experiment_end": [_t(1.0, "a", "queued"), _t(2.0, "a", "finalized")],
    "kill_unrequeued": [_t(1.0, "a", "queued"), _t(1.2, "a", "running", partition=0),
                        {"t": 1.5, "ev": "chaos", "kind": "kill_runner", "trial": "a",
                         "partition": 0},
                        _t(2.0, "a", "finalized", partition=0), END],
    "kill_healed": [_t(1.0, "a", "queued"), _t(1.2, "a", "running", partition=0),
                    {"t": 1.5, "ev": "chaos", "kind": "kill_runner", "trial": "a",
                     "partition": 0},
                    _t(2.2, "a", "lost", partition=0),
                    _t(2.2, "a", "requeued", partition=0, reason="heartbeat_loss"),
                    _t(2.3, "a", "running", partition=1),
                    _t(2.6, "a", "finalized", partition=1), END],
    "duplicate_requeue": [_t(1.0, "a", "queued"), _t(1.2, "a", "running", partition=0),
                          {"t": 1.5, "ev": "chaos", "kind": "kill_runner", "trial": "a",
                           "partition": 0},
                          _t(2.2, "a", "requeued", reason="heartbeat_loss"),
                          _t(2.4, "a", "requeued", reason="heartbeat_loss"),
                          _t(2.6, "a", "finalized", partition=1), END],
    "fake_preemption_outrun": [_t(1.0, "a", "queued"),
                               {"t": 1.5, "ev": "chaos", "kind": "fake_preemption",
                                "trial": "a", "partition": 0},
                               _t(1.6, "a", "finalized", partition=0), END],
    "preempt_wrong_step": [_t(1.0, "a", "queued"),
                           {"t": 1.5, "ev": "chaos", "kind": "preempt_trial", "trial": "a",
                            "partition": 0},
                           _t(1.6, "a", "preempted", step=3, checkpointed=True),
                           _t(1.7, "a", "requeued", reason="preempted"),
                           _t(1.9, "a", "resumed", from_step=0),
                           _t(2.6, "a", "finalized"), END],
    "preempt_resumed": [_t(1.0, "a", "queued"),
                        {"t": 1.5, "ev": "chaos", "kind": "preempt_trial", "trial": "a",
                         "partition": 0},
                        _t(1.6, "a", "preempted", step=3, checkpointed=True),
                        _t(1.7, "a", "requeued", reason="preempted"),
                        _t(1.9, "a", "resumed", from_step=3),
                        _t(2.6, "a", "finalized"), END],
    "preempt_unacked": [_t(1.0, "a", "queued"),
                        {"t": 1.5, "ev": "chaos", "kind": "preempt_trial", "trial": "a",
                         "partition": 0}, END],
    "stall_flagged": [ENGINE, _t(1.0, "a", "queued"),
                      {"t": 2.0, "ev": "chaos", "kind": "stall_runner", "partition": 1,
                       "duration_s": 2.0},
                      {"t": 3.1, "ev": "health", "check": "hang", "partition": 1,
                       "status": "raised"},
                      _t(6.0, "a", "finalized"), END],
    "stall_late_wrong_cleared": [ENGINE, _t(1.0, "a", "queued"),
                                 {"t": 2.0, "ev": "chaos", "kind": "stall_runner",
                                  "partition": 1},
                                 {"t": 2.5, "ev": "health", "check": "hang", "partition": 0,
                                  "status": "raised"},
                                 {"t": 2.6, "ev": "health", "check": "hang", "partition": 1,
                                  "status": "cleared"},
                                 {"t": 40.0, "ev": "health", "check": "straggler",
                                  "partition": 1, "status": "raised"},
                                 _t(6.0, "a", "finalized"), END],
    "stall_without_engine": [_t(1.0, "a", "queued"),
                             {"t": 2.0, "ev": "chaos", "kind": "stall_runner", "partition": 1},
                             _t(6.0, "a", "finalized"), END],
    "obs_captures": [ENGINE, {"t": 0.2, "ev": "obs_started", "port": 1},
                     _t(1.0, "a", "queued"),
                     {"t": 2.0, "ev": "chaos", "kind": "stall_runner", "partition": 1},
                     {"t": 2.1, "ev": "chaos", "kind": "stall_runner", "partition": 2},
                     {"t": 2.5, "ev": "health", "check": "hang", "partition": 1,
                      "status": "raised"},
                     {"t": 2.6, "ev": "health", "check": "hang", "partition": 2,
                      "status": "raised"},
                     {"t": 2.7, "ev": "profile_captured", "reason": "auto", "partition": 1},
                     {"t": 2.8, "ev": "profile_captured", "reason": "auto", "partition": 1},
                     {"t": 2.9, "ev": "profile_captured", "reason": "manual"},
                     _t(6.0, "a", "finalized"), END],
    "gang_revoked": [_t(1.0, "g", "queued"),
                     _t(1.1, "g", "gang_assembled", partition=0, members=[0, 1]),
                     {"t": 1.2, "ev": "chaos", "kind": "kill_gang_member", "trial": "g",
                      "partition": 1, "leader": 0},
                     _t(2.0, "g", "gang_released", partition=0),
                     _t(2.0, "g", "requeued", reason="gang_member_lost"),
                     _t(2.5, "g", "gang_assembled", partition=2, members=[2, 3]),
                     _t(3.0, "g", "finalized", partition=2), END],
    "gang_broken": [_t(1.0, "g", "queued"), _t(1.0, "h", "queued"),
                    _t(1.1, "g", "gang_assembled", partition=0),
                    {"t": 1.2, "ev": "chaos", "kind": "kill_gang_member", "trial": "g",
                     "partition": 1, "leader": 0},
                    _t(2.0, "g", "requeued", reason="gang_member_lost"),
                    _t(2.1, "g", "requeued", reason="gang_member_lost"),
                    {"t": 2.2, "ev": "chaos", "kind": "kill_gang_member", "trial": "h",
                     "partition": 3, "leader": 2},
                    _t(3.0, "g", "finalized"), END],
    "fleet_agent_kill": [_t(1.0, "a", "queued"), _t(1.1, "a", "running", partition=0),
                         {"t": 1.5, "ev": "chaos", "kind": "kill_agent", "trial": "a",
                          "partition": 0, "agent": "agent-1"},
                         _t(3.0, "a", "requeued", reason="agent_lost"),
                         _t(3.5, "a", "running", partition=1),
                         _t(4.0, "a", "finalized", partition=1),
                         {"t": 5.0, "ev": "runner", "phase": "adopted", "partition": 1}, END],
    "driver_kill": [{"t": 0.0, "ev": "driver_epoch", "epoch": 1},
                    _t(1.0, "a", "queued"), _t(1.1, "a", "running", partition=0),
                    _t(1.5, "a", "finalized", partition=0),
                    _t(1.6, "b", "queued"), _t(1.7, "b", "running", partition=0),
                    {"t": 2.0, "ev": "chaos", "kind": "kill_driver"},
                    {"t": 3.0, "ev": "driver_epoch", "epoch": 2},
                    {"t": 3.1, "ev": "experiment", "phase": "recovered", "in_flight": 1},
                    {"t": 3.2, "ev": "runner", "phase": "adopted", "partition": 0},
                    _t(3.5, "b", "running", partition=0),
                    _t(4.0, "b", "finalized", partition=0), END],
    "driver_kill_blind_and_rerun": [{"t": 0.0, "ev": "driver_epoch", "epoch": 1},
                                    _t(1.0, "a", "queued"),
                                    _t(1.1, "a", "running", partition=0),
                                    _t(1.5, "a", "finalized", partition=0),
                                    {"t": 2.0, "ev": "chaos", "kind": "kill_driver"},
                                    {"t": 3.0, "ev": "driver_epoch", "epoch": 2},
                                    _t(3.5, "a", "running", partition=0), END],
    "driver_kill_no_restart": [_t(1.0, "a", "queued"), _t(1.5, "a", "finalized"),
                               {"t": 2.0, "ev": "chaos", "kind": "kill_driver"}, END],
    "fork_resumed": [_t(1.0, "p", "queued"), _t(1.1, "p", "running", partition=0),
                     _t(1.5, "p", "finalized", partition=0),
                     _t(1.6, "c", "queued", info={"parent": "p"}),
                     _t(1.7, "c", "assigned", partition=1),
                     _t(1.7, "c", "forked_from", partition=1, parent="p", step=3),
                     {"t": 1.8, "ev": "chaos", "kind": "kill_fork", "trial": "c",
                      "partition": 1},
                     _t(1.8, "c", "running", partition=1),
                     _t(2.5, "c", "lost", partition=1),
                     _t(2.5, "c", "requeued", partition=1, reason="heartbeat_loss"),
                     _t(2.6, "c", "assigned", partition=0),
                     _t(2.6, "c", "resumed", partition=0, from_step=3),
                     _t(2.7, "c", "running", partition=0),
                     _t(3.0, "c", "finalized", partition=0), END],
    "fork_drifted": [_t(1.0, "c", "queued", info={"parent": "p"}),
                     _t(1.7, "c", "forked_from", partition=1, parent="p", step=3),
                     _t(1.75, "c", "forked_from", partition=1, parent="p", step=3),
                     {"t": 1.8, "ev": "chaos", "kind": "kill_fork", "trial": "c",
                      "partition": 1},
                     _t(2.5, "c", "requeued", reason="heartbeat_loss"),
                     _t(2.6, "c", "resumed", from_step=1),
                     _t(3.0, "c", "finalized"),
                     _t(3.1, "d", "queued", info={"parent": "p"}),
                     _t(3.5, "d", "finalized"), END],
    "vmap_block_torn": [_t(1.0, "L", "queued"), _t(1.0, "m", "queued"),
                        _t(1.0, "n", "queued"),
                        _t(1.1, "L", "assigned", partition=0, block="L", lane=0),
                        _t(1.1, "m", "assigned", partition=0, block="L", lane=1),
                        _t(1.1, "n", "assigned", partition=0, block="L", lane=2),
                        _t(1.2, "L", "running", partition=0),
                        _t(1.2, "m", "running", partition=0, block="L", lane=1),
                        _t(1.2, "n", "running", partition=0, block="L", lane=2),
                        {"t": 1.25, "ev": "chaos", "kind": "kill_runner", "trial": "m",
                         "partition": 0},
                        _t(2.0, "L", "requeued", reason="heartbeat_loss"),
                        _t(2.0, "m", "requeued", reason="heartbeat_loss"),
                        _t(2.5, "L", "finalized", partition=1),
                        _t(2.6, "m", "finalized", partition=1), END],
}


# One auto capture for partition 1 and none for the flagged partition 2,
# with the run's limit not reached.
JOURNALS["obs_missing_capture"] = [e for e in JOURNALS["obs_captures"]
                                   if not (e["ev"] == "profile_captured" and e["t"] == 2.8)]


def _same_report(events, **kw):
    port = harness.check_invariants([dict(e) for e in events], **kw)
    jax = jax_harness.check_invariants([dict(e) for e in events], **kw)
    assert json.dumps(port, sort_keys=True) == json.dumps(jax, sort_keys=True)
    return port


@pytest.mark.parametrize("kw", [{}, {"requeue_bound_s": 0.5, "stall_flag_bound_s": 2.0},
                                {"requeue_bound_s": 10.0, "stall_flag_bound_s": None}])
@pytest.mark.parametrize("name", sorted(JOURNALS))
def test_check_invariants_equals_jax(name, kw):
    _same_report(JOURNALS[name], **kw)


def test_checker_finds_what_each_shape_plants():
    """Spot checks that the synthetic shapes reach the invariants they were
    built for (the equality test above holds both checkers to one answer)."""
    v = lambda name, **kw: " | ".join(harness.check_invariants(JOURNALS[name],
                                                               **kw)["violations"])
    assert "lost trial: a" in v("lost_and_duplicate") and "duplicate FINAL: b" in \
        v("lost_and_duplicate") and "phantom trial: c" in v("lost_and_duplicate")
    assert "experiment never finalized" in v("no_experiment_end")
    assert "no requeue" in v("kill_unrequeued")
    assert "slow requeue" in v("kill_healed", requeue_bound_s=0.5)
    assert "duplicate requeue" in v("duplicate_requeue")
    assert "resume step mismatch" in v("preempt_wrong_step")
    assert "unacked preemption" in v("preempt_unacked")
    assert "unflagged stall" in v("stall_late_wrong_cleared", stall_flag_bound_s=2.0)
    assert "duplicate profile capture" in v("obs_captures")
    assert "missing profile capture: stalled partition 2" in v("obs_missing_capture")
    assert "gang over-requeue" in v("gang_broken") and "not released" in v("gang_broken") \
        and "never reassembled" in v("gang_broken") and "unrevoked gang" in v("gang_broken")
    assert "restarted blind" in v("driver_kill_blind_and_rerun") and \
        "completed trial re-ran" in v("driver_kill_blind_and_rerun")
    assert "never restarted" in v("driver_kill_no_restart")
    assert "fork point drifted" in v("fork_drifted") and \
        "not exactly-once" in v("fork_drifted")
    assert "lane lost to the block seam" in v("vmap_block_torn") and \
        "reason drift" in v("vmap_block_torn")
    report = harness.check_invariants(JOURNALS["driver_kill"])
    assert report["failover"]["recoveries"][0]["mttr_s"] == pytest.approx(1.1)


# ------------------------------------------------------------------ the soaks


def _port_soak(tmp_path, **kw):
    report = harness.run_soak(base_dir=str(tmp_path / "port"), **kw)
    assert report["ok"], report["violations"]
    return report


@pytest.mark.timeout(120)
def test_default_soaks_of_both_packages_check_alike(tmp_path):
    """The standard plan through each package's soak, and each soak's
    journal through both checkers: equal reports, no violations."""
    port = _port_soak(tmp_path)
    jax = jax_harness.run_soak(base_dir=str(tmp_path / "jax"), lock_witness=False)
    assert jax["ok"], jax["violations"]
    for report in (port, jax):
        events = read_events(report["journal"])
        checked = _same_report(events, requeue_bound_s=5.6)
        assert checked["ok"], checked["violations"]
        assert checked["faults"]["by_kind"].get("kill_runner") == 1
    assert port["schedule_fingerprint"] == jax["schedule_fingerprint"]
    assert port["trials"]["finalized"] == port["result"]["num_trials"] == 12
    assert {r["outcome"] for r in port["recoveries"]} <= {"requeued",
                                                          "completed_before_detection"}
    # The health engine ran, on by default, and flagged nothing unfaulted.
    assert port["health"]["engine_ran"]


def test_piggyback_soak(tmp_path):
    report = _port_soak(tmp_path, plan=harness.piggyback_plan(7), seed=7)
    assert report["faults"]["by_kind"] == {"kill_runner": 1}
    (rec,) = report["recoveries"]
    assert rec["outcome"] == "requeued" and rec["requeues"] == 1


def test_preempt_soak_resumes_from_the_checkpoint(tmp_path):
    report = _port_soak(tmp_path, plan=harness.preempt_plan(7), seed=7,
                        train_fn=harness.ckpt_train_fn)
    (rec,) = report["preemptions"]
    assert rec["outcome"] in ("preempted", "completed_before_preempt")
    if rec["outcome"] == "preempted":
        assert rec["checkpointed"] and rec["from_step"] == rec["step"] >= 1


def test_fork_soak_both_halves(tmp_path):
    report = harness.run_fork_soak(seed=7, base_dir=str(tmp_path / "fork"))
    assert report["ok"], report["violations"]
    assert report["faults"]["by_kind"] == {"kill_fork": 1}
    (rec,) = report["forks"]
    assert rec["outcome"] == "resumed_from_fork" and rec["from_step"] == rec["step"]
    assert report["fork_failover"]["fork"]["forked"] >= 1


def test_goodput_soak_is_fault_free_and_flag_free(tmp_path):
    report = harness.run_goodput_soak(seed=7, base_dir=str(tmp_path / "gp"))
    assert report["ok"], report["violations"]
    assert report["faults"]["injected"] == 0
    assert report["health"]["engine_ran"] and report["health"]["raised"] == 0
    assert report["goodput"]["buckets"]["rework"] == 0


@pytest.mark.timeout(90)
def test_vmap_soak_tears_a_block(tmp_path):
    report = harness.run_vmap_soak(seed=7, num_trials=8, base_dir=str(tmp_path / "vmap"))
    assert report["ok"], report["violations"]
    assert [r["outcome"] for r in report["vmap_blocks"]] == ["requeued"]


@pytest.mark.timeout(90)
def test_process_pool_default_soak_kills_for_real(tmp_path):
    report = _port_soak(tmp_path, pool="process", train_fn=harness._soak_train_fn,
                        workers=2, num_trials=6, hb_interval=0.1, hb_loss_timeout=2.0)
    chaos = [e for e in read_events(report["journal"])
             if e.get("ev") == "chaos" and e.get("kind") == "kill_runner"]
    assert [e["mechanism"] for e in chaos] == ["sigkill"]


def test_chaos_needs_telemetry(tmp_path):
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment

    config = OptimizationConfig(num_trials=1, searchspace=Searchspace(x=("DOUBLE", [0, 1])),
                                telemetry=False, chaos=harness.default_plan(1),
                                experiment_dir=str(tmp_path / "e"))
    with pytest.raises(ValueError, match="telemetry=True"):
        experiment.lagom(lambda x: x, config)


@pytest.mark.parametrize("flag", [pytest.param("--gang", id="--gang-8")])
def test_cli_refuses_unported_soaks(flag, capsys):
    """The gang soak is ported: the flag expands its plan to the JAX CLI's
    schedule (the soak itself runs in tests/test_torch_gang.py). The name
    and the case id are kept from when the CLI refused it."""
    from maggy_tpu.chaos.__main__ import main as jax_main
    from maggy_tpu_torch.chaos.__main__ import main

    assert main([flag, "--show-schedule"]) == 0
    port = json.loads(capsys.readouterr().out)
    assert jax_main([flag, "--show-schedule"]) == 0
    assert json.loads(capsys.readouterr().out) == port
    assert port["schedule"][0]["kind"] == "kill_gang_member"


@pytest.mark.parametrize("flag,module,fn", [
    ("--driver", "maggy_tpu_torch.chaos.driver_soak", "run_driver_soak"),
    ("--sink", "maggy_tpu_torch.fleet.soak", "run_sink_soak"),
    ("--agent", "maggy_tpu_torch.fleet.soak", "run_agent_soak")])
def test_cli_runs_the_topology_soaks(flag, module, fn, capsys, monkeypatch):
    """The agent, sink and driver soaks own their processes and run through
    their own functions (exercised in test_torch_agent, test_torch_sink and
    below); the CLI hands them the seed, the agent soak at most 6 trials,
    the lock-order witness unless --no-witness (as the JAX CLI does), and
    exits 1 on a violation."""
    import importlib

    from maggy_tpu_torch.chaos.__main__ import main

    calls = []

    def fake(**kwargs):
        calls.append(kwargs)
        return {"ok": len(calls) == 1, "violations": []}

    monkeypatch.setattr(importlib.import_module(module), fn, fake)
    assert main([flag, "--seed", "3", "--trials", "20"]) == 0
    assert main([flag]) == 1
    want = {"seed": 3, "trials": 6} if flag == "--agent" else {"seed": 3}
    assert calls[0] == {**want, "lock_witness": True} and calls[1]["seed"] == 7
    main([flag, "--no-witness"])
    assert calls[2]["lock_witness"] is False
    assert json.loads(capsys.readouterr().out.split("\n}\n")[0] + "}")["ok"]


@pytest.mark.timeout(120)
def test_driver_soak_invariant_13_as_jax(tmp_path):
    """``tests/test_failover.py:712``'s soak at its size (5 trials, 2 remote
    runners, one driver SIGKILL): the resumed driver adopts the surviving
    runners and finishes the sweep; its journal reads the same through the
    JAX package's checker."""
    from maggy_tpu.telemetry import read_events as jax_read_events
    from maggy_tpu_torch.chaos.driver_soak import run_driver_soak

    report = run_driver_soak(trials=5, workers=2, seed=7, kills=1, base_dir=str(tmp_path))
    assert report["ok"], report["violations"]
    assert report["failover"]["kills"] == 1 and report["failover"]["driver_epochs"] == [1, 2]
    assert report["trials"]["finalized"] == 5
    events = read_events(report["journal"])
    assert harness.check_invariants(events) == \
        jax_harness.check_invariants(jax_read_events(report["journal"]))


def test_cli_show_schedule_matches_jax(capsys):
    from maggy_tpu.chaos.__main__ import main as jax_main
    from maggy_tpu_torch.chaos.__main__ import main

    assert main(["--show-schedule", "--seed", "11"]) == 0
    port = capsys.readouterr().out
    assert jax_main(["--show-schedule", "--seed", "11"]) == 0
    assert port == capsys.readouterr().out
