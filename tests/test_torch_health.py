"""The port's live health engine against the JAX package's on the CPU: the
same span, runner-stats and progress feed under one fake clock gives equal
findings, journal events and snapshots (straggler by first-metric latency
and by cadence, hb_rtt, hang in the steady window and under the start-up
leash, and their clearing); the progress stamps the watchdog reads; the
engine on the driver (on by default, off with health=False or without
telemetry); and the stall soak, whose stall the engine must flag."""

import json
import time

import pytest

import maggy_tpu.telemetry as jax_telemetry_mod
import maggy_tpu.telemetry.health as jax_health
from maggy_tpu.telemetry import Telemetry as JaxTelemetry

import maggy_tpu_torch.telemetry as telemetry_mod
import maggy_tpu_torch.telemetry.health as health
from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.chaos import disarm, harness
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.telemetry import Telemetry, read_events

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]


@pytest.fixture(autouse=True)
def local_env(tmp_path):
    env = LocalEnv(base_dir=str(tmp_path / "exp"))
    EnvSing.set_instance(env)
    disarm()
    yield env
    disarm()
    EnvSing.reset()


class FakeClock:
    """Both clocks the engine and the facade read, moved by hand."""

    def __init__(self):
        self.mono, self.wall = 1000.0, 1.75e9

    def monotonic(self):
        return self.mono

    def time(self):
        return self.wall

    def advance(self, s):
        self.mono += s
        self.wall += s


class FakeReservations:
    """The partition -> trial view the hang watchdog reads."""

    def __init__(self):
        self.table = {}

    def all(self):
        return {pid: dict(rec) for pid, rec in self.table.items()}


def _feed(telem, engine, clock, res):
    """One scenario, step by step; returns what each check saw."""
    seen = []
    # Four partitions with a first metric; partition 3 is 25x slower, its
    # cadence 17x and its heartbeat round trip 180x the fleet's.
    for pid, ms in {0: 100, 1: 110, 2: 105, 3: 2500}.items():
        trial = "t{}".format(pid)
        telem.spans.mark(trial, "running", t=100.0, partition=pid)
        telem.spans.mark(trial, "first_metric", t=100.0 + ms / 1e3, partition=pid)
    fleet = {0: (50.0, 2.0), 1: (55.0, 2.5), 2: (52.0, 2.2), 3: (900.0, 400.0)}
    for pid, (cadence, rtt) in fleet.items():
        telem.record_runner_stats(pid, {"cadence_ms": cadence, "hb_rtt_ms": rtt})
    # Partition 4 holds a trial past its first metric (the steady window),
    # partition 5 one still before it (the start-up leash).
    telem.trial_event("h", "running", partition=4)
    telem.trial_event("h", "first_metric", partition=4)
    telem.trial_event("s", "running", partition=5)
    res.table = {4: {"trial_id": "h"}, 5: {"trial_id": "s"}, 6: {"trial_id": None}}
    seen.append(engine.check())
    # 2 s without progress: past the steady bound (1 s), inside the
    # start-up one (4 s); partition 3's stats go stale and leave the fleet.
    clock.advance(2.0)
    for pid in (0, 1, 2):
        telem.record_runner_stats(pid, {"cadence_ms": fleet[pid][0], "hb_rtt_ms": fleet[pid][1]})
    seen.append(engine.check())
    seen.append(engine.check())  # still hung: nothing journaled twice
    clock.advance(3.0)
    seen.append(engine.check())
    # Progress on both: the hang flags clear, once each.
    telem.trial_event("h", "finalized", partition=4)
    telem.trial_event("s", "first_metric", partition=5)
    res.table = {5: {"trial_id": "s"}}
    seen.append(engine.check())
    return seen


def _run(package, monkeypatch):
    clock, res = FakeClock(), FakeReservations()
    if package == "port":
        mods, telem_cls, health_mod = (telemetry_mod, health), Telemetry, health
    else:
        mods, telem_cls, health_mod = (jax_telemetry_mod, jax_health), JaxTelemetry, jax_health
    for mod in mods:
        monkeypatch.setattr(mod, "time", clock)
    telem = telem_cls(enabled=True)
    engine = health_mod.HealthEngine(telem, hb_interval=0.1, hang_factor=10.0)
    engine.attach(reservations=res)
    seen = _feed(telem, engine, clock, res)
    events = [e for e in telem.events() if e["ev"] == "health"]
    return seen, events, engine.snapshot()


def test_findings_events_and_snapshot_equal_jax(monkeypatch):
    port_seen, port_events, port_snap = _run("port", monkeypatch)
    jax_seen, jax_events, jax_snap = _run("jax", monkeypatch)
    # The thread dumps differ (other code, other threads); each raised hang
    # carries one.
    for events in (port_events, jax_events):
        for e in events:
            if e.get("check") == "hang" and e["status"] == "raised":
                assert e.pop("stacks")
    assert json.dumps(port_seen, sort_keys=True) == json.dumps(jax_seen, sort_keys=True)
    assert json.dumps(port_events, sort_keys=True) == json.dumps(jax_events, sort_keys=True)
    assert port_snap == jax_snap
    first = {(f["check"], f.get("metric"), f["partition"]) for f in port_seen[0]}
    assert first == {("straggler", "first_metric_ms", 3), ("straggler", "cadence_ms", 3),
                     ("hb_rtt", "hb_rtt_ms", 3)}
    assert [(f["partition"], f["window"]) for f in port_seen[1] if f["check"] == "hang"] \
        == [(4, "steady")]
    assert sorted((f["partition"], f["window"]) for f in port_seen[3]
                  if f["check"] == "hang") == [(4, "steady"), (5, "startup")]
    # Partition 5's first metric came 5 s after its start: a straggler now.
    assert sorted((f["check"], f.get("metric"), f["partition"]) for f in port_seen[4]) == \
        [("straggler", "first_metric_ms", 3), ("straggler", "first_metric_ms", 5)]
    statuses = [(e["check"], e.get("partition"), e["status"]) for e in port_events]
    assert statuses.count(("hang", 4, "raised")) == 1
    assert ("hang", 4, "cleared") in statuses and ("hang", 5, "cleared") in statuses
    assert ("hb_rtt", 3, "cleared") in statuses


def test_constants_are_the_references():
    assert (health.DEFAULT_HANG_FACTOR, health.DEFAULT_STARTUP_FACTOR,
            health.DEFAULT_MAD_THRESHOLD, health.STALL_CHECKS) == \
        (jax_health.DEFAULT_HANG_FACTOR, jax_health.DEFAULT_STARTUP_FACTOR,
         jax_health.DEFAULT_MAD_THRESHOLD, jax_health.STALL_CHECKS) == \
        (25.0, 4.0, 3.5, ("hang", "straggler"))
    assert [health.default_interval_s(h) for h in (0.05, 1.0)] == [0.25, 1.0]
    assert OptimizationConfig().health and OptimizationConfig().health_hang_factor == 25.0


def test_only_progress_stamps_the_watchdog():
    telem = Telemetry()
    telem.record_runner_stats(0, {"hb_rtt_ms": 3.0, "rss_mb": 100.0})
    assert telem.last_progress(0) is None
    telem.record_runner_stats(0, {"steps": 4})
    assert telem.last_progress(0) is not None
    telem.trial_event("a", "queued")  # no partition: no stamp
    telem.prune_partition(0)
    assert telem.last_progress(0) is None


def test_thread_dump_names_this_thread():
    assert "test_thread_dump_names_this_thread" in health.thread_dump(max_bytes=1 << 20)


def test_engine_thread_starts_journals_and_closes():
    telem = Telemetry()
    engine = health.HealthEngine(telem, hb_interval=0.01, interval_s=0.02)
    telem.health = engine
    engine.start()
    time.sleep(0.15)
    engine.close()
    assert not engine._thread.is_alive()
    started = [e for e in telem.events() if e["ev"] == "health"]
    assert started[0]["check"] == "engine" and started[0]["status"] == "started"
    snap = telem.snapshot()["health"]
    assert snap["checks_run"] >= 2 and snap["flags"] == []


def _sweep(tmp_path, **kw):
    def train(x, reporter):
        for i in range(3):
            reporter.broadcast(x, step=i)
        return x

    return experiment.lagom(train, OptimizationConfig(
        num_trials=3, searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0])), num_workers=2,
        hb_interval=0.05, seed=0, es_policy="none", experiment_dir=str(tmp_path / "e"), **kw))


def _journal(tmp_path):
    import glob

    (path,) = glob.glob(str(tmp_path / "e" / "*" / "telemetry.jsonl"))
    return read_events(path)


@pytest.mark.parametrize("kw,engine_ran", [({}, True), ({"health": False}, False),
                                           ({"telemetry": False}, None)])
def test_driver_runs_the_engine_by_default(tmp_path, kw, engine_ran):
    result = _sweep(tmp_path, **kw)
    assert result["num_trials"] == 3
    if engine_ran is None:
        assert not list((tmp_path / "e").glob("*/telemetry.jsonl"))
        return
    health_events = [e for e in _journal(tmp_path) if e["ev"] == "health"]
    assert bool(health_events) == engine_ran
    if engine_ran:
        assert health_events[0]["check"] == "engine" and health_events[0]["hang_factor"] == 25.0
        assert not [e for e in health_events if e.get("status") == "raised"]


def test_stall_soak_is_flagged(tmp_path):
    """Invariant 5: a runner stalled below the loss bound (10 s) is caught
    by the hang watchdog, for the stalled partition, within the bound."""
    report = harness.run_soak(plan=harness.stall_plan(7), seed=7, hb_loss_timeout=10.0,
                              base_dir=str(tmp_path / "stall"),
                              config_overrides={"health_hang_factor": 10.0,
                                                "health_interval_s": 0.1})
    assert report["ok"], report["violations"]
    (flag,) = report["health"]["stall_flags"]
    assert flag["flagged"] and "hang" in flag["checks"]
    assert report["result"]["lost_runners"] == 0
