"""The port's journal sink (``maggy_tpu_torch/telemetry/sink.py``), its wire
verbs and the unified trace against maggy_tpu's on the CPU, following
``tests/test_sink.py``: the clock-offset estimator; the sink's ingest, sid
dedup, ``jsink`` records, skew-free lag, degraded flag, federated counters,
rotation and refusals, each fed the same batches as the JAX sink; torn
segments, the exactly-once merge and its checker; the shipper's seam (ship,
sink killed, local fallback, restart, re-ship) over a real shared socket,
its journal read through the JAX readers; a fleet tenant with
``config.sink``; the sink soak (invariant 12) through the CLI; the
heartbeat BATCH verb; the unified trace, built from the same journals by
both packages, on skewed clocks and through the CLI; and the monitor's sink
view. Every comparison is exact unless a test says otherwise."""

import json
import os
import random
import time

import pytest

from maggy_tpu.core import rpc as jax_rpc
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.monitor import render_fleet as jax_render_fleet
from maggy_tpu.telemetry import Telemetry as JaxTelemetry
from maggy_tpu.telemetry import read_events as jax_read_events
from maggy_tpu.telemetry import sink as jax_sink
from maggy_tpu.telemetry import trace as jax_trace
from maggy_tpu.telemetry.obs import render_prometheus as jax_render_prometheus

from maggy_tpu_torch import experiment
from maggy_tpu_torch.chaos.harness import check_invariants
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.fleet import scheduler, soak
from maggy_tpu_torch.monitor import render_fleet
from maggy_tpu_torch.telemetry import Telemetry, read_events
from maggy_tpu_torch.telemetry import sink
from maggy_tpu_torch.telemetry import trace
from maggy_tpu_torch.telemetry.obs import render_prometheus

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]


@pytest.fixture(autouse=True)
def envs(tmp_path):
    env = LocalEnv(base_dir=str(tmp_path / "port_env"))
    EnvSing.set_instance(env)
    JaxEnvSing.set_instance(JaxLocalEnv(base_dir=str(tmp_path / "jax_env")))
    yield env
    EnvSing.reset()
    JaxEnvSing.reset()


def ev(sid, t=None, kind="runner_stats", **fields):
    return {"t": t if t is not None else 1000.0 + sid, "ev": kind, "sid": sid, **fields}


# ------------------------------------------------------- clock estimator


def test_clock_offset_estimator_as_jax():
    """Seeded exchanges (injected offsets of both signs, RTTs growing and
    shrinking, a stale estimate, garbage): both estimators take the same
    samples to the same estimates, and the offset lies within rtt/2 of the
    injected one."""
    rng = random.Random(7)
    for offset in (0.25, -3.0):
        mine, theirs = sink.ClockOffsetEstimator(max_age_s=5.0), \
            jax_sink.ClockOffsetEstimator(max_age_s=5.0)
        t = 100.0
        for _ in range(40):
            rtt = rng.uniform(0.001, 0.05)
            server_t = t + rtt * rng.random() - offset
            sample = (t, server_t, t + rtt)
            assert mine.sample(*sample) == theirs.sample(*sample)
            assert (mine.offset_s, mine.rtt_s, mine.bound_s, mine.samples) == \
                (theirs.offset_s, theirs.rtt_s, theirs.bound_s, theirs.samples)
            assert abs(mine.offset_s - offset) <= mine.bound_s + 1e-9
            t += rng.uniform(0.1, 1.0)
        for garbage in ((t, None, t + 0.01), (t, t, t - 1.0)):
            assert mine.sample(*garbage) is theirs.sample(*garbage) is False


# ------------------------------------------------------------ the sink


def _sinks(tmp_path, telemetry=False, **kw):
    """The port's and the JAX package's sinks over their own dirs, with a
    journal-less fleet telemetry each when asked."""
    port_t, jax_t = (Telemetry(enabled=True), JaxTelemetry(enabled=True)) if telemetry \
        else (None, None)
    port = sink.JournalSink(LocalEnv(), str(tmp_path / "port_journal"), telemetry=port_t, **kw)
    jax = jax_sink.JournalSink(JaxLocalEnv(), str(tmp_path / "jax_journal"),
                               telemetry=jax_t, **kw)
    return (port, port_t), (jax, jax_t)


def _strip(snapshot):
    """A sink snapshot without its wall-clock ages."""
    return {src: {k: v for k, v in s.items() if not k.endswith("age_s")}
            for src, s in snapshot.items()}


def test_ingest_dedup_and_acks_as_jax(tmp_path):
    now = time.time()
    batches = [("exp-a", [ev(1), ev(2)], None), ("exp-a", [ev(1), ev(2), ev(3)], None),
               ("exp-a", [ev(1), ev(2)], None), ("exp-a", [], None),
               ("agent-1", [ev(1, t=now - 0.2), ev(2, kind="sink_degraded", t=now - 0.1)],
                now),
               ("agent-1", [ev(3, kind="sink_recovered", t=now)], now),
               ("b/c d", [{"t": 1.0, "ev": "x"}, "junk", ev(1)], None),
               (None, [ev(1)], None), ("", [ev(1)], None)]
    (port, port_t), (jax, jax_t) = _sinks(tmp_path, telemetry=True)
    for source, events, client_t in batches:
        a = port.ingest(source, [dict(e) if isinstance(e, dict) else e for e in events],
                        client_t=client_t)
        b = jax.ingest(source, [dict(e) if isinstance(e, dict) else e for e in events],
                       client_t=client_t)
        assert a == b, (source, a, b)
    assert _strip(port.snapshot()) == _strip(jax.snapshot())
    assert port.snapshot()["exp-a"]["dup"] == 4 and port.snapshot()["agent-1"]["degraded"] is False
    # jsink records: one a non-empty batch, lag measured on the source's clock.
    recs = [[{k: v for k, v in e.items() if k not in ("t", "lag_ms")}
             for e in t.events() if e["ev"] == "jsink"] for t in (port_t, jax_t)]
    assert recs[0] == recs[1] and len(recs[0]) == 6
    assert recs[0][2] == {"ev": "jsink", "source": "exp-a", "n": 0, "dup": 2, "sid": 3}
    lags = [e["lag_ms"] for e in port_t.events() if e["ev"] == "jsink" and e["source"] == "agent-1"]
    assert 50.0 <= lags[0] <= 1000.0
    counters = port_t.metrics.snapshot()["counters"]
    assert counters == {k: v for k, v in jax_t.metrics.snapshot()["counters"].items()
                        if k.startswith("sink.")}
    port.stop()
    jax.stop()
    assert port.ingest("exp-a", [ev(9)])["type"] == jax.ingest("exp-a", [ev(9)])["type"] == "ERR"
    for source in ("exp-a", "agent-1", sink.sanitize_source("b/c d")):
        assert read_events(port.source_path(source)) == jax_read_events(jax.source_path(source))
    assert sink.sanitize_source("b/c d") == jax_sink.sanitize_source("b/c d") == "b_c_d"


def test_skewed_agent_clock_lag_and_federated_counters_as_jax(tmp_path):
    """An agent's clock an hour ahead: the lag stays the event's true age,
    and its shipped counters render per source through either exporter."""
    (port, _), (jax, _) = _sinks(tmp_path)
    skewed = time.time() + 3600.0
    counters = {"counters": {"agent.leases": 4}, "gauges": {"agent.rss_mb": 12.5}}
    for s in (port, jax):
        s.ingest("agent-1", [ev(1, t=skewed - 0.2)], counters=counters, client_t=skewed)
        assert s.snapshot()["agent-1"]["last_event_age_s"] < 5.0
    assert port.federated_snapshots() == jax.federated_snapshots()
    text = render_prometheus(port.federated_snapshots())
    assert text == jax_render_prometheus(jax.federated_snapshots())
    assert 'agent_leases_total{experiment="agent-1"' in text
    port.stop()
    jax.stop()


def test_rotation_seals_per_source_segments_as_jax(tmp_path):
    (port, _), (jax, _) = _sinks(tmp_path, max_mb=0.0005)
    for s in (port, jax):
        for i in range(1, 21):
            s.ingest("a", [ev(i, pad="x" * 120)])
            s._writers["a"].flush()
        s.stop()
    assert sorted(os.listdir(port.journal_dir)) == sorted(os.listdir(jax.journal_dir))
    assert os.path.exists(port.source_path("a") + ".000001")
    assert [e["sid"] for e in read_events(port.source_path("a"))] == list(range(1, 21))
    assert sink.sink_sources(port.journal_dir).keys() == {"a"}


def test_torn_segments_and_the_exactly_once_merge_as_jax(tmp_path):
    d = tmp_path / "journal"
    d.mkdir()
    (d / "a.jsonl").write_text("".join(json.dumps(ev(i)) + "\n" for i in (1, 2, 3))
                               + '{"t": 1, "ev": "x", "si')
    (d / "b.jsonl").write_text(json.dumps(ev(1)) + "\n")
    (d / "b.jsonl.000001").write_text(json.dumps(ev(2)) + "\n")
    (d / "notes.txt").write_text("not a source")
    assert sink.sink_sources(str(d)) == jax_sink.sink_sources(str(d))
    mine, theirs = sink.read_sink_dir(str(d)), jax_sink.read_sink_dir(str(d))
    assert mine == theirs and sorted(mine) == ["a", "b"]
    assert mine["a"].torn_lines == theirs["a"].torn_lines == 1
    rng = random.Random(3)
    for _ in range(30):
        top = rng.randint(1, 12)
        shipped = [ev(s, t=rng.random()) for s in range(1, top + 1) if rng.random() < 0.7]
        local = [ev(s, t=rng.random()) for s in range(1, top + 1) if rng.random() < 0.5]
        local += [{"t": rng.random(), "ev": "sidless"}]
        merged = sink.merge_source_events(shipped, local)
        assert merged == jax_sink.merge_source_events(shipped, local)
        for want in (None, top, top + 2):
            assert sink.check_exactly_once(merged, want) == \
                jax_sink.check_exactly_once(merged, want)
        doubled = list(merged) + [merged[0]] if merged else []
        assert sink.check_exactly_once(doubled) == jax_sink.check_exactly_once(doubled)


# ----------------------------------------------------------- the seam


@pytest.mark.timeout(60)
def test_shipper_degrades_reships_exactly_once_and_refcounts(envs, tmp_path):
    """The client seam over a real shared socket: ship, sink tenant
    detached (degrade to the local file), re-attached (recover and re-ship).
    The merged stream holds each event id once, one sink_degraded and one
    sink_recovered, read the same through the JAX readers; two journals of
    one binding share one shipper, which retires with the last."""
    shared = rpc.SharedServer()
    service = sink.JournalSink(envs, str(tmp_path / "journal"))
    srv = rpc.SinkServer()
    srv.attach_sink(service)
    binding = sink.SinkBinding(shared.attach(srv), srv.secret_hex)
    local_path = str(tmp_path / "local.jsonl")
    telem = Telemetry(env=envs, journal_path=local_path, enabled=True, sink=binding,
                      sink_source="exp-a")
    other = Telemetry(env=envs, journal_path=str(tmp_path / "other.jsonl"), enabled=True,
                      sink=binding, sink_source="two")

    def wait(cond):
        deadline = time.monotonic() + 20
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert cond()

    try:
        assert telem.journal.shipper is other.journal.shipper
        for i in range(10):
            telem.event("runner_stats", partition=0, i=i)
        wait(lambda: service.snapshot().get("exp-a", {}).get("ingested", 0) >= 10)
        assert not os.path.exists(local_path)
        shared.detach(srv)
        for i in range(10, 20):
            telem.event("runner_stats", partition=0, i=i)
        wait(lambda: telem.journal.degraded)
        assert os.path.exists(local_path)
        shared.attach(srv)
        wait(lambda: not telem.journal.degraded)
        for i in range(20, 25):
            telem.event("runner_stats", partition=0, i=i)
    finally:
        other.close()
        assert binding.key() in sink._SHIPPERS
        telem.close()
        shared.stop()
        service.stop()
    assert binding.key() not in sink._SHIPPERS
    shipped_path = str(tmp_path / "journal" / "exp-a.jsonl")
    merged = sink.merge_source_events(read_events(shipped_path), read_events(local_path))
    assert merged == jax_sink.merge_source_events(jax_read_events(shipped_path),
                                                  jax_read_events(local_path))
    assert sink.check_exactly_once(merged, expected_max_sid=telem.journal.max_sid()) == []
    kinds = [e.get("ev") for e in merged]
    assert kinds.count("sink_degraded") == kinds.count("sink_recovered") == 1


@pytest.mark.timeout(60)
def test_a_tenant_with_config_sink_ships_its_journal(tmp_path):
    """A fleet tenant with ``sink=True`` ships its journal to
    <home>/journal/<tenant>.jsonl and writes no local one; the shipped
    journal passes both packages' invariant checkers alike, and the fleet
    replay folds its goodput from it as the JAX replay does."""
    from maggy_tpu.chaos.harness import check_invariants as jax_check

    base = str(tmp_path / "runs")
    with scheduler.Fleet(runners=2, home_dir=os.path.join(base, "fleet")) as fleet:
        result = experiment.lagom_submit(
            soak.sink_train_fn, soak._scale_config("shipped", 4, base, 3, hb_interval=0.05,
                                                   sink=True),
            fleet=fleet, block=False, name="shipped").result(timeout=60)
        exp_dir = fleet._submissions["shipped"].entry.driver.exp_dir
    assert result["num_trials"] == 4
    assert not os.path.exists(os.path.join(exp_dir, "telemetry.jsonl"))
    shipped = os.path.join(fleet.home_dir, "journal", "shipped.jsonl")
    events = read_events(shipped)
    mine = check_invariants(events, stall_flag_bound_s=None)
    assert mine == jax_check(jax_read_events(shipped), stall_flag_bound_s=None)
    assert mine["violations"] == [] and mine["trials"]["finalized"] == 4
    assert sink.check_exactly_once(events) == []
    journal = os.path.join(fleet.home_dir, "fleet.jsonl")
    replay = scheduler.replay_fleet_journal(journal)
    from maggy_tpu.fleet.scheduler import replay_fleet_journal as jax_replay

    assert replay == jax_replay(journal)
    assert replay["goodput"]["tenants"]["shipped"]["goodput"]["held_chip_s"] > 0
    assert replay["sink"]["events"] >= len(events)


@pytest.mark.timeout(90)
def test_sink_soak_through_the_cli(tmp_path, capsys, monkeypatch):
    """Invariant 12: ``python -m maggy_tpu_torch.fleet soak --sink`` kills
    the sink mid-run and restarts it; no event lost or doubled in any
    source, no tenant failed, and the seam's events survive. Each tenant's
    merged stream passes the JAX package's exactly-once checker too."""
    import tempfile

    from maggy_tpu_torch.fleet.__main__ import main

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    capsys.readouterr()
    rc = main(["soak", "--sink", "--seed", "7"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0, report["violations"]
    detail = report["detail"]
    assert detail["degraded_events"] >= 1 and detail["recovered_events"] >= 1
    assert sorted(detail["per_source"]) == ["probe", "sink00", "sink01", "sink02"]
    for source, block in detail["per_source"].items():
        path = os.path.join(report["sink_dir"], source + ".jsonl")
        merged = jax_sink.merge_source_events(jax_read_events(path))
        assert block["violations"] == [] and block["merged"] >= len(merged), source


# ---------------------------------------------------------- heartbeats


def test_banked_beats_coalesce_and_replay_through_batch_as_jax():
    """A runner's failed beats bank coalesced per trial, within the count
    and log-line bounds, as the JAX client banks them; a BATCH runs each
    beat through the METRIC handler and answers with the newest beat's
    reply."""
    rng = random.Random(5)
    mine, theirs = [], []
    for i in range(60):
        beat = {"type": "METRIC", "trial_id": "t{}".format(rng.randint(0, 3) if i % 7 else 9),
                "value": rng.random(), "step": i, "logs": ["l{}".format(i)] * rng.randint(0, 90),
                "span": "s", "rstats": {"x": 1}}
        rpc.Client._queue_beat(mine, dict(beat))
        jax_rpc.Client._queue_beat(theirs, dict(beat))
        assert mine == theirs
    assert len(mine) <= 16 and all("rstats" not in b for b in mine)

    seen = []
    replies = {}
    for name, srv in (("port", rpc.OptimizationServer()),
                      ("jax", jax_rpc.OptimizationServer(1))):
        srv._handlers["METRIC"] = lambda msg, name=name: (
            seen.append((name, msg["trial_id"], msg["partition_id"], msg["type"]))
            or {"type": "STOP" if msg["trial_id"] == "t2" else "OK"})
        replies[name] = [srv.handle_message({"type": "BATCH", "partition_id": 0, "beats": beats})
                         for beats in ([{"trial_id": "t1"}, {"trial_id": "t2"}],
                                       [{"trial_id": "t2"}, {"trial_id": "t1"}], [])]
    assert replies["port"] == replies["jax"] == [{"type": "STOP"}, {"type": "OK"},
                                                 {"type": "OK"}]
    assert [s[1:] for s in seen if s[0] == "port"] == [s[1:] for s in seen if s[0] == "jax"]


# ------------------------------------------------------- unified trace


def _skewed(skew=120.0):
    """``tests/test_sink.py:338``'s fleet: two agents whose clocks lead and
    trail the fleet's by ``skew``, each leased one trial of experiment e1."""
    T = 1000000.0
    fleet = [
        {"t": T, "ev": "fleet", "phase": "start", "name": "f"},
        {"t": T + 0.5, "ev": "agent", "phase": "join", "agent": "a1-x", "runner": 2,
         "host": "hostA"},
        {"t": T + 0.6, "ev": "agent", "phase": "join", "agent": "a2-y", "runner": 3,
         "host": "hostB"},
        {"t": T + 0.7, "ev": "clock_offset", "agent": "a1-x", "offset_s": skew, "rtt_s": 0.002},
        {"t": T + 0.7, "ev": "clock_offset", "agent": "a2-y", "offset_s": -skew,
         "rtt_s": 0.002},
        {"t": T + 1.0, "ev": "lease", "phase": "start", "exp": "e1", "pid": 0, "runner": 2},
        {"t": T + 1.0, "ev": "agent", "phase": "lease", "agent": "a1-x", "exp": "e1", "pid": 0,
         "abind_ms": 5},
        {"t": T + 1.1, "ev": "lease", "phase": "start", "exp": "e1", "pid": 1, "runner": 3},
        {"t": T + 1.1, "ev": "agent", "phase": "lease", "agent": "a2-y", "exp": "e1", "pid": 1,
         "abind_ms": 4},
        {"t": T + 5.0, "ev": "lease", "phase": "end", "exp": "e1", "pid": 0, "runner": 2},
        {"t": T + 5.1, "ev": "lease", "phase": "end", "exp": "e1", "pid": 1, "runner": 3},
    ]
    exps = {"e1": [
        {"t": T + 1.2, "ev": "trial", "trial": "t1", "span": "s1", "phase": "assigned",
         "partition": 0},
        {"t": T + 4.0, "ev": "trial", "trial": "t1", "span": "s1", "phase": "finalized",
         "partition": 0},
        {"t": T + 1.4, "ev": "trial", "trial": "t2", "span": "s2", "phase": "assigned",
         "partition": 1},
        {"t": T + 4.1, "ev": "trial", "trial": "t2", "span": "s2", "phase": "finalized",
         "partition": 1},
    ]}
    agents = {
        "a1-x": [{"t": T + skew + 1.05, "ev": "agent", "phase": "lease", "agent": "a1-x",
                  "exp": "e1", "pid": 0, "sid": 1},
                 {"t": T + skew + 4.5, "ev": "agent", "phase": "done", "agent": "a1-x",
                  "exp": "e1", "pid": 0, "sid": 2}],
        "a2-y": [{"t": T - skew + 1.15, "ev": "agent", "phase": "lease", "agent": "a2-y",
                  "exp": "e1", "pid": 1, "sid": 1},
                 {"t": T - skew + 4.6, "ev": "agent", "phase": "done", "agent": "a2-y",
                  "exp": "e1", "pid": 1, "sid": 2}],
    }
    return fleet, exps, agents


@pytest.mark.parametrize("skew,drop_offsets", [(0.0, False), (120.0, False), (120.0, True)])
def test_unified_trace_as_jax(skew, drop_offsets):
    """Agent process groups, ABIND -> execution -> FINAL flows and
    clock-corrected agent slices, identical to the JAX package's; with the
    journaled offsets dropped, the ``offsets`` argument corrects instead."""
    fleet, exps, agents = _skewed(skew)
    offsets = None
    if drop_offsets:
        fleet = [e for e in fleet if e["ev"] != "clock_offset"]
        offsets = {"a1-x": skew, "a2-y": -skew}
    mine = trace.build_unified_trace(fleet, exps, agent_journals=agents, offsets=offsets)
    assert mine == jax_trace.build_unified_trace(fleet, exps, agent_journals=agents,
                                                 offsets=offsets)
    assert trace.validate_trace(mine) > 0
    assert mine["otherData"]["agents"] == ["a1-x", "a2-y"] and mine["otherData"]["flows"] == 2
    execs = {e["args"]["agent"]: e for e in mine["traceEvents"]
             if e.get("cat") == "agent" and e.get("ph") == "X"}
    abinds = {e["args"]["agent"]: e for e in mine["traceEvents"]
              if str(e.get("name", "")).startswith("abind ")}
    for aid, ex in execs.items():
        assert 0 <= ex["ts"] - abinds[aid]["ts"] < 1_000_000


def test_unified_cli_on_a_fleet_home_as_jax(tmp_path):
    from maggy_tpu.telemetry.__main__ import main as jax_main
    from maggy_tpu_torch.telemetry.__main__ import main

    fleet, exps, agents = _skewed()
    home = tmp_path / "home"
    (home / "journal").mkdir(parents=True)
    (home / "fleet.jsonl").write_text("".join(json.dumps(e) + "\n" for e in fleet))
    (home / "journal" / "e1.jsonl").write_text(
        "".join(json.dumps({**e, "sid": i}) + "\n" for i, e in enumerate(exps["e1"], 1)))
    for aid, evs in agents.items():
        (home / "journal" / (aid + ".jsonl")).write_text(
            "".join(json.dumps(e) + "\n" for e in evs))
    assert main(["trace", str(home), "--unified"]) == 0
    assert jax_main(["trace", str(home), "--unified", "-o", str(tmp_path / "jax.json")]) == 0
    ours = json.loads((home / "unified_trace.json").read_text())
    assert ours == json.loads((tmp_path / "jax.json").read_text())
    assert ours["otherData"]["flows"] == 2


# ------------------------------------------------------------ monitor


@pytest.mark.parametrize("degraded", [False, True])
def test_monitor_sink_view_as_jax(degraded):
    status = {"name": "f", "runners": 2, "active": 1, "queue_depth": 0, "experiments": [],
              "sink": {"agent-1": {"backlog": 5 if degraded else 0, "ingested": 42,
                                   "batches": 7, "degraded": degraded,
                                   "last_event_age_s": 0.1, "last_ingest_age_s": 0.1}}}
    replay = {"sink": {"events": 42, "batches": 7, "sources": 1, "dup": 2,
                       "lag_ms": {"median_ms": 3.0, "p95_ms": 9.0, "n": 7}}}
    text = render_fleet(status, replay)
    assert text == jax_render_fleet(status, replay)
    assert "journal sink: 1 source(s)" in text
    assert ("DEGRADED" in text) is degraded
