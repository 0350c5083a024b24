"""The port's observability plane and profiler on the CPU: Prometheus text
equal to the JAX package's on the same registry snapshots, the four routes
over a real server (/healthz turning 503 and back to 200 with the health
engine's flags), one server a process, a torch.profiler capture's artifact
(thread dump, Chrome trace, the journaled activities), the auto capture's
rate limits and its trigger by the health engine, the degraded mode when
another profiler is active, the driver's registration, and the stall soak
with the plane on (invariant 9)."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from maggy_tpu.telemetry import MetricsRegistry as JaxMetricsRegistry
from maggy_tpu.telemetry import obs as jax_obs

from maggy_tpu_torch import OptimizationConfig, Searchspace, device_gate, experiment
from maggy_tpu_torch.chaos import disarm, harness
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.telemetry import MetricsRegistry, Telemetry, obs, profiling
from maggy_tpu_torch.telemetry.health import HealthEngine
from maggy_tpu_torch.telemetry.profiling import (AUTO_CAPTURE_LIMIT, ProfileCapturer,
                                                 capture_activities)

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]


@pytest.fixture(autouse=True)
def local_env(tmp_path):
    env = LocalEnv(base_dir=str(tmp_path / "exp"))
    EnvSing.set_instance(env)
    disarm()
    yield env
    disarm()
    EnvSing.reset()


@pytest.fixture(autouse=True)
def _no_leaked_obs_server():
    """Every test leaves the process obs server closed."""
    yield
    server = obs.active_server()
    if server is not None:
        for reg in server.registrations():
            obs.deregister(reg)
    assert obs.active_server() is None


def _get(base, route, timeout=5):
    return urllib.request.urlopen(base + route, timeout=timeout)


def _get_json(base, route):
    with _get(base, route) as resp:
        return resp.status, json.loads(resp.read().decode())


def _healthz(base):
    try:
        return _get_json(base, "/healthz")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


# -------------------------------------------------------------- prometheus


def _fill(reg):
    """One registry of every family the renderer labels specially."""
    reg.counter("trial.phase.queued").inc(3)
    reg.counter("trial.phase.finalized").inc(2)
    reg.counter("recovery.lost_runners").inc()
    reg.counter("weird-name.with spaces").inc(5)
    reg.counter("9starts_with_digit_total").inc(1)
    reg.gauge("runner.hb_rtt_ms.p0").set(2.5)
    reg.gauge("runner.cadence_ms.p12").set(51.0)
    reg.gauge("goodput.fraction.p3").set(0.75)
    reg.gauge("goodput.fraction").set(0.5)
    reg.gauge("tenant.chip_seconds.t1").set(12.0)
    reg.gauge("never_set")
    for ms in (0.2, 3.0, 40.0, 900.0, 1e7):
        reg.histogram("rpc.handle_ms.FINAL").observe(ms)
        reg.histogram("suggest_ms").observe(ms / 3)


@pytest.mark.parametrize("labels", [
    [{"experiment": "e", "run": "app/0"}],
    [{"experiment": "a", "run": "app/0"}, {"experiment": 'quo"te\\n', "run": "app/1"}],
    [{}]])
def test_render_prometheus_equals_jax(labels):
    port, jax = [], []
    for lab in labels:
        r, j = MetricsRegistry(), JaxMetricsRegistry()
        _fill(r)
        _fill(j)
        assert r.snapshot() == j.snapshot()
        port.append((lab, r.snapshot()))
        jax.append((lab, j.snapshot()))
    text = obs.render_prometheus(port)
    assert text == jax_obs.render_prometheus(jax)
    assert 'maggy_tpu_runner_hb_rtt_ms{' in text and 'partition="12"' in text
    assert 'maggy_tpu_rpc_handle_ms_bucket{' in text and 'le="+Inf"' in text


# ------------------------------------------------------------------- server


def test_routes_healthz_transitions_and_lifecycle():
    telem = Telemetry()
    telem.metrics.counter("trial.phase.queued").inc(2)

    class FakeHealth:
        flags = []

        def snapshot(self):
            return {"flags": list(self.flags), "raised_total": len(self.flags)}

    health = FakeHealth()
    reg = obs.ObsRegistration("app/0", {"experiment": "e", "run": "app/0"}, telem,
                              status_fn=lambda: {"store": {"trials": 2}}, health=health)
    server = obs.register(reg, port=0)
    assert obs.active_server() is server
    base = "http://{}:{}".format(*server.address)
    with _get(base, "/metrics") as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        assert "maggy_tpu_trial_phase_total" in resp.read().decode()
    code, doc = _get_json(base, "/status")
    assert code == 200 and doc["experiments"]["app/0"]["status"]["store"]["trials"] == 2
    assert doc["experiments"]["app/0"]["telem"]["enabled"] is True
    assert _healthz(base)[0] == 200
    health.flags = [{"check": "hang", "partition": 1}]
    code, doc = _healthz(base)
    assert code == 503 and doc["experiments"]["app/0"]["flags"][0]["check"] == "hang"
    health.flags = []
    assert _healthz(base) == (200, {"status": "ok", "experiments": {
        "app/0": {"flags": [], "raised_total": 0}}})
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base, "/bogus")
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base, "/profilez")
    assert err.value.code == 404  # no profiler registered
    obs.deregister(reg)
    assert obs.active_server() is None
    with pytest.raises(OSError):
        _get(base, "/healthz", timeout=1)


def test_one_server_per_process_and_refcounted_close():
    r1 = obs.ObsRegistration("a/0", {"experiment": "a"}, Telemetry())
    r2 = obs.ObsRegistration("b/0", {"experiment": "b"}, Telemetry())
    s1, s2 = obs.register(r1, port=0), obs.register(r2, port=0)
    assert s1 is s2
    base = "http://{}:{}".format(*s1.address)
    assert set(_get_json(base, "/status")[1]["experiments"]) == {"a/0", "b/0"}
    obs.deregister(r1)
    assert obs.active_server() is s1
    assert set(_get_json(base, "/status")[1]["experiments"]) == {"b/0"}
    obs.deregister(r2)
    assert obs.active_server() is None


def test_profilez_captures_a_torch_trace(tmp_path):
    telem = Telemetry()
    prof = ProfileCapturer(telem, str(tmp_path / "profiles"))
    # The profiler's first start (seconds on a loaded CPU) is paid here, as
    # the driver pays it before its runners step, not inside the request.
    prof.prime()
    reg = obs.ObsRegistration("k", {}, telem, profiler=prof)
    server = obs.register(reg, port=0)
    base = "http://{}:{}".format(*server.address)
    try:
        code, doc = _get_json(base, "/profilez?duration_s=0.1")
        assert code == 200 and doc["reason"] == "manual" and doc["profiler"] == "torch"
        assert sorted(os.listdir(doc["path"])) == ["threads.txt", "trace.json"]
        assert doc["trace_bytes"] == os.path.getsize(doc["trace"]) > 0
    finally:
        obs.deregister(reg)


# ----------------------------------------------------------------- profiler


def test_capture_artifact_and_journal(tmp_path):
    telem = Telemetry()
    prof = ProfileCapturer(telem, str(tmp_path / "profiles"))
    x = torch.randn(64, 64)
    stop = threading.Event()

    def work():
        # A runner's steps hold the process's device gate, as the trainers'
        # do, so the profiler's start and stop never run beside one.
        while not stop.is_set():
            with device_gate.step():
                x @ x

    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    try:
        record = prof.capture(duration_s=0.2, reason="manual", partition=2, trial="t")
    finally:
        stop.set()
        worker.join(10)
    assert not worker.is_alive()
    # CPU only: this process never initialized CUDA.
    assert capture_activities() == ["cpu"] and record["activities"] == ["cpu"]
    assert record["profiler"] == "torch"
    with open(os.path.join(record["path"], "threads.txt")) as f:
        assert "test_capture_artifact_and_journal" in f.read()
    with open(record["trace"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    (ev,) = [e for e in telem.events() if e["ev"] == "profile_captured"]
    assert {k: ev[k] for k in ("path", "reason", "partition", "trial", "activities")} == \
        {"path": record["path"], "reason": "manual", "partition": 2, "trial": "t",
         "activities": ["cpu"]}


def test_another_profiler_active_degrades_to_the_dump(tmp_path):
    telem = Telemetry()
    prof = ProfileCapturer(telem, str(tmp_path / "profiles"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        record = prof.capture(duration_s=0.05)
    assert record["profiler"] == "unavailable" and "active" in record["profiler_error"]
    assert os.listdir(record["path"]) == ["threads.txt"]


def test_prime_starts_and_stops_one_empty_window(tmp_path):
    telem = Telemetry()
    prof = ProfileCapturer(telem, str(tmp_path / "profiles"))
    assert prof.prime() >= 0
    assert not torch.autograd.profiler._is_profiler_enabled
    assert telem.events() == [] and not (tmp_path / "profiles").exists()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        prof.prime()  # another profiler is active: nothing started
        assert torch.autograd.profiler._is_profiler_enabled


def _contenders(gate):
    """Start a step and a capture on threads of their own under ``gate``;
    returns what ran within 0.3 s and the threads."""
    done, threads = [], []
    for kind in ("step", "capture"):
        def run(kind=kind):
            with getattr(gate, kind)():
                done.append(kind)

        threads.append(threading.Thread(target=run))
        threads[-1].start()
        threads[-1].join(0.3)
    return done, threads


@pytest.mark.parametrize("call", ["start", "stop"])
def test_the_gates_holds(call, monkeypatch, tmp_path):
    """The profiler's start and its stop hold steps and captures out; the
    trace is written after the stop, outside the gate."""
    from maggy_tpu_torch import device_gate

    seen = {}

    class FakeProfile:
        def __init__(self, activities):
            pass

        def _contend(self, name):
            if name == call:
                done, seen["threads"] = _contenders(device_gate)
                seen["done"] = list(done)
                seen["held"] = [t.is_alive() for t in seen["threads"]]

        def start(self):
            self._contend("start")

        def stop(self):
            self._contend("stop")

        def export_chrome_trace(self, path):
            done, threads = _contenders(device_gate)
            seen["at_export"] = sorted(done)
            for t in threads:
                t.join(5)
            open(path, "w").close()

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    prof = profiling._start_trace(["cpu"])
    profiling._stop_trace(prof, str(tmp_path / "trace.json"))
    assert seen["done"] == [] and seen["held"] == [True, True]
    for t in seen["threads"]:
        t.join(5)
    assert seen["at_export"] == ["capture", "step"]


def test_a_capture_collects_first_and_holds_the_collector_off(monkeypatch):
    """``capture_step`` holds the cyclic collector off during the capture
    (a dead graph it destroyed on the capturing thread would invalidate the
    capture), under the gate, and runs no collection of its own: a full
    collection holds every runner thread (the GIL) and doubled `slice`'s
    in-sweep step on the card (PERF.md)."""
    import gc
    from types import SimpleNamespace

    from maggy_tpu_torch import device_gate
    from maggy_tpu_torch.train import trainer

    seen = []

    def empty_cache():
        done, threads = _contenders(device_gate)
        seen.append((done, gc.isenabled()))
        raise RuntimeError("no capture on the CPU")

    monkeypatch.setattr(trainer.gc, "collect", lambda *a: seen.append("collect"))
    monkeypatch.setattr(torch.cuda, "empty_cache", empty_cache)
    slot, unit = SimpleNamespace(graph_ok=True), SimpleNamespace(pool=None)
    was = gc.isenabled()
    assert trainer.capture_step(slot, unit, "cpu", {}, lambda inputs: None) is None
    assert seen == [([], False)]
    assert gc.isenabled() == was and not slot.graph_ok
    assert slot.graph_error == "RuntimeError: no capture on the CPU"


def test_one_capture_at_a_time_in_a_process(tmp_path, monkeypatch):
    entered, release = threading.Event(), threading.Event()

    def slow_start(activities):
        entered.set()
        release.wait(5)
        return "stubbed"

    monkeypatch.setattr(profiling, "_start_trace", slow_start)
    a = ProfileCapturer(Telemetry(), str(tmp_path / "a"))
    b = ProfileCapturer(Telemetry(), str(tmp_path / "b"))
    first = threading.Thread(target=a.capture, kwargs={"duration_s": 0.01}, daemon=True)
    first.start()
    assert entered.wait(5)
    assert b.capture(duration_s=0.01) == {"skipped": "capture already in flight"}
    release.set()
    first.join(10)
    assert not first.is_alive()


def test_auto_capture_rate_limits(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "_start_trace", lambda activities: "stubbed")
    telem = Telemetry()
    prof = ProfileCapturer(telem, str(tmp_path / "profiles"))
    assert not prof.auto_capture("hb_rtt", partition=0)
    assert not prof.auto_capture("hang", partition=None)
    assert prof.auto_capture("hang", partition=0, trial="t0")
    assert not prof.auto_capture("straggler", partition=0)  # once a partition
    assert prof.auto_capture("straggler", partition=1)
    assert not prof.auto_capture("hang", partition=2)  # the run's limit
    prof.join()
    auto = [e for e in telem.events() if e["ev"] == "profile_captured"]
    assert sorted(e["partition"] for e in auto) == [0, 1] and AUTO_CAPTURE_LIMIT == 2
    assert all(e["reason"] == "auto" for e in auto)


def test_health_flag_triggers_one_capture(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "_start_trace", lambda activities: "stubbed")
    telem = Telemetry()
    telem.trial_event("a", "running", partition=0)
    prof = ProfileCapturer(telem, str(tmp_path / "profiles"))
    engine = HealthEngine(telem, hb_interval=0.01, hang_factor=1.0)
    engine.attach(profiler=prof)
    time.sleep(0.1)
    assert [f["check"] for f in engine.check()] == ["hang"]
    engine.check()
    prof.join()
    (ev,) = [e for e in telem.events() if e["ev"] == "profile_captured"]
    assert (ev["check"], ev["partition"], ev["trial"]) == ("hang", 0, "a")


# ------------------------------------------------------------------- driver


def _sweep(tmp_path, **kw):
    seen = {}

    def train(x, reporter):
        server = obs.active_server()
        if server is not None and "status" not in seen:
            base = "http://{}:{}".format(*server.address)
            seen["status"] = _get_json(base, "/status")[1]
            with _get(base, "/metrics") as resp:
                seen["metrics"] = resp.read().decode()
        for i in range(3):
            reporter.broadcast(x, step=i)
        return x

    result = experiment.lagom(train, OptimizationConfig(
        num_trials=3, searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0])), num_workers=2,
        hb_interval=0.05, seed=0, es_policy="none", experiment_dir=str(tmp_path / "e"), **kw))
    return result, seen


def test_obs_is_off_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("MAGGY_TPU_OBS_PORT", raising=False)
    result, seen = _sweep(tmp_path)
    assert result["num_trials"] == 3 and seen == {}


def test_driver_registers_and_deregisters(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGGY_TPU_OBS_PORT", "0")
    assert OptimizationConfig().resolved_obs_port() == 0
    assert OptimizationConfig(obs_port=9).resolved_obs_port() == 9
    result, seen = _sweep(tmp_path)
    assert result["num_trials"] == 3 and obs.active_server() is None
    (doc,) = seen["status"]["experiments"].values()
    assert doc["status"]["driver"] == "OptimizationDriver"
    assert set(doc["status"]["store"]) == {"trials", "finalized", "requeue", "parked",
                                           "gang_wait"}
    assert "health" in doc["telem"]
    assert "maggy_tpu_trial_phase_total" in seen["metrics"]
    (journal,) = (tmp_path / "e").glob("*/telemetry.jsonl")
    started = [json.loads(line) for line in open(journal)
               if '"obs_started"' in line]
    assert len(started) == 1 and started[0]["port"] > 0
    assert started[0]["profiler_primed_s"] >= 0


def test_stall_soak_with_the_plane_on(tmp_path):
    """Invariant 9: the endpoints answer throughout, /healthz reads 503
    while the stall is flagged and 200 after it, and the flag yields
    exactly one auto capture with its trace."""
    # Enough trials that the sweep outlives the stall's flags (hang, and
    # hb_rtt while the stalled beat's round trip decays out of its EWMA).
    report = harness.run_soak(plan=harness.stall_plan(7), seed=7, hb_loss_timeout=10.0,
                              num_trials=36, base_dir=str(tmp_path / "stall"), obs=True,
                              config_overrides={"health_hang_factor": 10.0,
                                                "health_interval_s": 0.1})
    assert report["ok"], report["violations"]
    codes = [code for _, code in report["obs"]["healthz"]]
    assert 503 in codes and 200 in codes[codes.index(503):]
    assert report["profiles"]["auto"] == 1
    from maggy_tpu_torch.telemetry import read_events

    (ev,) = [e for e in read_events(report["journal"]) if e["ev"] == "profile_captured"]
    assert sorted(os.listdir(ev["path"])) == ["threads.txt", "trace.json"]
