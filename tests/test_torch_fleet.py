"""The port's shared fleet against maggy_tpu's on the CPU: the scheduler's
targets, admission, shedding, bindings and preemptions in lockstep for one
seeded sequence of submissions; the shared listener's routing and its
refusal of a bad MAC; ``run_fleet_soak(seed=7)`` through both packages; each
package's ``fleet.jsonl`` replayed by the other to the same numbers; the
spool CLI; ``preempt_partition(evict=True)`` and the server's eviction
paths in both packages; ``lagom_submit(block=False)``; the fleet trace and
goodput CLI on a fleet home, and its unified trace; the refusal of gang
blocks, and the sink's and the agent plane's defaults. Every comparison is
exact unless a test says otherwise."""

import copy
import json
import os
import socket
import time

import numpy as np
import pytest

from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.core.driver.optimization_driver import OptimizationDriver as JaxDriver
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.fleet import scheduler as jax_scheduler
from maggy_tpu.fleet import soak as jax_soak
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu.trial import Trial as JaxTrial

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv
from maggy_tpu_torch.fleet import scheduler, soak
from maggy_tpu_torch.fleet import FleetSaturated
from maggy_tpu_torch.trial import Trial

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

SPACE = dict(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64]))


@pytest.fixture(autouse=True)
def envs(tmp_path):
    EnvSing.set_instance(LocalEnv(base_dir=str(tmp_path / "port_env")))
    JaxEnvSing.set_instance(JaxLocalEnv(base_dir=str(tmp_path / "jax_env")))
    yield
    EnvSing.reset()
    JaxEnvSing.reset()


# ------------------------------------------------------ scheduler lockstep


class _Driver:
    """What the scheduler reads of a driver, and the preemptions it asks."""

    def __init__(self, log, name):
        self.experiment_done = False
        self.exp_dir = None
        self._log, self._name = log, name

    def preempt_partition(self, pid, evict=False):
        self._log.append((self._name, pid, evict))
        return "trial-{}-{}".format(self._name, pid)


def _strip(snapshot):
    """A scheduler snapshot without its wall-clock fields."""
    out = copy.deepcopy(snapshot)
    out.pop("chip_seconds", None)
    for e in out["experiments"]:
        for k in ("service_s", "chip_seconds", "queue_wait_s"):
            e.pop(k, None)
    return out


class _Clock:
    """The scheduler module's ``time``, stepped by the sequence: the
    targets' cache, virtual time and the preemption grace read it, so the
    two packages decide on the same clock whatever the host's load."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return self.now


def _lockstep(mod, seed, monkeypatch):
    """One seeded sequence of submissions, activations, bindings, releases,
    preemption sweeps and finishes through ``mod``'s scheduler on a stepped
    clock; returns every decision it made."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    rng = np.random.default_rng(seed)
    sched = mod.FleetScheduler(5, max_active=4, max_queued=3, preempt_grace_s=0.0)
    preempted, trace, entries, bound = [], [], {}, {}
    classes = ["high", "normal", "low", 0, 3]
    for step in range(40):
        clock.now += 0.1
        op = rng.integers(0, 6)
        if op <= 1:
            name = "exp{}".format(step)
            lo = int(rng.integers(0, 3))
            policy = mod.FleetPolicy(priority=classes[int(rng.integers(0, 5))],
                                     weight=float(rng.integers(1, 4)), min_runners=lo,
                                     max_runners=None if rng.random() < 0.5
                                     else lo + int(rng.integers(1, 3)))
            try:
                entries[name] = sched.submit(name, policy)
                trace.append(("submit", name, entries[name].state))
            except mod.FleetSaturated:
                trace.append(("shed", name))
        elif op == 2:
            for name, e in sorted(entries.items()):
                if e.state == "active" and e.driver is None:
                    sched.activate(e, _Driver(preempted, name), lambda pid: None,
                                   slots=int(rng.integers(1, 5)))
                    trace.append(("activate", name))
            with sched._lock:
                trace.append(("targets", sorted(sched._compute_targets_locked().items())))
        elif op == 3:
            runner = int(rng.integers(0, 5))
            if runner not in bound:
                got = sched.next_binding(runner, timeout=0)
                if got is not None:
                    bound[runner] = got
                trace.append(("bind", runner, None if got is None else (got[0].name, got[1])))
        elif op == 4 and bound:
            runner = sorted(bound)[int(rng.integers(0, len(bound)))]
            entry, pid = bound.pop(runner)
            sched.release_binding(runner, entry, pid)
            trace.append(("release", runner, entry.name, pid))
        else:
            trace.append(("preempt", sched.maybe_preempt(), list(preempted)))
            live = [n for n, e in sorted(entries.items()) if e.state == "active"]
            if live and rng.random() < 0.3:
                name = live[int(rng.integers(0, len(live)))]
                for runner, (entry, pid) in list(bound.items()):
                    if entry.name == name:
                        sched.release_binding(runner, entry, pid)
                        del bound[runner]
                sched.finish(entries[name], "done")
                trace.append(("finish", name))
        trace.append(("snapshot", _strip(sched.snapshot()), sched.saturated()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_decides_as_jax_for_a_seeded_sequence(seed, monkeypatch):
    port, jax = _lockstep(scheduler, seed, monkeypatch), _lockstep(jax_scheduler, seed,
                                                                  monkeypatch)
    assert port == jax
    kinds = {t[0] for t in port}
    assert {"submit", "bind", "targets", "preempt"} <= kinds


def test_policy_and_priority_validation_as_jax():
    for mod in (scheduler, jax_scheduler):
        assert mod.priority_rank("high") < mod.priority_rank("normal") < mod.priority_rank("low")
        for bad in (dict(weight=0), dict(min_runners=-1), dict(min_runners=3, max_runners=2),
                    dict(priority="nope"), dict(priority=True)):
            with pytest.raises(ValueError):
                mod.FleetPolicy(**bad)


# ---------------------------------------------------------- shared listener


def test_shared_listener_routes_by_secret_and_drops_a_bad_mac():
    shared = rpc.SharedServer()
    s1, s2 = rpc.Server(secret="aa" * 16, num_executors=1), rpc.Server(secret="bb" * 16,
                                                                         num_executors=2)
    addr = shared.attach(s1)
    assert shared.attach(s2) == addr
    try:
        c1 = rpc.Client(addr, 0, 1.0, s1.secret_hex)
        c2 = rpc.Client(addr, 0, 1.0, s2.secret_hex)
        assert c1._request({"type": "QUERY"})["done"] is False
        s1.reservations.add({"partition_id": 0})
        assert c1._request({"type": "QUERY"})["done"] is True
        s2.reservations.add({"partition_id": 0})
        assert c2._request({"type": "QUERY"})["done"] is False
        # A bound connection verifies against its own server only: a frame
        # signed with the other tenant's secret drops it (no re-binding).
        sock = socket.create_connection(addr, timeout=5)
        rpc.MessageSocket.send_msg(sock, {"type": "QUERY"}, s1.secret)
        assert rpc.MessageSocket.recv_msg(sock, s1.secret)["done"] is True
        rpc.MessageSocket.send_msg(sock, {"type": "QUERY"}, s2.secret)
        with pytest.raises((ConnectionError, OSError)):
            rpc.MessageSocket.recv_msg(sock, s2.secret)
        sock.close()
        # A bad MAC: no secret authenticates it, and the connection drops.
        bad = rpc.Client(addr, 0, 1.0, "dd" * 16)
        with pytest.raises(ConnectionError):
            bad._request({"type": "QUERY"})
        bad.stop()
        c1.stop()
        c2.stop()
        # A detached tenant's secret no longer authenticates.
        s1.stop()
        assert s1._shared is None
        late = rpc.Client(addr, 0, 1.0, s1.secret_hex)
        with pytest.raises(ConnectionError):
            late._request({"type": "QUERY"})
        late.stop()
    finally:
        shared.stop()


def test_a_full_tenant_queue_sheds_only_that_tenant(monkeypatch):
    """Per-tenant backpressure: a tenant whose dispatcher queue is full has
    its frame shed with the connection; the other tenant is answered."""
    monkeypatch.setattr(rpc, "_sleep", lambda s: None)
    shared = rpc.SharedServer(tenant_queue_depth=1)
    slow, fast = rpc.Server(num_executors=1), rpc.Server(num_executors=1)
    addr = shared.attach(slow)
    shared.attach(fast)
    gate = __import__("threading").Event()
    slow._handlers["QUERY"] = lambda msg: (gate.wait(5), {"type": "QUERY"})[1]
    try:
        socks = []
        for _ in range(3):
            s = socket.create_connection(addr, timeout=5)
            rpc.MessageSocket.send_msg(s, {"type": "QUERY"}, slow.secret)
            socks.append(s)
        time.sleep(0.3)
        c = rpc.Client(addr, 0, 1.0, fast.secret_hex)
        assert c._request({"type": "QUERY"})["done"] is False
        c.stop()
        gate.set()
        for s in socks:
            s.close()
    finally:
        gate.set()
        shared.stop()


# ----------------------------------------------------------- the soaks


def _soaks(tmp_path):
    out = {}
    for name, mod in (("port", soak), ("jax", jax_soak)):
        out[name] = mod.run_fleet_soak(seed=7, base_dir=str(tmp_path / name))
    return out


@pytest.mark.timeout(120)
def test_fleet_soak_and_journal_replay_as_jax(tmp_path):
    """``run_fleet_soak(seed=7)`` through both packages: both schedules
    complete, the scheduler preempted and the bulk driver executed it, no
    violations; each package's fleet.jsonl replays to the same numbers
    through the other's ``replay_fleet_journal``."""
    out = _soaks(tmp_path)
    for name, report in out.items():
        assert report["ok"], (name, report["violations"])
        # The fleet journal's preemption; whether it caught a trial or an
        # idle runner between trials is the race of the soak's timing.
        assert report["replay"]["preemptions"] >= 1, name
        assert {k: v["num_trials"] for k, v in report["results"].items()} == \
            {"bulk": 6, "urgent": 2}, name
    for name, report in out.items():
        journal = report["journal"]
        port, jax = scheduler.replay_fleet_journal(journal), \
            jax_scheduler.replay_fleet_journal(journal)
        assert port == jax, name
        assert set(port["experiments"]) == {"bulk", "urgent"}


@pytest.mark.timeout(120)
def test_fleet_trace_goodput_and_monitor_on_a_fleet_home(tmp_path, capsys):
    from maggy_tpu.telemetry.trace import build_fleet_trace as jax_build
    from maggy_tpu_torch import monitor
    from maggy_tpu_torch.telemetry import read_events
    from maggy_tpu_torch.telemetry.__main__ import main as telem_main
    from maggy_tpu_torch.telemetry.trace import build_fleet_trace, validate_trace

    report = soak.run_fleet_soak(seed=7, base_dir=str(tmp_path / "runs"))
    home = os.path.dirname(report["journal"])
    assert telem_main(["trace", home]) == 0
    with open(os.path.join(home, "fleet_trace.json")) as f:
        trace = json.load(f)
    assert validate_trace(trace) > 0
    assert trace["otherData"]["experiments"] == ["bulk", "urgent"]
    fleet_events = read_events(report["journal"])
    exps = {e: read_events(os.path.join(d, "telemetry.jsonl"))
            for e, d in {ev["exp"]: ev["exp_dir"] for ev in fleet_events
                         if ev.get("exp") and ev.get("exp_dir")}.items()}
    assert build_fleet_trace(fleet_events, exps) == jax_build(fleet_events, exps)
    capsys.readouterr()
    assert telem_main(["goodput", home]) == 0
    text = capsys.readouterr().out
    assert "tenant bulk:" in text and "tenant urgent:" in text
    assert monitor.main(["--fleet", home, "--once"]) == 0
    assert "bulk [done, prio low, w 1.0]" in capsys.readouterr().out
    # The unified trace of a fleet home whose tenants journal locally: the
    # same trace as the JAX package's CLI builds from the same home.
    from maggy_tpu.telemetry.__main__ import main as jax_telem_main

    assert telem_main(["trace", "--unified", home]) == 0
    assert jax_telem_main(["trace", "--unified", home, "-o",
                           str(tmp_path / "jax_unified.json")]) == 0
    with open(os.path.join(home, "unified_trace.json")) as f, \
            open(str(tmp_path / "jax_unified.json")) as g:
        assert json.load(f) == json.load(g)


# ---------------------------------------------------------------- the CLI


@pytest.mark.timeout(90)
def test_spool_cli_submit_start_and_status(tmp_path, capsys, monkeypatch):
    from maggy_tpu_torch.fleet.__main__ import main as fleet_main

    home = str(tmp_path / "home")
    spec = {"name": "cli_exp", "train_fn": "maggy_tpu_torch.fleet.soak:demo_train_fn",
            "priority": "normal", "weight": 1.0,
            "config": {"num_trials": 2, "optimizer": "randomsearch", "direction": "max",
                       "hb_interval": 0.05, "seed": 5, "es_policy": "none",
                       "searchspace": {"lr": ["DOUBLE", [0.0, 0.2]],
                                       "units": ["INTEGER", [8, 64]]}}}
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    os.makedirs(home + "/queue")
    assert fleet_main(["submit", "--home", home, spec_path]) == 0
    assert fleet_main(["start", "--home", home, "--runners", "2",
                       "--base-dir", str(tmp_path / "runs"), "--poll", "0.1",
                       "--idle-exit", "0.5"]) == 0
    with open(home + "/status.json") as f:
        status = json.load(f)
    assert [e["state"] for e in status["experiments"]] == ["done"]
    assert status["experiments"][0]["name"].startswith("cli_exp")
    capsys.readouterr()
    assert fleet_main(["status", "--home", home]) == 0
    assert "cli_exp" in capsys.readouterr().out
    # An agent refuses to start without a card unless it runs on the CPU,
    # and then still needs a ticket or an address. (The agent's device
    # choice writes the process's environment: restored at teardown.)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv("MAGGY_TPU_TORCH_DEVICE", "cuda")
    with pytest.raises(SystemExit, match="no CUDA device"):
        fleet_main(["agent"])
    with pytest.raises(SystemExit, match="--ticket or --fleet-addr"):
        fleet_main(["agent", "--device", "cpu"])


# --------------------------------------------------------------- eviction


def _drivers(tmp_path):
    port = OptimizationDriver(OptimizationConfig(
        name="evict", num_trials=2, searchspace=Searchspace(**SPACE), num_workers=2,
        es_policy="none", experiment_dir=str(tmp_path / "port"), hb_interval=0.05),
        "evict", 0)
    jax = JaxDriver(JaxConfig(
        name="evict", num_trials=2, searchspace=JaxSearchspace(**SPACE), num_workers=2,
        es_policy="none", experiment_dir=str(tmp_path / "jax"), hb_interval=0.05),
        "evict", 0)
    return {"port": (port, Trial), "jax": (jax, JaxTrial)}


def test_preempt_partition_with_eviction_as_jax(tmp_path):
    """``evict=True`` flags the running trial and parks the release: the
    preempted FINAL of the busy runner and the GET of the idle one both
    draw GSTOP, the idle runner's undelivered assignment goes back to the
    schedule as a never-started preemption, and an eviction of a slot not
    yet registered is applied at its REG. Same replies and flags in both
    packages."""
    pair = _drivers(tmp_path)
    out = {}
    try:
        for name, (driver, trial_cls) in pair.items():
            server = driver.server
            queued = []
            driver.enqueue = queued.append
            res = server.reservations
            trials = [trial_cls({"lr": 0.05 * (i + 1), "units": 8}) for i in range(2)]
            with driver._store_lock:
                for t in trials:
                    driver._trial_store[t.trial_id] = t
            for pid in (0, 1):
                res.add({"partition_id": pid})
            res.assign_trial(0, trials[0].trial_id)
            res.assign_trial(1, trials[1].trial_id)
            busy = driver.preempt_partition(0, evict=True)
            got = [busy == trials[0].trial_id, trials[0].get_preempt(),
                   trials[0].get_early_stop(), res.evict_requested(0)]
            # The idle runner (its assignment never delivered) is evicted
            # at its next GET.
            driver.preempt_partition(1, evict=True)
            reply = server.handle_message({"type": "GET", "partition_id": 1})
            got += [reply["type"], res.get(1).get("released"),
                    [(m["type"], m.get("preempted"), m.get("step")) for m in queued]]
            # The busy runner's preempted ack on the worker path: GSTOP.
            driver.process_final_inline = lambda msg: False
            reply = server.handle_message({"type": "FINAL", "partition_id": 0,
                                           "trial_id": trials[0].trial_id, "preempted": True,
                                           "step": 3, "epoch": trials[0].run_epoch,
                                           "logs": []})
            got += [reply["type"], res.get(0).get("released")]
            # An eviction before REG is applied at registration.
            res.request_evict(5)
            res.add({"partition_id": 5})
            got.append(res.evict_requested(5))
            out[name] = got
    finally:
        for driver, _ in pair.values():
            driver.stop()
    assert out["port"] == out["jax"]
    assert out["port"][:4] == [True, True, True, True]
    assert out["port"][4:6] == ["GSTOP", True]


# ------------------------------------------------------------ lagom_submit


@pytest.mark.timeout(90)
def test_lagom_submit_returns_a_handle_and_runs_many_at_once(tmp_path):
    fleet = scheduler.Fleet(runners=2, home_dir=str(tmp_path / "home"))

    def cfg(name):
        return OptimizationConfig(name=name, num_trials=3, searchspace=Searchspace(**SPACE),
                                  direction="max", hb_interval=0.05, seed=7,
                                  es_policy="none", experiment_dir=str(tmp_path / "runs"))

    with fleet:
        a = experiment.lagom_submit(soak.demo_train_fn, cfg("a"), fleet=fleet, block=False)
        b = experiment.lagom_submit(soak.demo_train_fn, cfg("b"), fleet=fleet, weight=2.0,
                                    block=False)
        assert isinstance(a, scheduler.FleetSubmission)
        results = a.result(timeout=60), b.result(timeout=60)
        assert a.done() and b.done()
        # block=True returns the result itself, as lagom does.
        c = experiment.lagom_submit(soak.demo_train_fn, cfg("c"), fleet=fleet)
    assert [r["num_trials"] for r in results + (c,)] == [3, 3, 3]
    # The tenants' run ids were claimed atomically: three run dirs.
    runs = [d for d in os.listdir(tmp_path / "runs") if not d.startswith(".")]
    assert len(runs) == 3
    with pytest.raises(RuntimeError, match="shut down"):
        fleet.submit(soak.demo_train_fn, cfg("late"))


def test_fleet_shedding_raises_fleet_saturated(tmp_path):
    sched = scheduler.FleetScheduler(1, max_active=1, max_queued=1)
    sched.submit("a", scheduler.FleetPolicy())
    sched.submit("b", scheduler.FleetPolicy())
    assert sched.saturated()
    with pytest.raises(FleetSaturated):
        sched.submit("c", scheduler.FleetPolicy())
    assert sched.shed_count == 1 and sched.snapshot()["shed"] == 1


# -------------------------------------------------------------- refusals


def test_the_sink_and_the_agent_plane_are_refused(tmp_path):
    """A gang larger than the fleet is refused as in the JAX scheduler
    (the blocks themselves run, tests/test_torch_gang_driver.py); the
    journal sink and the agent plane run, with the JAX package's defaults:
    the sink on whenever the fleet's telemetry is, no agent slots. (The
    name is kept from when the port refused the sink and the agents.)"""
    for sched in (scheduler.FleetScheduler(2), jax_scheduler.FleetScheduler(2)):
        with pytest.raises(ValueError, match="never assemble"):
            sched.request_gang(None, 4)
    assert OptimizationConfig(sink=True).sink and not OptimizationConfig().sink
    for telemetry, sink, on in ((True, None, True), (False, None, False),
                                (True, False, False), (False, True, True)):
        kw = dict(runners=1, telemetry=telemetry, sink=sink)
        port = scheduler.Fleet(home_dir=str(tmp_path / "p{}{}".format(telemetry, sink)), **kw)
        jax = jax_scheduler.Fleet(home_dir=str(tmp_path / "j{}{}".format(telemetry, sink)),
                                  **kw)
        assert port.sink_enabled == jax.sink_enabled == on
    with scheduler.Fleet(runners=1, home_dir=str(tmp_path / "a"), max_agents=2) as fleet:
        assert fleet.agent_plane is not None and fleet.sink_binding() is not None
        with open(os.path.join(fleet.home_dir, "agent_ticket.json")) as f:
            ticket = json.load(f)
        assert (ticket["host"], ticket["port"]) == fleet.shared_server.addr
        assert ticket["max_agents"] == 2 and ticket["sink"] == fleet.sink_server.secret_hex
        assert fleet.status()["agents"] == [] and fleet.status()["max_agents"] == 2
