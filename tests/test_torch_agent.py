"""The port's fleet agents (``maggy_tpu_torch/fleet/agent.py``) against
maggy_tpu's on the CPU, following ``tests/test_agent.py``'s classes but its
gang rendezvous: the train function's wire name and the fleet ticket; the
AJOIN / ALEASE / ADONE contract over a real socket; one agent re-bound
across two experiments; an agent's death mid-lease (lease revoked, trial
requeued exactly once) and before its REG; agent-slot scheduling and the
ABIND's executor config; the agent's obs plane, the fleet's agents table
and replay; the CLI (an agent process on ``--device cpu``, one that refuses
to start without a card) and the agent-kill soak. Scenarios run through both
packages where both can, and their outcomes are compared exactly; each
agent process a test starts is killed in a ``finally``."""

import dataclasses
import functools
import glob
import json
import os
import threading
import time

import pytest

from maggy_tpu import experiment as jax_experiment
from maggy_tpu.chaos.harness import check_invariants as jax_check_invariants
from maggy_tpu.core import rpc as jax_rpc
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.fleet import agent as jax_agent
from maggy_tpu.fleet import scheduler as jax_scheduler
from maggy_tpu.fleet import soak as jax_soak
from maggy_tpu.monitor import render_fleet as jax_render_fleet
from maggy_tpu.telemetry import read_events as jax_read_events

from maggy_tpu_torch import experiment
from maggy_tpu_torch.chaos.harness import check_invariants
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.fleet import agent, scheduler, soak
from maggy_tpu_torch.monitor import render_fleet
from maggy_tpu_torch.telemetry import JOURNAL_NAME, read_events

pytestmark = [pytest.mark.torch, pytest.mark.timeout(90)]

PKGS = {
    "port": dict(experiment=experiment, agent=agent, scheduler=scheduler, soak=soak,
                 rpc=rpc, read_events=read_events,
                 client=lambda addr, pid, hb, secret: rpc.Client(addr, pid, hb, secret)),
    "jax": dict(experiment=jax_experiment, agent=jax_agent, scheduler=jax_scheduler,
                soak=jax_soak, rpc=jax_rpc, read_events=jax_read_events,
                client=lambda addr, pid, hb, secret: jax_rpc.Client(addr, pid, 0, hb, secret)),
}


@pytest.fixture(autouse=True)
def envs(tmp_path):
    EnvSing.set_instance(LocalEnv(base_dir=str(tmp_path / "port_env")))
    JaxEnvSing.set_instance(JaxLocalEnv(base_dir=str(tmp_path / "jax_env")))
    yield
    EnvSing.reset()
    JaxEnvSing.reset()


def _fleet(pkg, base, runners=1, max_agents=1, liveness=5.0, **kwargs):
    return PKGS[pkg]["scheduler"].Fleet(runners=runners, max_agents=max_agents,
                                         home_dir=os.path.join(str(base), "fleet"),
                                         agent_liveness_s=liveness, **kwargs)


def _ticket(pkg, fleet):
    return PKGS[pkg]["agent"].read_fleet_ticket(
        os.path.join(fleet.home_dir, "agent_ticket.json"), wait_s=5.0)


def _cfg(pkg, name, trials, base, seed=1, **over):
    cfg = PKGS[pkg]["soak"]._scale_config(name, trials, str(base), seed, telemetry=True)
    return dataclasses.replace(cfg, **over) if over else cfg


def _submit(pkg, fleet, fn_name, name, trials, base, seed=1, **over):
    mod = PKGS[pkg]
    return mod["experiment"].lagom_submit(getattr(mod["soak"], fn_name),
                                          _cfg(pkg, name, trials, base, seed, **over),
                                          fleet=fleet, block=False, name=name)


def _replay(pkg, fleet):
    return PKGS[pkg]["scheduler"].replay_fleet_journal(
        os.path.join(fleet.home_dir, "fleet.jsonl"))


def _join(channel, host="h"):
    return channel.call({"type": "AJOIN", "host": host, "chips": 1, "process_index": 0,
                         "coord_addr": None, "os_pid": None, "agent": None})


def _await_lease(channel, agent_id, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        resp = channel.call({"type": "ALEASE", "agent": agent_id})
        if resp["type"] == "ABIND":
            return resp
        time.sleep(0.05)
    return None


class _Reporter:
    """What a Client driven by hand reads of its reporter."""

    def __init__(self):
        self.lock = threading.RLock()
        self.trial_id = None

    def get_data(self):
        return {"metric": None, "step": None, "logs": [], "trial_id": self.trial_id,
                "span": None}

    def reset(self, **kwargs):
        pass

    def log(self, *args, **kwargs):
        pass

    def early_stop(self, **kwargs):
        pass


def _get_trial(client, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        resp = client._request({"type": "GET"})
        if resp.get("type") == "TRIAL":
            client.last_info = resp.get("info", {})
            return resp["trial_id"]
        time.sleep(0.05)
    return None


# ------------------------------------------------------- names and tickets


def _closure():
    def fn(lr):
        return lr
    return fn


def test_train_fn_path_as_jax():
    for fn in (soak.scale_train_fn, jax_soak.scale_train_fn, lambda lr: lr, _closure(),
               functools.partial(soak.scale_train_fn, 0.1), _Reporter.get_data, len):
        assert agent.train_fn_path(fn) == jax_agent.train_fn_path(fn), fn
    assert agent.train_fn_path(soak.scale_train_fn) == \
        "maggy_tpu_torch.fleet.soak:scale_train_fn"
    # A module attribute rebound to another object no longer names it.
    renamed = soak.agent_train_fn
    try:
        soak.agent_train_fn = soak.scale_train_fn
        assert agent.train_fn_path(renamed) is jax_agent.train_fn_path(renamed) is None
    finally:
        soak.agent_train_fn = renamed


def test_fleet_ticket_roundtrip_and_partial_write_as_jax(tmp_path):
    env = LocalEnv(base_dir=str(tmp_path))
    path = str(tmp_path / "agent_ticket.json")
    written = agent.write_fleet_ticket(env, path, "127.0.0.1", 4242, "s3", "f", 2, sink="k")
    assert agent.read_fleet_ticket(path) == jax_agent.read_fleet_ticket(path) == written
    assert written == {"host": "127.0.0.1", "port": 4242, "secret": "s3", "fleet": "f",
                       "max_agents": 2, "sink": "k"}
    for reader in (agent.read_fleet_ticket, jax_agent.read_fleet_ticket):
        with pytest.raises(FileNotFoundError):
            reader(str(tmp_path / "missing.json"))
    torn = str(tmp_path / "torn.json")
    with open(torn, "w") as f:
        f.write('{"host": "127.0.0.1", "po')

    def finish():
        time.sleep(0.3)
        with open(torn, "w") as f:
            json.dump(written, f)

    writer = threading.Thread(target=finish, daemon=True)
    writer.start()
    assert agent.read_fleet_ticket(torn, wait_s=5.0)["port"] == 4242
    writer.join(5)


# ------------------------------------------------------------- wire verbs


def _wire_roundtrip(pkg, base):
    """AJOIN -> ALEASE (OK) -> ABIND -> a re-served ABIND -> REG, GET,
    FINAL -> ADONE over a real socket with raw frames; runners=0, so the
    hand-made agent is the one leased. Returns what the contract showed."""
    mod = PKGS[pkg]
    seen = {}
    with _fleet(pkg, base, runners=0, max_agents=2) as fleet:
        t = _ticket(pkg, fleet)
        ch = mod["agent"]._AgentChannel((t["host"], t["port"]), t["secret"])
        j = ch.call({"type": "AJOIN", "host": "h1", "chips": 2, "process_index": 3,
                     "coord_addr": None, "os_pid": os.getpid(), "agent": None})
        seen["join"] = sorted(j)
        seen["idle"] = ch.call({"type": "ALEASE", "agent": j["agent"]})["type"]
        snap = fleet.status()["agents"][0]
        seen["capacity"] = (snap["chips"], snap["process_index"], snap["state"])
        handle = _submit(pkg, fleet, "scale_train_fn", "wire", 1, base)
        lease = _await_lease(ch, j["agent"])
        seen["lease"] = sorted(lease)
        seen["train_fn"] = lease["train_fn"].split(":")[1]
        seen["own_secret"] = lease["secret"] != t["secret"]
        again = ch.call({"type": "ALEASE", "agent": j["agent"]})
        seen["reserved"] = (again["type"], again["partition_id"] == lease["partition_id"])
        client = mod["client"]((t["host"], t["port"]), lease["partition_id"],
                               lease["hb_interval"], lease["secret"])
        reporter = _Reporter()
        client.register()
        reporter.trial_id = _get_trial(client)
        seen["final"] = client.finalize_metric(0.5, reporter)["type"]
        seen["done"] = ch.call({"type": "ADONE", "agent": j["agent"], "error": None})["type"]
        seen["trials"] = handle.result(timeout=60)["num_trials"]
        client.stop()
        ch.close()
    seen["replay"] = {k: _replay(pkg, fleet)["agents"][k] for k in ("joins", "leases", "losses")}
    return seen


def test_join_lease_done_roundtrip_as_jax(tmp_path):
    port = _wire_roundtrip("port", tmp_path / "port")
    jax = _wire_roundtrip("jax", tmp_path / "jax")
    assert port == jax
    assert port["join"] == ["agent", "liveness_s", "poll_s", "server_t", "type"]
    assert port["idle"] == "OK" and port["capacity"] == (2, 3, "idle")
    assert port["reserved"] == ("ABIND", True) and port["own_secret"]
    # The re-served ABIND journals its delivery again: two lease records.
    assert port["trials"] == 1 and port["replay"] == {"joins": 1, "leases": 2, "losses": 0}


def test_unknown_agent_and_full_fleet_rejected_as_jax(tmp_path):
    for pkg in ("port", "jax"):
        with _fleet(pkg, tmp_path / pkg, max_agents=1) as fleet:
            t = _ticket(pkg, fleet)
            ch = PKGS[pkg]["agent"]._AgentChannel((t["host"], t["port"]), t["secret"])
            assert ch.call({"type": "ALEASE", "agent": "a0-dead"})["type"] == "ERR", pkg
            assert _join(ch)["type"] == "AJOIN", pkg
            full = _join(ch, "h2")
            assert full["type"] == "ERR" and "full" in full["error"], pkg
            ch.close()
    for server in (rpc.FleetAgentServer(1), jax_rpc.FleetAgentServer(1)):
        for verb in ("AJOIN", "ALEASE", "ADONE"):
            assert server.handle_message({"type": verb, "agent": "x"})["type"] == "ERR"


# ------------------------------------------------------ lease and rebind


def _rebind(pkg, base):
    """One in-thread agent leased to experiment A, released, re-bound to
    experiment B on the same fleet; both complete."""
    mod = PKGS[pkg]
    with _fleet(pkg, base, runners=1, max_agents=1) as fleet:
        fa = mod["agent"].FleetAgent(_ticket(pkg, fleet))
        fa.join()
        thread = threading.Thread(target=fa.run, kwargs=dict(max_leases=2), daemon=True)
        thread.start()
        results = [_submit(pkg, fleet, "scale_train_fn", name, 3, base, seed).result(timeout=60)
                   for seed, name in ((1, "reb1"), (2, "reb2"))]
        thread.join(30)
    events = mod["read_events"](os.path.join(fleet.home_dir, "fleet.jsonl"))
    phases = [(e.get("phase"), e.get("exp")) for e in events if e.get("ev") == "agent"]
    replay = _replay(pkg, fleet)["agents"]
    return {"results": [(r["num_trials"], r["best_val"] is not None) for r in results],
            "served": fa.leases_served, "first": phases[0][0],
            "leased": sorted({exp for ph, exp in phases if ph == "lease"}),
            "done": sum(1 for ph, _ in phases if ph == "done"),
            "replay": {k: replay[k] for k in ("joins", "leases", "losses")},
            "abind_n": replay["abind_ms"]["n"]}


def test_one_agent_two_experiments_as_jax(tmp_path):
    port, jax = _rebind("port", tmp_path / "port"), _rebind("jax", tmp_path / "jax")
    assert port == jax
    assert port["results"] == [(3, True), (3, True)] and port["served"] == 2
    assert port["leased"] == ["reb1", "reb2"] and port["first"] == "join"
    assert port["replay"] == {"joins": 1, "leases": 2, "losses": 0} and port["abind_n"] == 2


def test_closure_train_fn_stays_on_threads(tmp_path):
    calls = []

    def closure_fn(lr, units, reporter=None):
        calls.append(lr)
        return {"metric": float(lr)}

    with _fleet("port", tmp_path, runners=1, max_agents=1) as fleet:
        fa = agent.FleetAgent(_ticket("port", fleet))
        fa.join()
        thread = threading.Thread(target=fa.run, daemon=True)
        thread.start()
        result = experiment.lagom_submit(closure_fn, _cfg("port", "clo", 2, tmp_path),
                                         fleet=fleet, block=False, name="clo").result(timeout=60)
        fa.stop()
        thread.join(10)
    assert result["num_trials"] == 2 and len(calls) == 2 and fa.leases_served == 0


# ------------------------------------------------- invariant 11 (death)


def _death_mid_lease(pkg, base):
    """A hand-made agent takes a lease, REGs, receives a trial and
    vanishes: the experiment requeues the trial once and completes on the
    thread runner; the fleet ends the lease as agent_lost."""
    mod = PKGS[pkg]
    with _fleet(pkg, base, runners=1, max_agents=1, liveness=2.0) as fleet:
        t = _ticket(pkg, fleet)
        ch = mod["agent"]._AgentChannel((t["host"], t["port"]), t["secret"])
        j = _join(ch, "fake")
        handle = _submit(pkg, fleet, "agent_train_fn", "death", 3, base,
                         hb_loss_timeout=1.0, hb_interval=0.05)
        lease = _await_lease(ch, j["agent"])
        client = mod["client"]((t["host"], t["port"]), lease["partition_id"],
                               lease["hb_interval"], lease["secret"])
        client.register()
        tid = _get_trial(client)
        for sock in (client._sock, client._hb_sock):
            sock.close()
        ch.close()
        trials = handle.result(timeout=60)["num_trials"]
        state = fleet.status()["agents"][0]["state"]
    requeues = []
    for jp in glob.glob(os.path.join(str(base), "*", JOURNAL_NAME)):
        requeues += [e.get("reason") for e in mod["read_events"](jp)
                     if e.get("ev") == "trial" and e.get("phase") == "requeued"
                     and e.get("trial") == tid]
    replay = _replay(pkg, fleet)["agents"]
    return {"trials": trials, "requeues": requeues, "state": state,
            "losses": replay["losses"], "lost_leases": replay["lost_leases"]}


def test_mid_lease_death_revokes_and_requeues_once_as_jax(tmp_path):
    port = _death_mid_lease("port", tmp_path / "port")
    assert port == _death_mid_lease("jax", tmp_path / "jax")
    assert port == {"trials": 3, "requeues": ["heartbeat_loss"], "state": "lost",
                    "losses": 1, "lost_leases": 1}


def test_death_before_reg_frees_lease_cleanly(tmp_path):
    with _fleet("port", tmp_path, runners=1, max_agents=1, liveness=1.0) as fleet:
        t = _ticket("port", fleet)
        ch = agent._AgentChannel((t["host"], t["port"]), t["secret"])
        j = _join(ch, "fake")
        handle = _submit("port", fleet, "scale_train_fn", "prereg", 2, tmp_path,
                         hb_loss_timeout=1.0)
        assert _await_lease(ch, j["agent"]) is not None
        ch.close()  # dies silently, never REGs
        assert handle.result(timeout=60)["num_trials"] == 2
        deadline = time.monotonic() + 30
        while fleet.status()["agents"][0]["state"] != "lost" and time.monotonic() < deadline:
            time.sleep(0.1)
    assert _replay("port", fleet)["agents"]["lost_leases"] == 1


def test_a_successor_is_not_lost_for_its_predecessors_silence(tmp_path):
    """Agent A dies mid-lease on the experiment's only partition; agent B
    is leased the same partition and REGs only after several of the
    proxy's watch ticks. The record A left is silent past the loss bound,
    but B's lease is judged on B's own registration: one loss, not two."""
    with _fleet("port", tmp_path, runners=0, max_agents=2, liveness=5.0) as fleet:
        t = _ticket("port", fleet)
        chans = [agent._AgentChannel((t["host"], t["port"]), t["secret"]) for _ in range(2)]
        a = _join(chans[0], "a")
        handle = experiment.lagom_submit(
            soak.agent_train_fn, _cfg("port", "succ", 2, tmp_path, hb_loss_timeout=1.0,
                                      hb_interval=0.05),
            fleet=fleet, block=False, name="succ", max_runners=1)
        lease_a = _await_lease(chans[0], a["agent"])
        dead = rpc.Client((t["host"], t["port"]), lease_a["partition_id"],
                          lease_a["hb_interval"], lease_a["secret"])
        dead.register()
        assert _get_trial(dead) is not None
        b = _join(chans[1], "b")
        for sock in (dead._sock, dead._hb_sock):
            sock.close()
        chans[0].close()
        lease_b = _await_lease(chans[1], b["agent"])
        assert lease_b["partition_id"] == lease_a["partition_id"]
        time.sleep(0.5)  # ten of the proxy's ticks, inside the REG grace
        client = rpc.Client((t["host"], t["port"]), lease_b["partition_id"],
                            lease_b["hb_interval"], lease_b["secret"])
        client.register()
        reporter = _Reporter()
        finals, deadline = 0, time.monotonic() + 30
        while time.monotonic() < deadline:
            resp = client._request({"type": "GET"})
            if resp.get("type") == "GSTOP":
                break
            if resp.get("type") == "TRIAL":
                client.last_info = resp.get("info", {})
                reporter.trial_id = resp["trial_id"]
                client.finalize_metric(0.5, reporter)
                finals += 1
            time.sleep(0.05)
        assert chans[1].call({"type": "ADONE", "agent": b["agent"], "error": None})["type"] \
            == "OK"
        assert handle.result(timeout=60)["num_trials"] == 2
        states = {rec["agent"]: rec["state"] for rec in fleet.status()["agents"]}
        client.stop()
        chans[1].close()
    assert finals == 2
    assert states[a["agent"]] == "lost" and states[b["agent"]] != "lost"
    replay = _replay("port", fleet)["agents"]
    assert (replay["losses"], replay["lost_leases"]) == (1, 1)


def test_check_invariants_kill_agent_as_jax():
    def events(requeues, finals=1):
        out = [{"ev": "experiment", "phase": "start", "t": 0.0},
               {"ev": "trial", "trial": "t1", "phase": "queued", "t": 1.0},
               {"ev": "chaos", "kind": "kill_agent", "trial": "t1", "partition": 0,
                "agent": "a1", "t": 2.0}]
        out += [{"ev": "trial", "trial": "t1", "phase": "requeued",
                 "reason": "heartbeat_loss", "t": 3.0 + i} for i in range(requeues)]
        out += [{"ev": "trial", "trial": "t1", "phase": "finalized", "t": 6.0 + i}
                for i in range(finals)]
        return out + [{"ev": "experiment", "phase": "end", "t": 9.0}]

    reports = {}
    for n in (0, 1, 2):
        mine = check_invariants(events(n), stall_flag_bound_s=None)
        assert mine == jax_check_invariants(events(n), stall_flag_bound_s=None), n
        reports[n] = mine
    assert reports[1]["ok"] and reports[1]["recoveries"][0]["outcome"] == "requeued"
    assert any("no requeue" in v for v in reports[0]["violations"])
    assert any("duplicate requeue" in v for v in reports[2]["violations"])


# ----------------------------------------------------------- scheduling


def test_agent_slot_attach_reuse_and_targets_as_jax():
    seqs = []
    for sched in (scheduler.FleetScheduler(2), jax_scheduler.FleetScheduler(2, max_size=4)):
        a, b = sched.agent_slot_attach(), sched.agent_slot_attach()
        seq = [(a, b), sched.fleet_size, sched.is_agent_slot(a), sched.is_agent_slot(1)]
        sched.agent_slot_detach(a)
        seq += [sched.live_agent_slots(), sched.agent_slot_attach(), sched.fleet_size]
        seqs.append(seq)
    assert seqs[0] == seqs[1] == [(2, 3), 4, True, False, 1, 2, 4]


def test_agent_slot_never_binds_an_agentless_entry_as_jax():
    class Driver:
        experiment_done = False
        exp_dir = None

    for sched in (scheduler.FleetScheduler(1), jax_scheduler.FleetScheduler(1, max_size=2)):
        policy = (scheduler if isinstance(sched, scheduler.FleetScheduler)
                  else jax_scheduler).FleetPolicy()
        entry = sched.submit("noagent", policy)
        entry.train_fn_path = None
        sched.activate(entry, Driver(), lambda pid: None, slots=2)
        assert entry.agent_info is None
        assert sched.next_binding(sched.agent_slot_attach(), timeout=0.3) is None
        got = sched.next_binding(0, timeout=5.0)
        assert got is not None and got[0] is entry
        sched.stop()


def test_build_agent_info_shape_as_jax():
    class Cfg:
        warm_start = False

    class Driver:
        hb_interval = 0.5
        exp_dir = "/runs/x"
        optimization_key = "metric"
        config = Cfg()

        @staticmethod
        def secret_for_clients():
            return "s3cret"

    infos = []
    for mod in (scheduler, jax_scheduler):
        entry = mod.ExperimentEntry("e", mod.FleetPolicy(), 0)
        entry.train_fn_path = "m.mod:fn"
        infos.append(mod.FleetScheduler._build_agent_info(entry, Driver()))
        entry.train_fn_path = None
        assert mod.FleetScheduler._build_agent_info(entry, Driver()) is None
    assert infos[0] == infos[1]
    assert infos[0]["train_fn"] == infos[0]["family"] == "m.mod:fn"


# ------------------------------------------------ obs, monitor and replay


def test_agent_healthz_and_status(tmp_path):
    import urllib.request

    from maggy_tpu_torch.telemetry import obs

    with _fleet("port", tmp_path, runners=1, max_agents=1) as fleet:
        fa = agent.FleetAgent(_ticket("port", fleet), obs_port=0,
                              home=str(tmp_path / "agent_home"))
        fa.join()
        thread = threading.Thread(target=fa.run, daemon=True)
        thread.start()
        try:
            deadline = time.monotonic() + 20
            while obs.active_server() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            host, port = obs.active_server().address
            base = "http://{}:{}".format(host, port)
            with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
                assert resp.status == 200
            with urllib.request.urlopen(base + "/status", timeout=5) as resp:
                body = json.loads(resp.read().decode())
            assert "fleet-agent" in json.dumps(body)
        finally:
            fa.stop()
            thread.join(10)
    assert obs.active_server() is None
    # The agent's own journal shipped to the fleet's sink, as source <agent
    # id>; its local agent.jsonl is only the fallback of a degraded sink.
    events = read_events(os.path.join(fleet.home_dir, "journal", fa.agent_id + ".jsonl"))
    assert [e["ev"] for e in events if e["ev"] == "obs_started"] == ["obs_started"]
    assert not os.path.exists(str(tmp_path / "agent_home" / "agent.jsonl"))


def test_render_fleet_agents_table_and_replay_as_jax(tmp_path):
    status = {"name": "f", "runners": 2, "active": 0, "queue_depth": 0, "max_agents": 2,
              "agents": [{"agent": "a1-ab", "runner": 2, "host": "vm1", "chips": 4,
                          "process_index": 0, "state": "leased", "lease": "exp1", "pid": 0,
                          "leases": 3, "last_beat_age_s": 0.1}],
              "experiments": []}
    rows = [{"t": 1.0, "ev": "agent", "phase": "join", "agent": "a1"},
            {"t": 2.0, "ev": "agent", "phase": "lease", "agent": "a1", "exp": "e", "pid": 0,
             "abind_ms": 12.0},
            {"t": 3.0, "ev": "lease", "phase": "start", "exp": "e", "runner": 1, "pid": 0},
            {"t": 4.0, "ev": "lease", "phase": "end", "exp": "e", "runner": 1, "pid": 0,
             "reason": "agent_lost"},
            {"t": 5.0, "ev": "agent", "phase": "lost", "agent": "a1"}]
    path = tmp_path / "fleet.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    replay = scheduler.replay_fleet_journal(str(path))
    assert replay == jax_scheduler.replay_fleet_journal(str(path))
    assert replay["agents"]["per_agent_leases"] == {"a1": 1}
    assert (replay["agents"]["losses"], replay["agents"]["lost_leases"]) == (1, 1)
    text = render_fleet(status, replay)
    assert text == jax_render_fleet(status, replay)
    assert "agents: 1 joined / 2 slot(s)" in text and "-> exp1" in text


# -------------------------------------------------------------------- CLI


def test_an_agent_needs_a_card_unless_it_runs_on_the_cpu(monkeypatch):
    from maggy_tpu_torch.fleet.__main__ import main

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv(agent.DEVICE_ENV, "")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["agent", "--ticket", "/nonexistent/agent_ticket.json"])
    with pytest.raises(SystemExit, match="--ticket or --fleet-addr"):
        main(["agent", "--device", "cpu"])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "" and agent.trial_device() == "cpu"


def test_cli_subprocess_rebinds_across_experiments(tmp_path):
    """``python -m maggy_tpu_torch.fleet agent --device cpu`` as an OS
    process of its own, on a fleet with no thread runner: it serves both
    experiments, one after the other, and exits on the fleet's AGSTOP."""
    with _fleet("port", tmp_path, runners=0, max_agents=1, liveness=15.0) as fleet:
        proc = soak.spawn_agent_process(os.path.join(fleet.home_dir, "agent_ticket.json"),
                                        log_path=str(tmp_path / "agent.log"))
        try:
            results = [_submit("port", fleet, "scale_train_fn", name, 3, tmp_path, seed)
                       .result(timeout=60) for seed, name in ((1, "cli1"), (2, "cli2"))]
            # The plane's stop answers the agent's next poll with AGSTOP,
            # while the listener still runs.
            fleet.agent_plane.stop()
            proc.wait(timeout=20)
        finally:
            codes = soak.stop_agent_processes([proc])
    assert [r["num_trials"] for r in results] == [3, 3]
    with open(str(tmp_path / "agent.log")) as f:
        log = f.read()
    assert codes == [0], log
    assert "(device cpu)" in log and "2 lease(s) served" in log
    replay = _replay("port", fleet)["agents"]
    assert (replay["joins"], replay["leases"], replay["losses"]) == (1, 2, 0)


def test_an_agent_ending_its_lease_at_the_stop_still_reads_agstop(tmp_path):
    """The plane's stop keeps answering an agent that was inside a lease
    when the stop began past the idle agents' two poll periods: its ADONE
    and its next poll, later than those, read OK and AGSTOP, so the agent
    exits 0 and does not wait out its liveness bound on a dead fleet."""
    with _fleet("port", tmp_path, runners=0, max_agents=1, liveness=5.0) as fleet:
        t = _ticket("port", fleet)
        ch = agent._AgentChannel((t["host"], t["port"]), t["secret"])
        agent_id = _join(ch, "busy")["agent"]
        fleet.agent_plane.record(agent_id).state = "leased"
        stopper = threading.Thread(target=fleet.agent_plane.stop, daemon=True)
        stopper.start()
        time.sleep(2 * fleet.agent_plane.poll_s + 2.0)
        try:
            replies = [ch.call({"type": "ADONE", "agent": agent_id, "error": None})["type"],
                       ch.call({"type": "ALEASE", "agent": agent_id})["type"]]
        except (ConnectionError, OSError) as e:
            replies = [repr(e)]
        finally:
            ch.close()
        stopper.join(timeout=30)
    assert replies == ["OK", "AGSTOP"]
    assert not stopper.is_alive()


@pytest.mark.timeout(120)
def test_agent_kill_soak_journals_check_as_jax(tmp_path):
    """Invariant 11 with agent processes: one SIGKILLed mid-lease. The
    soak's checks hold, and its journals read the same through the JAX
    package's replay and checker."""
    report = soak.run_agent_soak(agents=2, trials=4, base_dir=str(tmp_path))
    assert report["ok"], report["violations"]
    assert report["detail"]["killed"]["agent"] is not None
    replay = scheduler.replay_fleet_journal(report["fleet_journal"])
    assert replay == jax_scheduler.replay_fleet_journal(report["fleet_journal"])
    assert replay["agents"]["lost_leases"] == 1 and replay["agents"]["joins"] == 2
    events = read_events(report["journal"])
    mine = check_invariants(events, stall_flag_bound_s=None)
    assert mine == jax_check_invariants(jax_read_events(report["journal"]),
                                        stall_flag_bound_s=None)
    assert mine["trials"]["finalized"] == 4 and mine["trials"]["requeued"] == 1
