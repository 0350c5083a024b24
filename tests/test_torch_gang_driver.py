"""The gang path through the port's driver, fleet scheduler and agents,
with the assertions of ``tests/test_gang.py:284-543`` and
``tests/test_agent.py:418-578``, each scenario run through both packages:
requeue retention, whole reassembly, held members getting no 1-chip work,
re-planning around a dead chip, a revoked leader's FINAL dropped, release;
fleet gang blocks (aligned, sticky, disjoint, oversized refused, a block's
runner bound to its owner); remote gangs (process ids, one rendezvous a
process, a missing partition raising, a 2-chip gang over two agent
processes on gloo, an in-process gang with no rendezvous)."""

import glob
import json
import os

import pytest

import maggy_tpu.gang as jax_gang
from maggy_tpu import OptimizationConfig as JaxConfig
from maggy_tpu import Searchspace as JaxSearchspace
from maggy_tpu.core.driver.optimization_driver import OptimizationDriver as JaxDriver
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.fleet import scheduler as jax_scheduler
from maggy_tpu.trial import Trial as JaxTrial

import maggy_tpu_torch.gang as port_gang
from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.fleet import agent as port_agent
from maggy_tpu_torch.fleet import scheduler, soak
from maggy_tpu_torch.telemetry import read_events
from maggy_tpu_torch.trial import Trial

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]

PKGS = {
    "port": dict(gang=port_gang, cfg=OptimizationConfig, sp=Searchspace,
                 driver=OptimizationDriver, env=EnvSing, local=LocalEnv, trial=Trial,
                 scheduler=scheduler),
    "jax": dict(gang=jax_gang, cfg=JaxConfig, sp=JaxSearchspace, driver=JaxDriver,
                env=JaxEnvSing, local=JaxLocalEnv, trial=JaxTrial, scheduler=jax_scheduler),
}


@pytest.fixture(autouse=True)
def cpu_gangs(monkeypatch):
    monkeypatch.setenv(port_agent.DEVICE_ENV, "cpu")
    yield
    assert port_gang.live_rank_pids() == []


# ------------------------------------------- driver retention + assembly


@pytest.fixture(params=["port", "jax"])
def gdriver(request, tmp_path):
    p = PKGS[request.param]
    p["env"].set_instance(p["local"](base_dir=str(tmp_path / "exp")))
    config = p["cfg"](
        name="gang_requeue", num_trials=16, optimizer="randomsearch",
        searchspace=p["sp"](lr=("DOUBLE", [0.0, 1.0])), direction="max", num_workers=8,
        seed=2, es_policy="none", pool="thread",
        chips_per_budget={1: p["gang"].GangSpec(1), 4: p["gang"].GangSpec(4, strategy="fsdp")})
    drv = p["driver"](config, "app", 0)
    drv.trial_cls = p["trial"]
    yield drv
    drv.stop()
    p["env"].reset()


def _orphan(drv, budget):
    trial = drv.trial_cls({"lr": 0.5, "budget": budget})
    drv._trial_store[trial.trial_id] = trial
    drv._requeue.append(trial.trial_id)
    return trial


def _register(drv, n=8):
    res = drv.server.reservations
    for p in range(n):
        res.add({"partition_id": p})
    drv.controller.config_buffer = []  # no fresh suggestions
    return res


def _pop(drv, capacity=None):
    # The port's _pop_requeue and the JAX one take the capacity alike.
    return drv._pop_requeue(capacity)


def test_gang_requeue_retained_for_any_single_runner(gdriver):
    trial = _orphan(gdriver, budget=4)
    assert _pop(gdriver, None) is None
    assert _pop(gdriver, 4) is None
    assert trial.trial_id in gdriver._requeue


def test_plain_requeue_still_served_across_gang_entry(gdriver):
    gang = _orphan(gdriver, budget=4)
    small = _orphan(gdriver, budget=1)
    assert _pop(gdriver, None) is small
    assert gang.trial_id in gdriver._requeue


def test_requeued_gang_trial_assembles_whole(gdriver):
    trial = _orphan(gdriver, budget=4)
    res = _register(gdriver)
    gdriver._assign_next(0, None)
    assert res.get_assigned_trial(0) == trial.trial_id
    assert res.gang_members(trial.trial_id) == [0, 1, 2, 3]
    assert trial.trial_id not in gdriver._requeue
    info = trial.info_dict["gang"]
    assert info["chips"] == [0, 1, 2, 3] and info["leader"] == 0
    assert info["strategy"] == "fsdp" and info["mesh"] == {"fsdp": 4}
    assert "rendezvous" not in info


def test_held_member_gets_no_single_chip_work(gdriver):
    trial = _orphan(gdriver, budget=4)
    res = _register(gdriver)
    gdriver._assign_next(0, None)
    small = _orphan(gdriver, budget=1)
    gdriver._assign_next(1, None)
    assert res.get_assigned_trial(1) is None
    assert small.trial_id in gdriver._requeue
    gdriver._assign_next(5, None)
    assert res.get_assigned_trial(5) == small.trial_id
    del trial


def test_dead_busy_chip_inside_block_replans(gdriver):
    trial = _orphan(gdriver, budget=4)
    res = _register(gdriver)
    for p in (2, 5, 6, 7):
        res.assign_trial(p, "busy-{}".format(p))
    gdriver._assign_next(0, None)
    assert gdriver._placer.block_of(trial.trial_id) == [0, 1, 2, 3]
    assert res.get_assigned_trial(0) is None
    res.mark_released(2)
    gdriver._assign_next(4, None)
    assert gdriver._placer.block_of(trial.trial_id) == [4, 5, 6, 7]
    assert res.gang_of(0) is None and res.gang_of(1) is None
    for p in (5, 6, 7):
        res.clear_trial_if(p, "busy-{}".format(p))
        gdriver._assign_next(p, None)
    assert res.get_assigned_trial(4) == trial.trial_id
    assert res.gang_members(trial.trial_id) == [4, 5, 6, 7]


def test_revoked_leaders_inflight_final_dropped(gdriver):
    trial = _orphan(gdriver, budget=4)
    res = _register(gdriver)
    gdriver._assign_next(0, None)
    assert res.get_assigned_trial(0) == trial.trial_id
    gdriver._gang_lost_msg_callback({"trial_id": trial.trial_id, "partition_id": 1})
    assert trial.trial_id in gdriver._requeue
    assert gdriver.result["gang_revocations"] == 1
    gdriver._final_msg_callback({"type": "FINAL", "trial_id": trial.trial_id,
                                 "partition_id": 0, "value": 0.5})
    assert trial.final_metric is None
    assert trial.trial_id in gdriver._trial_store
    assert gdriver.result["num_trials"] == 0
    assert trial.trial_id in gdriver._requeue or \
        len(res.gang_members(trial.trial_id)) == 4


def test_orphaned_revocation_stop_cleared_by_raced_final(gdriver):
    trial = _orphan(gdriver, budget=4)
    res = _register(gdriver)
    gdriver._assign_next(0, None)
    gdriver._gang_lost_msg_callback({"trial_id": trial.trial_id, "partition_id": 1})
    with res.lock:
        assert res._table[0].get("stop_trial") == trial.trial_id
    gdriver._final_msg_callback({"type": "FINAL", "trial_id": trial.trial_id,
                                 "partition_id": 0, "value": 0.5})
    assert not res.pop_stop(0, trial.trial_id)


def test_stale_epoch_final_dropped_after_same_leader_redispatch(gdriver):
    trial = _orphan(gdriver, budget=4)
    res = _register(gdriver)
    gdriver._assign_next(0, None)
    assert res.get_assigned_trial(0) == trial.trial_id
    gdriver._gang_lost_msg_callback({"trial_id": trial.trial_id, "partition_id": 1})
    gdriver._assign_next(0, None)
    assert res.get_assigned_trial(0) == trial.trial_id
    assert trial.run_epoch == 1
    gdriver._final_msg_callback({"type": "FINAL", "trial_id": trial.trial_id,
                                 "partition_id": 0, "value": 0.5, "epoch": 0})
    assert trial.final_metric is None
    assert trial.trial_id in gdriver._trial_store
    assert res.get_assigned_trial(0) == trial.trial_id
    gdriver._final_msg_callback({"type": "FINAL", "trial_id": trial.trial_id,
                                 "partition_id": 0, "value": 0.7, "epoch": 1})
    assert trial.final_metric == 0.7


def test_release_returns_members_to_pool(gdriver):
    trial = _orphan(gdriver, budget=4)
    _register(gdriver)
    res = gdriver.server.reservations
    gdriver._assign_next(0, None)
    assert res.gang_members(trial.trial_id)
    gdriver._release_gang(trial.trial_id, why="finalized")
    assert res.gang_members(trial.trial_id) == []
    assert res.gang_of(1) is None
    assert gdriver._placer.owner_of(0) is None


def test_silent_member_revokes_the_gang_once(gdriver):
    """The loop's member scan: a silent member of an assembled gang queues
    one GANG_LOST (``revoking`` dedupes the rescans)."""
    trial = _orphan(gdriver, budget=4)
    res = _register(gdriver)
    gdriver._assign_next(0, None)
    queued = []
    gdriver.enqueue = queued.append
    res.age_beat(2, 10 * gdriver.server.hb_loss_timeout)
    gdriver._check_gang_members()
    gdriver._check_gang_members()
    assert queued == [{"type": "GANG_LOST", "trial_id": trial.trial_id, "partition_id": 2}]
    assert gdriver.obs_status()["gangs"][trial.trial_id]["revoking"]


def test_oversized_gangs_are_refused_at_driver_init(tmp_path):
    for name, p in PKGS.items():
        p["env"].set_instance(p["local"](base_dir=str(tmp_path / name)))
        try:
            config = p["cfg"](name="big", num_trials=2, searchspace=p["sp"](
                lr=("DOUBLE", [0.0, 1.0])), num_workers=2, pool="thread",
                chips_per_budget={1: 1, 4: 4})
            with pytest.raises(ValueError, match="can never assemble"):
                p["driver"](config, "app", 0)
        finally:
            p["env"].reset()


# ------------------------------------------------------------- fleet block


class _StubDriver:
    experiment_done = False
    exp_dir = None


def _sched(pkg, size):
    return PKGS[pkg]["scheduler"].FleetScheduler(size)


def _entry(pkg, sched, name, **policy):
    entry = sched.submit(name, PKGS[pkg]["scheduler"].FleetPolicy(**policy))
    sched.activate(entry, _StubDriver(), lambda pid: None, slots=16)
    return entry


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_block_is_aligned_sticky_and_disjoint(pkg):
    sched = _sched(pkg, 8)
    a = _entry(pkg, sched, "a")
    b = _entry(pkg, sched, "b")
    block_a = sched.request_gang(a, 4)
    assert block_a == [0, 1, 2, 3]
    assert sched.request_gang(a, 4) == block_a
    assert sched.request_gang(b, 4) == [4, 5, 6, 7]
    sched.release_gang(a)
    with sched._lock:
        assert sched._gang_owner_locked(0) is None
        assert sched._gang_owner_locked(4) is b


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_oversized_gang_rejected_not_clamped(pkg):
    sched = _sched(pkg, 4)
    entry = _entry(pkg, sched, "big")
    with pytest.raises(ValueError, match="never assemble"):
        sched.request_gang(entry, 8)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_block_runner_binds_only_to_owner(pkg):
    sched = _sched(pkg, 4)
    owner = _entry(pkg, sched, "owner")
    other = _entry(pkg, sched, "other")
    sched.request_gang(owner, 2)
    e0, _ = sched.next_binding(0, timeout=1)
    e1, _ = sched.next_binding(1, timeout=1)
    assert e0 is owner and e1 is owner
    e2, _ = sched.next_binding(2, timeout=1)
    assert e2 is other


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_failed_tenants_block_is_parked_and_reclaimed(pkg):
    """A failed tenant's block is parked for its restart (matched by base
    name) and no other tenant's gang takes that window meanwhile."""
    sched = PKGS[pkg]["scheduler"].FleetScheduler(8, tenant_grace_s=60.0)
    first = _entry(pkg, sched, "t-1")
    block = sched.request_gang(first, 4)
    sched.finish(first, "failed")
    other = _entry(pkg, sched, "other")
    assert not set(sched.request_gang(other, 4)) & set(block)
    again = _entry(pkg, sched, "t-2")
    assert sched.request_gang(again, 4) == block


# ---------------------------------------------------- remote-gang rendezvous


REMOTE_INFO = {"chips": [0, 1], "members": [0, 1], "leader": 0, "mesh": {"data": 2},
               "strategy": "dp", "rendezvous": {"coordinator": "127.0.0.1:1234",
                                                "num_processes": 2,
                                                "process_ids": {"0": 0, "1": 1}}}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_gang_context_process_ids(pkg):
    G = PKGS[pkg]["gang"].GangContext
    ctx = G(dict(REMOTE_INFO, partition=1))
    assert ctx.process_id == 1
    assert ctx.to_dict()["rendezvous"]["num_processes"] == 2
    local = G({"chips": [0], "members": [0], "leader": 0, "mesh": {"data": 1},
               "strategy": "dp"})
    assert local.process_id is None
    assert local.ensure_rendezvous() is False


def test_ensure_rendezvous_initializes_once(monkeypatch):
    calls = []
    monkeypatch.setattr(port_gang, "_WORLD", None)
    monkeypatch.setattr(port_gang, "_COORD_STORE", object())
    monkeypatch.setattr(port_gang, "_join_world", lambda store, rank, world, device, t: (
        calls.append((rank, world, str(device))) or {"rank": rank, "world": world}))
    ctx = port_gang.GangContext(dict(REMOTE_INFO, partition=0))
    assert ctx.ensure_rendezvous() is True
    assert ctx.ensure_rendezvous() is True  # latched, once a process
    assert port_gang.GangContext(dict(REMOTE_INFO, partition=1)).ensure_rendezvous() is True
    assert calls == [(0, 2, "cpu")]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_ensure_rendezvous_without_partition_raises(pkg, monkeypatch):
    mod = PKGS[pkg]["gang"]
    monkeypatch.setattr(mod, "_RENDEZVOUS_DONE" if pkg == "jax" else "_WORLD",
                        False if pkg == "jax" else None)
    ctx = mod.GangContext(dict(REMOTE_INFO))
    with pytest.raises(RuntimeError, match="process id"):
        ctx.ensure_rendezvous()


def test_remote_gang_over_two_agent_processes(tmp_path):
    """A 2-chip gang assembles over two agent processes (``--device cpu``):
    the driver stamps the rendezvous (the leader agent's reserved address
    as coordinator, process ids in chip order), the member runs the program
    too, both join one gloo world, and the trial's one FINAL carries the
    loss of the 2-rank computation."""
    lr_space = Searchspace(lr=("DOUBLE", [0.05, 0.2]),
                           gang=("GANG", [port_gang.GangSpec(2)]))
    cfg = OptimizationConfig(
        name="rgang", num_trials=1, optimizer="randomsearch", searchspace=lr_space,
        direction="max", num_workers=2, hb_interval=0.05, hb_loss_timeout=20.0, seed=3,
        es_policy="none", experiment_dir=str(tmp_path / "exp"), health=False)
    with scheduler.Fleet(runners=0, max_agents=2, home_dir=str(tmp_path / "fleet"),
                         agent_liveness_s=20.0) as fleet:
        ticket = os.path.join(fleet.home_dir, "agent_ticket.json")
        procs = [soak.spawn_agent_process(ticket, log_path=str(tmp_path / "a{}.log".format(i)))
                 for i in range(2)]
        try:
            result = experiment.lagom_submit(port_gang.gang_train_fn, cfg, fleet=fleet,
                                             block=False, name="rgang").result(timeout=90)
            with fleet.agent_plane._lock:
                coords = {a.coord_addr for a in fleet.agent_plane._agents.values()}
            fleet.agent_plane.stop()
            for p in procs:
                p.wait(timeout=20)
        finally:
            codes = soak.stop_agent_processes(procs)
    logs = "".join(open(str(tmp_path / "a{}.log".format(i))).read() for i in range(2))
    assert codes == [0, 0], logs
    assert result["num_trials"] == 1
    (trial_path,) = glob.glob(str(tmp_path / "exp" / "*" / "*" / "trial.json"))
    trial = json.load(open(trial_path))
    rendezvous = trial["info_dict"]["gang"]["rendezvous"]
    assert rendezvous["num_processes"] == 2 and rendezvous["coordinator"] in coords
    assert sorted(rendezvous["process_ids"].values()) == [0, 1]
    ref = port_gang.reference_gang_loss(trial["params"]["lr"], {"chips": 2})
    assert abs(trial["final_metric"] - ref) <= 1e-5
    (journal,) = glob.glob(str(tmp_path / "exp" / "*" / "telemetry.jsonl"))
    finals = [e for e in read_events(journal)
              if e.get("ev") == "trial" and e.get("phase") == "finalized"]
    assert len(finals) == 1


def test_in_process_gang_has_no_rendezvous(tmp_path):
    """A gang of thread runners (no host_port in any REG) gets no
    rendezvous block: its leader runs the ranks in processes of its own."""
    cfg = OptimizationConfig(
        name="lgang", num_trials=1, optimizer="randomsearch",
        searchspace=Searchspace(lr=("DOUBLE", [0.05, 0.2]),
                                gang=("GANG", [port_gang.GangSpec(2)])),
        direction="max", num_workers=2, hb_interval=0.05, hb_loss_timeout=5.0, seed=3,
        es_policy="none", experiment_dir=str(tmp_path), health=False, pool="thread")
    result = experiment.lagom(port_gang.gang_train_fn, cfg)
    assert result["num_trials"] == 1
    trial_files = glob.glob(str(tmp_path / "*" / "*" / "trial.json"))
    assert trial_files
    for tf in trial_files:
        gang = (json.load(open(tf)).get("info_dict") or {}).get("gang") or {}
        assert gang and "rendezvous" not in gang
