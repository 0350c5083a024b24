"""Experiment resume and crash-only driver recovery in the port, held
against maggy_tpu on the CPU: the journal replay, a synthetic interrupted
run resumed through each package's lagom, the recovering driver's store,
reservations and secret, the re-registration (BLACK) path, the FINAL
path's barrier and cross-incarnation FINALs, run-dir adoption and the
resume look-up, every controller's and Hyperband's restore in lockstep,
the seeded-ASHA re-issue both packages share, the validation errors, and a
Hyperband sweep killed with SIGKILL and resumed in a new process."""

import copy
import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import maggy_tpu.telemetry as jax_telemetry
import maggy_tpu_torch.telemetry as port_telemetry
from maggy_tpu import experiment as jax_experiment
from maggy_tpu import util as jax_util
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.core.driver import recovery as jax_recovery
from maggy_tpu.core.driver.optimization_driver import OptimizationDriver as JaxDriver
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.optimizers import PBT as JaxPBT
from maggy_tpu.optimizers import Asha as JaxAsha
from maggy_tpu.optimizers import GridSearch as JaxGridSearch
from maggy_tpu.optimizers import RandomSearch as JaxRandomSearch
from maggy_tpu.optimizers import SingleRun as JaxSingleRun
from maggy_tpu.optimizers.bayes import GP as JaxGP
from maggy_tpu.optimizers.bayes import TPE as JaxTPE
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu.trial import Trial as JaxTrial

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment, util
from maggy_tpu_torch.core.driver import recovery
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.exceptions import RunAdoptionError
from maggy_tpu_torch.optimizers import PBT, Asha, GridSearch, RandomSearch, SingleRun
from maggy_tpu_torch.optimizers.bayes import GP, TPE
from maggy_tpu_torch.train.checkpoint import (TrialCheckpointer, fork_checkpoint,
                                              latest_checkpoint_step)
from maggy_tpu_torch.trial import Trial

# Each test bounded; the sweeps and the subprocess set their own bounds.
pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACE = dict(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64]))


@pytest.fixture(autouse=True)
def _fresh_envs():
    EnvSing.reset()
    JaxEnvSing.reset()
    yield
    EnvSing.reset()
    JaxEnvSing.reset()


def _tid(params):
    return Trial._compute_id(params, "optimization")


def _seeded_schedule(seed=5, n=4):
    """The configs a seeded RandomSearch presamples: the crashed
    incarnation's trials come from the schedule the resumed one draws."""
    return Searchspace(**SPACE).get_random_parameter_values(n, rng=np.random.default_rng(seed))


def _interrupted_run_dir(base, trial_cls, app_id="recapp", name="rec"):
    """What a crashed driver leaves on disk (``tests/test_failover.py:
    168-221``): a journal with one finalized trial (t2, artifact present)
    and one in flight (t1, running on partition 0 at epoch 0), two
    registered partitions, experiment.json, the dead incarnation's epoch
    marker and its driver_state.json."""
    run_dir = os.path.join(base, "{}_0".format(app_id))
    p1, p2 = _seeded_schedule()[:2]
    t1, t2 = _tid(p1), _tid(p2)
    t0 = time.time() - 60
    events = [
        {"t": t0, "ev": "driver_epoch", "epoch": 1},
        {"t": t0, "ev": "experiment", "phase": "start", "name": name},
        {"t": t0 + 0.1, "ev": "runner", "phase": "registered", "partition": 0},
        {"t": t0 + 0.1, "ev": "runner", "phase": "registered", "partition": 1},
        {"t": t0 + 0.2, "ev": "trial", "trial": t1, "span": "span-t1", "phase": "queued",
         "params": p1, "trial_type": "optimization", "info": {"sample_type": "random"}},
        {"t": t0 + 0.3, "ev": "trial", "trial": t1, "span": "span-t1", "phase": "assigned",
         "partition": 0},
        {"t": t0 + 0.4, "ev": "trial", "trial": t1, "span": "span-t1", "phase": "running",
         "partition": 0, "epoch": 0},
        {"t": t0 + 0.2, "ev": "trial", "trial": t2, "span": "span-t2", "phase": "queued",
         "params": p2, "trial_type": "optimization", "info": {"sample_type": "random"}},
        {"t": t0 + 0.5, "ev": "trial", "trial": t2, "span": "span-t2", "phase": "running",
         "partition": 1, "epoch": 0},
        {"t": t0 + 2.0, "ev": "trial", "trial": t2, "span": "span-t2", "phase": "finalized",
         "partition": 1},
    ]
    os.makedirs(os.path.join(run_dir, t2))
    with open(os.path.join(run_dir, "telemetry.jsonl"), "w") as f:
        f.writelines(json.dumps(ev) + "\n" for ev in events)
    done = trial_cls(p2)
    done.status = trial_cls.FINALIZED
    done.final_metric = 0.9
    with open(os.path.join(run_dir, t2, "trial.json"), "w") as f:
        f.write(done.to_json())
    for marker, body in ((".run_claim", "{}"), (".driver_epoch.1", "{}"),
                         ("experiment.json", json.dumps({"name": name, "state": "RUNNING"})),
                         ("driver_state.json", json.dumps({
                             "secret": "aa" * 16, "host": "127.0.0.1", "port": 0,
                             "driver_epoch": 1}))):
        with open(os.path.join(run_dir, marker), "w") as f:
            f.write(body)
    return run_dir, {"t1": t1, "t2": t2, "p1": p1, "p2": p2}


def _rec_config(config_cls, space_cls, base, **kw):
    return config_cls(**{**dict(
        name="rec", num_trials=4, optimizer="randomsearch", searchspace=space_cls(**SPACE),
        direction="max", num_workers=2, seed=5, es_policy="none", experiment_dir=base,
        resume=True, hb_loss_timeout=30.0), **kw})


def _recovering_drivers(tmp_path, **kw):
    """A resuming driver of each package, constructed (not run) over the
    same synthetic interrupted run: (port, jax, ids)."""
    base_p, base_j = str(tmp_path / "port"), str(tmp_path / "jax")
    _, ids = _interrupted_run_dir(base_p, Trial)
    _interrupted_run_dir(base_j, JaxTrial)
    port = OptimizationDriver(_rec_config(OptimizationConfig, Searchspace, base_p, **kw),
                              "recapp", 0)
    jax = JaxDriver(_rec_config(JaxConfig, JaxSearchspace, base_j, health=False, **kw),
                    "recapp", 0)
    return port, jax, ids


def _drain(driver):
    msgs = []
    while not driver._message_q.empty():
        msgs.append(driver._message_q.get_nowait())
    return msgs


def _phases(driver, trial_id):
    return [(e["phase"], e.get("reason") or e.get("requeue"), e.get("partition"))
            for e in driver.telemetry.events()
            if e.get("ev") == "trial" and e.get("trial") == trial_id]


# ------------------------------------------------------------ journal replay


def _two_incarnation_events():
    p1, p2, p3, p4 = ({"lr": lr, "units": u} for lr, u in
                      ((0.1, 16), (0.15, 48), (0.05, 8), (0.12, 32)))
    t1, t2, t3, t4 = (_tid(p) for p in (p1, p2, p3, p4))

    def trial(t, tid, phase, **kw):
        return {"t": t, "ev": "trial", "trial": tid, "span": "s-" + tid[:4],
                "phase": phase, **kw}

    return [
        {"t": 1.0, "ev": "driver_epoch", "epoch": 1},
        {"t": 1.1, "ev": "runner", "phase": "registered", "partition": 0, "capacity": 4},
        {"t": 1.1, "ev": "runner", "phase": "registered", "partition": 1},
        trial(1.2, t1, "queued", params=p1, trial_type="optimization",
              info={"sample_type": "random", "rung": 0}),
        trial(1.3, t1, "assigned", partition=0),
        trial(1.4, t1, "running", partition=0, epoch=0),
        trial(1.2, t2, "queued", params=p2, trial_type="optimization", info={}),
        trial(1.5, t2, "running", partition=1, epoch=0),
        trial(2.0, t2, "finalized", partition=1),
        trial(2.1, t3, "queued", params=p3, info={"parent": t2,
                                                  "forked_from": {"trial": t2, "step": 3},
                                                  "resume_step": 3}),
        trial(2.2, t3, "assigned", partition=1),
        trial(2.3, t3, "running", partition=1, epoch=0),
        trial(2.4, t3, "preempted", partition=1, step=5),
        trial(2.5, t3, "requeued", partition=1, reason="preempted"),
        {"t": 3.0, "ev": "driver_epoch", "epoch": 2},
        {"t": 3.1, "ev": "experiment", "phase": "recovered", "inflight": 2},
        {"t": 3.2, "ev": "runner", "phase": "adopted", "partition": 0},
        {"t": 3.2, "ev": "runner", "phase": "adopted", "partition": 2},
        trial(3.3, t1, "lost", partition=0),
        trial(3.4, t1, "requeued", partition=0, reason="heartbeat_loss"),
        trial(3.5, t3, "assigned", partition=2),
        trial(3.6, t3, "running", partition=2, epoch=1),
        trial(3.7, t4, "running", partition=0, epoch=0),  # never queued: not in flight
    ]


def test_replay_recovery_state_matches_jax_field_by_field():
    events = _two_incarnation_events()
    port, jax = (recovery.replay_recovery_state(copy.deepcopy(events)),
                 jax_recovery.replay_recovery_state(copy.deepcopy(events)))
    assert port.partitions == jax.partitions == {0: 4, 1: None, 2: None}
    assert set(port.trials) == set(jax.trials) and len(port.trials) == 4
    for tid, facts in port.trials.items():
        for field in recovery.TrialFacts.__slots__:
            assert getattr(facts, field) == getattr(jax.trials[tid], field), (tid, field)
    assert [f.trial_id for f in port.inflight()] == [f.trial_id for f in jax.inflight()]
    t3 = port.trials[_tid({"lr": 0.05, "units": 8})]
    assert (t3.resume_step, t3.partition, t3.epoch) == (5, 2, 1)
    assert len(port.inflight()) == 2


# ------------------------------------------------- the synthetic resumed run


def _counting_train():
    calls, lock = [], threading.Lock()

    def train(lr, units, reporter=None):
        with lock:
            calls.append(_tid({"lr": lr, "units": units}))
        for step in range(3):
            time.sleep(0.01)
            if reporter is not None:
                reporter.broadcast(lr * (step + 1), step=step)
        return {"metric": 1.0 - (lr - 0.1) ** 2}

    return train, calls


def _resumed_through_lagom(pkg, base):
    """The synthetic interrupted run built under ``base`` for ``pkg`` and
    resumed through its lagom; returns what the test holds it to."""
    run_dir, ids = _interrupted_run_dir(base, Trial if pkg == "port" else JaxTrial,
                                        app_id="e2e", name="rec_e2e")
    train, calls = _counting_train()
    kw = dict(name="rec_e2e", hb_interval=0.05, hb_loss_timeout=1.0)
    if pkg == "port":
        result = experiment.lagom(train, _rec_config(OptimizationConfig, Searchspace, base, **kw))
    else:
        jax_experiment.APP_ID = "e2e"
        result = jax_experiment.lagom(train, _rec_config(JaxConfig, JaxSearchspace, base, **kw))
    events = (port_telemetry if pkg == "port" else jax_telemetry).read_events(
        os.path.join(run_dir, "telemetry.jsonl"))
    return {"num_trials": result["num_trials"], "ids": ids, "calls": calls,
            "finals": [e["trial"] for e in events
                       if e.get("ev") == "trial" and e.get("phase") == "finalized"],
            "epochs": [e["epoch"] for e in events if e.get("ev") == "driver_epoch"],
            "recovered": [e for e in events if e.get("ev") == "experiment"
                          and e.get("phase") == "recovered"]}


@pytest.mark.timeout(90)
def test_interrupted_run_resumes_through_lagom_as_jax(tmp_path, monkeypatch):
    """The synthetic interrupted run, built for each package and resumed
    through its lagom (seeded RandomSearch, 4 trials, 2 threads): 4
    finalized, the completed trial never runs again, the one in flight
    runs once, epochs [1, 2], one recovered event, the same finalized ids.
    The JAX package's sweep runs in a child process with a time limit: its
    driver can strand a trial on a re-registration race (ROADMAP queue 3
    item 9) and never end, and its runner threads would then outlive the
    test and hold the test process open."""
    monkeypatch.setenv("MAGGY_TPU_APP_ID", "e2e")
    out = {"port": _resumed_through_lagom("port", str(tmp_path / "port"))}
    script = ("import json, sys; sys.path[:0] = [{tests!r}, {root!r}]; import jax; "
              "jax.config.update('jax_platforms', 'cpu'); import test_torch_resume as t; "
              "print(json.dumps(t._resumed_through_lagom('jax', {base!r})))").format(
                  tests=os.path.join(ROOT, "tests"), root=ROOT, base=str(tmp_path / "jax"))
    proc = subprocess.run([sys.executable, "-c", script], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=70,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out["jax"] = json.loads(proc.stdout.strip().splitlines()[-1])
    for pkg, seen in out.items():
        ids = seen["ids"]
        assert seen["num_trials"] == 4, pkg
        assert len(seen["finals"]) == len(set(seen["finals"])) == 4, pkg
        assert ids["t2"] not in seen["calls"] and seen["calls"].count(ids["t1"]) == 1, pkg
        assert seen["epochs"] == [1, 2], pkg
        assert len(seen["recovered"]) == 1 and seen["recovered"][0]["inflight"] == 1, pkg
    assert set(out["port"]["finals"]) == set(out["jax"]["finals"])


# ------------------------------------------------------- the recovering driver


def test_recovering_driver_restores_store_reservations_and_secret_as_jax(tmp_path):
    # Prefetch off: each driver's suggester pops the presampled buffer when
    # it prefetches, so with it on the comparison of the two buffers raced
    # the two suggester threads (and failed under load).
    port, jax, ids = _recovering_drivers(tmp_path, prefetch=False)
    try:
        for drv in (port, jax):
            assert [t.trial_id for t in drv._final_store] == [ids["t2"]]
            trial = drv._trial_store[ids["t1"]]
            assert (trial.run_epoch, trial.params, trial.info_dict.get("span")) == (
                0, ids["p1"], "span-t1")
            rec = drv.server.reservations.get(0)
            assert rec["trial_id"] == ids["t1"] and rec["recovered"] is True
            assert drv.server.reservations.get(1)["trial_id"] is None
            assert [(m["type"], m["partition_id"]) for m in _drain(drv)] == [("IDLE", 1)]
            assert drv.driver_epoch == 2
            assert drv.secret == drv.server.secret_hex == "aa" * 16
            evs = drv.telemetry.events()
            assert [e["epoch"] for e in evs if e.get("ev") == "driver_epoch"] == [1, 2]
            (rec_ev,) = [e for e in evs if e.get("ev") == "experiment"
                         and e.get("phase") == "recovered"]
            assert {k: rec_ev[k] for k in ("inflight", "held_partitions", "backlogged",
                                          "recovered_partitions", "forks", "finalized")} == {
                "inflight": 1, "held_partitions": 1, "backlogged": 0,
                "recovered_partitions": 2, "forks": 0, "finalized": 1}
            assert not any(_tid(c) in (ids["t1"], ids["t2"])
                           for c in drv.controller.config_buffer)
        assert port.controller.config_buffer == jax.controller.config_buffer
    finally:
        port.stop()
        jax.stop()


@pytest.mark.parametrize("order", ["nudge_first", "reg_first"])
def test_reregistration_takes_the_black_path_as_jax(tmp_path, order):
    """The resumed driver's runners register as partitions 0 and 1 again:
    0 holds the trial in flight at the crash, 1 got an IDLE nudge. Whether
    the nudge is drained before the REGs or after them, the held trial is
    requeued with reason ``blacklist`` and handed back to partition 0, with
    the same phase sequence in both packages. The port leaves no trial of
    the store without a partition in either order; the JAX driver, given
    the REG first, assigns the nudge's suggestion over the one the REG got
    and strands it (its lagom drains the nudges before any runner starts,
    so its sweeps do not meet this order)."""
    port, jax, ids = _recovering_drivers(tmp_path)
    try:
        for drv in (port, jax):
            (nudge,) = _drain(drv)
            if order == "nudge_first":
                drv.message_callbacks["IDLE"](nudge)
            for pid in (0, 1):
                drv.server._reg({"type": "REG", "partition_id": pid})
                for msg in _drain(drv):
                    drv.message_callbacks[msg["type"]](msg)
            if order == "reg_first":
                drv.message_callbacks["IDLE"](nudge)
            res = drv.server.reservations
            assert res.get_assigned_trial(0) == ids["t1"]
            held = {res.get_assigned_trial(0), res.get_assigned_trial(1)}
            with drv._store_lock:
                stranded = set(drv._trial_store) - held - set(drv._requeue) - {
                    t.trial_id for t in drv._prefetched}
            assert len(stranded) == (1 if drv is jax and order == "reg_first" else 0)
            assert drv._trial_store[ids["t1"]].run_epoch == 1
        assert _phases(port, ids["t1"]) == _phases(jax, ids["t1"])
        assert _phases(port, ids["t1"])[-2:] == [("requeued", "blacklist", 0),
                                                  ("assigned", "blacklist", 0)]
    finally:
        port.stop()
        jax.stop()


def test_resume_journals_the_finalized_edge_a_crash_lost(tmp_path):
    """A FINAL writes trial.json before the journal's barrier flushes its
    finalized edge; a crash in between leaves a finished trial that the
    journal never closes (the Hyperband resume sweep below was killed in
    that window under load, and counted one finalized edge fewer than
    result.json's trials). The resume journals the lost edge once, on the
    trial's span, at the time the trial finished; the trial in flight is
    still recovered."""
    base = str(tmp_path / "port")
    run_dir, ids = _interrupted_run_dir(base, Trial)
    journal = os.path.join(run_dir, "telemetry.jsonl")
    with open(journal) as f:
        events = [json.loads(line) for line in f]
    assert events[-1]["phase"] == "finalized" and events[-1]["trial"] == ids["t2"]
    with open(journal, "w") as f:
        f.writelines(json.dumps(ev) + "\n" for ev in events[:-1])
    artifact = os.path.join(run_dir, ids["t2"], "trial.json")
    done = Trial.from_json(open(artifact).read())
    done.start, done.duration = events[-1]["t"] - 1.5, 1.5
    with open(artifact, "w") as f:
        f.write(done.to_json())
    port = OptimizationDriver(_rec_config(OptimizationConfig, Searchspace, base, prefetch=False),
                              "recapp", 0)
    try:
        finals = [e for e in port.telemetry.events() if e.get("ev") == "trial"
                  and e.get("phase") == "finalized"]
        assert [(e["trial"], e["span"], e["partition"], e["t"]) for e in finals] == [
            (ids["t2"], "span-t2", 1, events[-1]["t"])]
        assert set(port._trial_store) == {ids["t1"]}
        assert [t.trial_id for t in port._final_store] == [ids["t2"]]
    finally:
        port.stop()


def test_black_for_a_trial_finalized_meanwhile_gives_the_slot_new_work(tmp_path):
    """A BLACK naming a trial that left the store (it finalized before the
    worker drained the BLACK): the slot's dead id is cleared and it gets a
    fresh assignment, so its runner never GET-polls a finalized id."""
    port, jax, ids = _recovering_drivers(tmp_path)
    jax.stop()
    try:
        _drain(port)
        with port._store_lock:
            port._trial_store.pop(ids["t1"])
        port.server._reg({"type": "REG", "partition_id": 0})
        (black,) = _drain(port)
        assert black["type"] == "BLACK" and black["trial_id"] == ids["t1"]
        port.message_callbacks["BLACK"](black)
        got = port.server.reservations.get_assigned_trial(0)
        assert got not in (None, ids["t1"]) and got in port._trial_store
    finally:
        port.stop()


def test_reregistered_slot_serves_its_trial_only_after_the_black_path(tmp_path):
    """A runner that registers on a slot holding a trial and GET-polls
    before the driver's worker drained the BLACK gets no trial: served then,
    it would run under the dead run's epoch, and its FINAL, dropped as stale
    after the requeue, would clear the re-assignment and strand the trial
    (the Hyperband resume sweep below hung so under load). The trial stays
    on the record meanwhile, and after the BLACK path the GET serves it at
    the new epoch."""
    port, jax, ids = _recovering_drivers(tmp_path)
    jax.stop()
    try:
        _drain(port)
        port.server._reg({"type": "REG", "partition_id": 0})
        assert port.server._get({"type": "GET", "partition_id": 0}) == {
            "type": "OK", "trial_id": None}
        assert port.server.reservations.get_assigned_trial(0) == ids["t1"]
        (black,) = _drain(port)
        port.message_callbacks["BLACK"](black)
        reply = port.server._get({"type": "GET", "partition_id": 0})
        assert (reply["type"], reply["trial_id"], reply["info"]["epoch"]) == (
            "TRIAL", ids["t1"], 1)
    finally:
        port.stop()


# ------------------------------------------ cross-incarnation FINALs, barrier


def _final(tid, value, epoch=0, pid=0):
    return {"type": "FINAL", "trial_id": tid, "partition_id": pid, "value": value,
            "logs": [], "epoch": epoch}


def test_retried_final_is_accepted_exactly_once(tmp_path):
    """A pre-crash runner's retried FINAL re-binds it (``adopted``, once)
    and is accepted once; the retry of the retry is swallowed
    (``tests/test_failover.py:298-330``)."""
    port, jax, ids = _recovering_drivers(tmp_path)
    jax.stop()
    try:
        port.server._final(_final(ids["t1"], 0.5))
        port.server._final(_final(ids["t1"], 0.5))
        assert [t.final_metric for t in port._final_store if t.trial_id == ids["t1"]] == [0.5]
        evs = port.telemetry.events()
        assert [e["partition"] for e in evs if e.get("ev") == "runner"
                and e.get("phase") == "adopted"] == [0]
        assert sum(1 for e in evs if e.get("trial") == ids["t1"]
                   and e.get("phase") == "finalized") == 1
    finally:
        port.stop()


def test_stale_epoch_final_is_dropped(tmp_path):
    """The dead incarnation's FINAL that lands after the rebuilt trial was
    requeued (its epoch bumped) is dropped (``tests/test_failover.py:
    332-352``)."""
    port, jax, ids = _recovering_drivers(tmp_path)
    jax.stop()
    try:
        trial = port._trial_store[ids["t1"]]
        trial.reset_run_state()
        port.server.reservations.clear_trial_if(0, ids["t1"])
        with port._store_lock:
            port._requeue.append(ids["t1"])
        port.server._final(_final(ids["t1"], 0.9))
        assert not [t for t in port._final_store if t.trial_id == ids["t1"]]
        assert trial.final_metric is None
    finally:
        port.stop()


def test_final_reply_is_preceded_by_a_durable_journal(tmp_path):
    """After the FINAL handler returns, the finalized edge is on disk
    although the flusher's cadence never fired
    (``tests/test_failover.py:129``)."""
    port, jax, ids = _recovering_drivers(tmp_path)
    jax.stop()
    try:
        port.telemetry.journal._flush_interval_s = 3600.0
        port.server._final(_final(ids["t1"], 0.5))
        on_disk = port_telemetry.read_events(port.telemetry.journal.path)
        assert any(e.get("phase") == "finalized" and e.get("trial") == ids["t1"]
                   for e in on_disk)
    finally:
        port.stop()


def test_journal_barrier_persists_the_buffered_suffix(tmp_path):
    from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv

    telem = port_telemetry.Telemetry(env=LocalEnv(), journal_path=str(tmp_path / "t.jsonl"),
                                     flush_interval_s=3600.0, fsync=True)
    telem.event("experiment", phase="finalized")
    assert not os.path.exists(tmp_path / "t.jsonl")
    telem.barrier()
    assert port_telemetry.read_events(str(tmp_path / "t.jsonl"))[-1]["phase"] == "finalized"
    telem.close()


# ------------------------------------------------- run adoption and look-up


def test_racing_adopters_exactly_one_wins_each_epoch(tmp_path):
    """Two restarting drivers race for one run dir: never two claims of the
    same epoch, never zero winners (``tests/test_failover.py:65``)."""
    from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv

    env, run_dir = LocalEnv(), str(tmp_path / "app_0")
    os.makedirs(run_dir)
    assert util.claim_driver_epoch(run_dir, env) == 1
    for _ in range(5):
        barrier, results = threading.Barrier(2), []

        def adopt():
            barrier.wait()
            try:
                results.append(("ok", util.claim_driver_epoch(run_dir, env)))
            except RunAdoptionError as e:
                results.append(("lost", str(e)))

        threads = [threading.Thread(target=adopt) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        epochs = [r[1] for r in results if r[0] == "ok"]
        assert epochs and len(set(epochs)) == len(epochs)
        assert all("adopted by another driver" in r[1] for r in results if r[0] == "lost")
    claimed = sorted(int(n.rsplit(".", 1)[1]) for n in os.listdir(run_dir)
                     if n.startswith(util.DRIVER_EPOCH_PREFIX))
    assert claimed == list(range(1, len(claimed) + 1)) and len(claimed) >= 6


def test_find_resume_run_id_by_name_never_adopting_torn_metadata(tmp_path):
    """One app id may host several experiments: resume re-enters the most
    recent run of this name; torn metadata is skipped
    (``tests/test_failover.py:626-650``)."""
    from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv

    env, base = LocalEnv(), str(tmp_path / "experiments")
    for i, meta in enumerate(['{"name": "a"}', '{"name": "b"}', '{"name": "a"}',
                              '{"name": "b']):
        os.makedirs(os.path.join(base, "app_{}".format(i)))
        with open(os.path.join(base, "app_{}".format(i), "experiment.json"), "w") as f:
            f.write(meta)
    for name, want in (("a", 2), ("b", 1)):
        assert util.find_resume_run_id(base, "app", name, env) == want \
            == jax_util.find_resume_run_id(base, "app", name=name, env=None)
    with pytest.raises(ValueError, match="named 'c'"):
        util.find_resume_run_id(base, "app", "c", env)
    assert util.next_run_id(base, "app", env) == 4
    assert util.claim_run_id(base, "app", env) == 4


def test_a_still_bound_pre_crash_port_refuses_adoption(tmp_path):
    """driver_state.json names a port another process still holds: the
    resume refuses with RunAdoptionError instead of running a second
    control plane against the run dir."""
    import socket

    base = str(tmp_path / "port")
    run_dir, _ = _interrupted_run_dir(base, Trial)
    squat = socket.socket()
    squat.bind(("127.0.0.1", 0))
    squat.listen(1)
    try:
        with open(os.path.join(run_dir, "driver_state.json"), "w") as f:
            json.dump({"secret": "aa" * 16, "port": squat.getsockname()[1]}, f)
        drv = OptimizationDriver(_rec_config(OptimizationConfig, Searchspace, base),
                                 "recapp", 0)
        with pytest.raises(RunAdoptionError, match="still bound"):
            drv.run_experiment(lambda lr, units: 0.0)
    finally:
        squat.close()
    with open(os.path.join(run_dir, "experiment.json")) as f:
        assert json.load(f)["state"] == "FAILED"


# ------------------------------------------- controller restores in lockstep


def _metric(p):
    return 1.0 - (p.get("lr", 0.1) - 0.1) ** 2 - 0.001 * p.get("units", 0) \
        + 0.01 * p.get("budget", 1) + 0.001 * p.get("generation", 0)


GRID = dict(lr=("DISCRETE", [0.05, 0.1, 0.15]), units=("DISCRETE", [8, 16, 32]))

CONTROLLERS = {
    "randomsearch": (lambda m: m.RandomSearch(seed=5), SPACE, 8),
    "gridsearch": (lambda m: m.GridSearch(), GRID, 9),
    "singlerun": (lambda m: m.SingleRun(), {}, 6),
    "tpe": (lambda m: m.TPE(num_warmup_trials=3, seed=2), SPACE, 12),
    "gp": (lambda m: m.GP(num_warmup_trials=3, seed=2), SPACE, 12),
    "asha": (lambda m: m.Asha(3, 1, 9, seed=0), SPACE, 9),
    "pbt": (lambda m: m.PBT(population=3, generations=3, seed=0), SPACE, 9),
    "hyperband": (lambda m: m.RandomSearch(seed=7, pruner="hyperband", pruner_kwargs=dict(
        min_budget=1, max_budget=9, eta=3)), SPACE, None),
}


class _PortMods:
    RandomSearch, GridSearch, SingleRun, TPE, GP, Asha, PBT = (
        RandomSearch, GridSearch, SingleRun, TPE, GP, Asha, PBT)


class _JaxMods:
    RandomSearch, GridSearch, SingleRun, TPE, GP, Asha, PBT = (
        JaxRandomSearch, JaxGridSearch, JaxSingleRun, JaxTPE, JaxGP, JaxAsha, JaxPBT)


def _wire(opt, space, n):
    opt.init_pruner()
    if n is None:
        n = opt.pruner.num_trials()
    if hasattr(opt, "schedule_size"):
        n = opt.schedule_size()
    opt.searchspace, opt.num_trials, opt.direction = space, n, "max"
    opt.trial_store, opt.final_store = {}, []
    opt._initialize()
    return opt


def _precrash(opt, n_final, workers=2):
    """Drive a controller as the driver does (up to ``workers`` in flight,
    the oldest finalizing first) until ``n_final`` trials finalized: the
    finalized trials in order and the ones in flight."""
    in_flight = []
    while len(opt.final_store) < n_final:
        while len(in_flight) < workers:
            t = opt.suggest()
            if t in (None, "IDLE"):
                break
            opt.trial_store[t.trial_id] = t
            in_flight.append(t)
        t = in_flight.pop(0)
        t.status, t.final_metric = t.FINALIZED, _metric(t.params)
        opt.trial_store.pop(t.trial_id)
        opt.final_store.append(t)
        opt.report(t)
    return list(opt.final_store), in_flight


def _ledgers(opt):
    out = {"schedule_version": opt.schedule_version}
    for attr in ("config_buffer", "_pending", "warmup_buffer", "rungs", "promoted",
                 "_exhausted"):
        if hasattr(opt, attr):
            value = getattr(opt, attr)
            out[attr] = [getattr(v, "trial_id", v) for v in value] \
                if isinstance(value, list) else value
    if opt.pruner is not None:
        out["pruner"] = json.dumps(opt.pruner.state_dict(), sort_keys=True)
    return out


def _next_five(opt):
    out = []
    for _ in range(5):
        t = opt.suggest()
        if t in (None, "IDLE"):
            out.append(t)
            continue
        opt.trial_store[t.trial_id] = t
        out.append((t.trial_id, t.info_dict["sample_type"], dict(t.params)))
    return out


@pytest.mark.parametrize("kind", sorted(CONTROLLERS))
def test_restore_from_finals_in_lockstep_with_jax(kind):
    """The same finalized and in-flight trials, restored into a fresh
    controller of each package (and, with a pruner, its bracket state):
    the same ledgers and the same next five suggestions. GP's proposals
    agree within 1e-4 in the unit cube (its regressor is the port's own)."""
    make, space, n = CONTROLLERS[kind]
    pre = _wire(make(_PortMods), Searchspace(**space), n)
    finalized, inflight = _precrash(pre, 5)
    assert inflight or kind == "singlerun"
    state = pre.pruner.state_dict() if pre.pruner is not None else None
    sides = []
    for mods, space_cls, trial_cls in ((_PortMods, Searchspace, Trial),
                                       (_JaxMods, JaxSearchspace, JaxTrial)):
        opt = _wire(make(mods), space_cls(**space), n)
        fin = [trial_cls.from_json(t.to_json()) for t in finalized]
        live = [trial_cls.from_json(t.to_json()) for t in inflight]
        opt.final_store.extend(fin)
        opt.trial_store.update({t.trial_id: t for t in live})
        opt.restore_from_finals(fin, inflight=live)
        if state is not None:
            opt.pruner.load_state_dict(json.loads(json.dumps(state)))
            opt.pruner.restore({t.trial_id for t in fin})
        sides.append((_ledgers(opt), _next_five(opt)))
    (ledgers, nxt), (jledgers, jnxt) = sides
    assert ledgers == jledgers
    if kind == "gp":
        assert [s[1] for s in nxt] == [s[1] for s in jnxt]
        sp = Searchspace(**space)
        np.testing.assert_allclose(sp.transform_batch([s[2] for s in nxt]),
                                   sp.transform_batch([s[2] for s in jnxt]), rtol=0, atol=1e-4)
    else:
        assert nxt == jnxt
    done = {t.trial_id for t in finalized} | {t.trial_id for t in inflight}
    if kind in ("randomsearch", "gridsearch", "singlerun", "pbt"):
        assert not done & {s[0] for s in nxt if s not in (None, "IDLE")}


def test_seeded_asha_resume_reissues_a_finalized_config_as_jax():
    """The reference defect both packages keep (ROADMAP queue 3 item 8): a
    seeded ASHA restored from three finalized rung-0 trials does not
    advance its rng, so after the promotion it suggests again the first
    config the crashed incarnation drew, which had finalized."""
    for mods, space_cls, trial_cls in ((_PortMods, Searchspace, Trial),
                                       (_JaxMods, JaxSearchspace, JaxTrial)):
        pre = _wire(mods.Asha(3, 1, 9, seed=0), space_cls(**SPACE), 9)
        finalized, inflight = _precrash(pre, 3, workers=1)
        assert not inflight
        opt = _wire(mods.Asha(3, 1, 9, seed=0), space_cls(**SPACE), 9)
        fin = [trial_cls.from_json(t.to_json()) for t in finalized]
        opt.final_store.extend(fin)
        opt.restore_from_finals(fin)
        promoted, again = opt.suggest(), opt.suggest()
        assert promoted.info_dict["sample_type"] == "promoted"
        assert again.info_dict["sample_type"] == "random"
        assert again.trial_id == fin[0].trial_id
        assert promoted.info_dict["parent"] in {t.trial_id for t in fin}


# ---------------------------------------------------------- validation errors


def _validation_case(case, tmp_path, pkg):
    base = str(tmp_path / pkg / case)
    cfg_cls, space_cls = (OptimizationConfig, Searchspace) if pkg == "port" else (
        JaxConfig, JaxSearchspace)
    mods = _PortMods if pkg == "port" else _JaxMods
    kw = dict(name="val_" + case, num_trials=2, seed=5)
    if case in ("unseeded_randomsearch", "unseeded_tpe", "pruner_without_state"):
        # A previous run of this name, with finalized trials.
        run_dir, _ = _interrupted_run_dir(base, Trial if pkg == "port" else JaxTrial,
                                          app_id="valapp", name="val_" + case)
    if case == "unseeded_randomsearch":
        kw.update(seed=None)
    elif case == "unseeded_tpe":
        kw.update(optimizer=mods.TPE(num_warmup_trials=2))
    elif case == "pruner_without_state":
        kw.update(num_trials=13, optimizer=mods.RandomSearch(
            seed=5, pruner="hyperband", pruner_kwargs={"max_budget": 9}))
    return _rec_config(cfg_cls, space_cls, base, **kw)


@pytest.mark.parametrize("case,match", [
    ("unseeded_randomsearch", "fixed seed"), ("unseeded_tpe", "fixed seed"),
    ("no_prior_run", "no previous run"), ("pruner_without_state", "bracket-state checkpoint")])
def test_resume_refusals_are_the_jax_packages(case, match, tmp_path, monkeypatch):
    monkeypatch.setenv("MAGGY_TPU_APP_ID", "valapp")
    monkeypatch.setattr(jax_experiment, "APP_ID", "valapp")
    messages = []
    for pkg, lagom in (("port", experiment.lagom), ("jax", jax_experiment.lagom)):
        with pytest.raises(ValueError, match=match) as err:
            lagom(lambda lr, units: 0.0, _validation_case(case, tmp_path, pkg))
        messages.append(str(err.value).replace(str(tmp_path / pkg), ""))
    assert messages[0] == messages[1]


# ------------------------------------------- what a hard kill leaves on disk


def test_a_kill_mid_save_or_mid_fork_leaves_no_step_behind(tmp_path):
    """A process killed inside ``torch.save`` leaves ``checkpoints/.tmp.<step>``
    and one killed mid-fork ``<step>.fork_tmp``: neither is a step to
    ``latest_checkpoint_step`` or ``fork_checkpoint``, and a later save and
    fork replace them."""
    import torch
    from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv

    exp = tmp_path / "exp"
    ckpt = TrialCheckpointer(str(exp / "parent"))
    ckpt.save(3, {"w": torch.ones(2)})
    os.makedirs(exp / "parent" / "checkpoints" / ".tmp.7")
    os.makedirs(exp / "child" / "checkpoints" / "3.fork_tmp")
    assert latest_checkpoint_step(str(exp / "parent")) == 3
    assert latest_checkpoint_step(str(exp / "child")) is None
    assert fork_checkpoint(LocalEnv(), str(exp), "parent", str(exp / "child")) == 3
    assert sorted(os.listdir(exp / "child" / "checkpoints")) == ["3"]
    ckpt.save(7, {"w": torch.zeros(2)})
    assert sorted(os.listdir(exp / "parent" / "checkpoints")) == ["7"]


def test_sweep_tmp_files_collects_only_old_orphans(tmp_path):
    from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv

    env = LocalEnv()
    env.dump("{}", str(tmp_path / "t1" / "trial.json"))
    old = tmp_path / "t1" / "trial.json.tmp.11.22"
    new = tmp_path / "t2" / ".pruner_state.json.tmp.11.22"
    for p in (old, new):
        os.makedirs(p.parent, exist_ok=True)
        p.write_text("{")
    os.utime(old, (time.time() - 600, time.time() - 600))
    assert env.sweep_tmp_files(str(tmp_path)) == 1
    assert not old.exists() and new.exists() and (tmp_path / "t1" / "trial.json").exists()


# --------------------------------------------- SIGKILL and resume, in processes

HYPERBAND_CHILD = """
import json, os, sys, time
sys.path.insert(0, {root!r})
from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.optimizers import RandomSearch


def train(lr, units, budget=1, reporter=None):
    marker = os.path.join(os.environ["COUNT_DIR"], "{{:.10f}}_{{}}_{{}}".format(lr, units, budget))
    with open(marker, "a") as f:
        f.write("x")
    time.sleep(float(os.environ["TRIAL_SLEEP"]))
    return {{"metric": 1.0 - (lr - 0.1) ** 2 + 0.01 * budget}}


config = OptimizationConfig(
    name="hb_resume",
    optimizer=RandomSearch(seed=7, pruner="hyperband", pruner_kwargs={{
        "min_budget": 1, "max_budget": 4, "eta": 2, "n_iterations": 2}}),
    searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64])),
    direction="max", num_workers=2, hb_interval=0.05, seed=7, es_policy="none",
    experiment_dir=os.environ["EXP_DIR"], resume=os.environ.get("RESUME") == "1")
result = experiment.lagom(train, config)
print(json.dumps({{"num_trials": result["num_trials"],
                  "foreign": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "maggy_tpu"))}}))
"""


@pytest.mark.timeout(60)
def test_hyperband_sweep_killed_and_resumed_in_a_new_process(tmp_path):
    """A Hyperband(1, 4, 2; two brackets, 11 runs) sweep on two thread
    runners is killed with SIGKILL after 4 trials finalized
    (``tests/test_resume.py:219-296``), then resumed in a new process. The
    resume runs every slot of the schedule, no finalized trial again, and
    again only the trials in flight at the kill (at most one a runner).
    Those are run twice over, as in the JAX package: the rebuilt trial, and
    a replacement for the bracket slot the restore dropped (ROADMAP queue 3
    item 10), so result.json counts 11 plus them. The child imports nothing
    of JAX or maggy_tpu."""
    total, workers = 11, 2
    count_dir, exp_dir = tmp_path / "counts", tmp_path / "exp"
    count_dir.mkdir()
    script = tmp_path / "hb_child.py"
    script.write_text(HYPERBAND_CHILD.format(root=ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(COUNT_DIR=str(count_dir), EXP_DIR=str(exp_dir), TRIAL_SLEEP="0.4",
               MAGGY_TPU_APP_ID="hbapp")
    run_dir = exp_dir / "hbapp_0"
    proc = subprocess.Popen([sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 30
        while len(glob.glob(str(run_dir / "*" / "trial.json"))) < 4:
            assert proc.poll() is None, "sweep ended before the kill:\n" + \
                proc.stdout.read().decode()
            assert time.monotonic() < deadline, "never reached 4 finalized trials"
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
    assert proc.returncode == -signal.SIGKILL
    finalized_before = {os.path.basename(os.path.dirname(p))
                        for p in glob.glob(str(run_dir / "*" / "trial.json"))}
    assert (run_dir / ".pruner_state.json").exists()
    markers_before = {m: os.path.getsize(count_dir / m) for m in os.listdir(count_dir)}

    res = subprocess.run([sys.executable, str(script)], env={**env, "TRIAL_SLEEP": "0",
                                                            "RESUME": "1"},
                         capture_output=True, text=True, timeout=40)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["foreign"] == []
    events = port_telemetry.read_events(str(run_dir / "telemetry.jsonl"))
    (recovered,) = [e for e in events if e.get("ev") == "experiment"
                    and e.get("phase") == "recovered"]
    assert [e["epoch"] for e in events if e.get("ev") == "driver_epoch"] == [1, 2]
    assert 1 <= recovered["inflight"] <= workers
    assert out["num_trials"] == total + recovered["inflight"]
    finals = [e["trial"] for e in events if e.get("ev") == "trial"
              and e.get("phase") == "finalized"]
    assert len(finals) == len(set(finals)) == out["num_trials"]
    sizes = {m: os.path.getsize(count_dir / m) for m in os.listdir(count_dir)}
    assert len(sizes) >= total
    rerun = {m for m, n in sizes.items() if n > 1}
    assert all(n <= 2 for n in sizes.values()) and len(rerun) <= workers
    # Only markers of trials in flight at the kill ran twice.
    assert rerun <= {m for m in markers_before} and \
        len(finalized_before) + len(rerun) <= len(markers_before)
    # The journal of both incarnations replays to the same goodput in both
    # packages: the gap between the kill and the resume lands in a bucket
    # maggy_tpu's compute_goodput gives it.
    assert port_telemetry.derive(events) == jax_telemetry.derive(
        jax_telemetry.read_events(str(run_dir / "telemetry.jsonl")))


def test_resume_is_a_config_field_as_in_jax():
    assert OptimizationConfig().resume is JaxConfig().resume is False
    assert OptimizationConfig(resume=True).resume is True
