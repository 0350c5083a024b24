"""Runner pools and heartbeat-loss recovery of the port: a runner that dies
while it holds a trial (a SystemExit in a thread runner, a crashed or a
wedged runner process) costs one requeue, and the sweep completes on the
survivors as in maggy_tpu; a FINAL from a run declared lost is dropped once
while the re-run counts; device pinning, pool validation and the loss
timeout's resolution."""

import functools
import glob
import json
import os
import threading
import time

import pytest

from maggy_tpu import experiment as jax_experiment
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.searchspace import Searchspace as JaxSearchspace

import maggy_tpu.telemetry as jax_telemetry
import maggy_tpu_torch.telemetry as port_telemetry
import torch_runner_fns
from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.core.rpc import Client, Reservations
from maggy_tpu_torch.core.runner_pool import GPURunnerPool, device_env

# Each test bounded; the sweeps set their own, longer bound.
pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

SPACE = dict(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64]))


def _finalized(exp_dir):
    trials = []
    for run in os.listdir(exp_dir):
        for entry in os.listdir(os.path.join(exp_dir, run)):
            path = os.path.join(exp_dir, run, entry, "trial.json")
            if os.path.exists(path):
                with open(path) as f:
                    trials.append(json.load(f))
    return trials


def _exit_first_call():
    """A train function whose first call raises SystemExit, which the trial
    executor does not catch: the runner thread dies holding its trial."""
    calls, lock = [], threading.Lock()

    def train(lr, units, reporter):
        with lock:
            calls.append(lr)
            first = len(calls) == 1
        if first:
            raise SystemExit(3)
        reporter.broadcast(lr, step=0)
        return {"metric": 1.0 - (lr - 0.1) ** 2}

    return train, calls


@pytest.mark.timeout(120)
def test_system_exit_sweep_recovers_like_maggy_tpu(tmp_path):
    """4 trials, 2 thread runners, RandomSearch: the first train_fn call
    raises SystemExit. Both packages re-run that trial on the survivor: 5
    calls, 4 finalized trials, one lost runner."""
    kw = dict(name="system_exit", num_trials=4, optimizer="randomsearch", direction="max",
              num_workers=2, hb_interval=0.05, hb_loss_timeout=1.0, seed=3, es_policy="none")
    train, calls = _exit_first_call()
    result = experiment.lagom(train, OptimizationConfig(
        searchspace=Searchspace(**SPACE), experiment_dir=str(tmp_path / "port"), **kw))
    jtrain, jcalls = _exit_first_call()
    jresult = jax_experiment.lagom(jtrain, JaxConfig(
        searchspace=JaxSearchspace(**SPACE), experiment_dir=str(tmp_path / "jax"), **kw))

    for res, n_calls, exp_dir in ((result, calls, "port"), (jresult, jcalls, "jax")):
        trials = _finalized(str(tmp_path / exp_dir))
        assert len(n_calls) == 5, exp_dir
        assert res["num_trials"] == len(trials) == 4, exp_dir
        assert all(t["status"] == "FINALIZED" for t in trials), exp_dir
        assert res["lost_runners"] == 1, exp_dir
    # The same seed gives the same four trials; which one ran twice depends
    # on which runner thread called train_fn first.
    assert set(calls) == set(jcalls) and len(set(calls)) == 4
    requeued = result["recovery"]["requeued"]
    assert len(requeued) == 1 and requeued[0]["trial_id"] in {
        t["id"] for t in _finalized(str(tmp_path / "port"))}
    assert result["recovery"]["killed"] == []  # a thread cannot be killed


@pytest.mark.timeout(120)
def test_system_exit_sweep_journals_the_loss_like_maggy_tpu(tmp_path):
    """The SystemExit sweep with the journal on, through both packages:
    one ``lost`` and one ``requeued`` event (reason heartbeat_loss) for the
    same trial, each trial finalized once, the dead attempt booked as
    rework; the port's result.json recovery block is that requeue event."""
    kw = dict(name="system_exit_journal", num_trials=4, optimizer="randomsearch",
              direction="max", num_workers=2, hb_interval=0.05, hb_loss_timeout=1.0, seed=3,
              es_policy="none")
    train, _ = _exit_first_call()
    result = experiment.lagom(train, OptimizationConfig(
        searchspace=Searchspace(**SPACE), experiment_dir=str(tmp_path / "port"), **kw))
    jtrain, _ = _exit_first_call()
    jax_experiment.lagom(jtrain, JaxConfig(
        searchspace=JaxSearchspace(**SPACE), experiment_dir=str(tmp_path / "jax"), **kw))
    for name, telemetry in (("port", port_telemetry), ("jax", jax_telemetry)):
        (journal,) = glob.glob(str(tmp_path / name / "*" / "telemetry.jsonl"))
        events = telemetry.read_events(journal)
        trial_events = [e for e in events if e["ev"] == "trial"]
        lost = [e for e in trial_events if e["phase"] == "lost"]
        requeued = [e for e in trial_events if e["phase"] == "requeued"]
        assert len(lost) == len(requeued) == 1, name
        assert requeued[0]["reason"] == "heartbeat_loss", name
        assert requeued[0]["trial"] == lost[0]["trial"], name
        finalized = [e["trial"] for e in trial_events if e["phase"] == "finalized"]
        assert len(finalized) == len(set(finalized)) == 4, name
        derived = telemetry.replay_journal(journal)
        assert derived["torn_lines"] == 0, name
        assert derived["trials"]["lost"] == derived["trials"]["requeued"] == 1, name
        assert derived["goodput"]["buckets"]["rework"] > 0, name
        if name == "port":
            assert result["recovery"]["requeued"] == [
                {"trial_id": requeued[0]["trial"], "partition": requeued[0]["partition"],
                 "at": requeued[0]["t"]}]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("fault", ["crash", "wedge"])
def test_process_runner_fault_is_recovered(tmp_path, fault):
    """The port's counterparts of maggy_tpu's TestHeartbeatLossE2E: a runner
    process that exits mid-trial, or freezes mid-trial (SIGSTOP), under
    pool="process". Its trial re-runs on the survivor, the wedged process is
    SIGKILLed, and every trial finalizes."""
    flag = str(tmp_path / "{}.flag".format(fault))
    fn = torch_runner_fns.train_crash if fault == "crash" else torch_runner_fns.train_wedge
    result = experiment.lagom(functools.partial(fn, flag=flag), OptimizationConfig(
        name="process_" + fault, num_trials=4, optimizer="randomsearch",
        searchspace=Searchspace(**SPACE), direction="max", num_workers=2, hb_interval=0.1,
        hb_loss_timeout=2.0, seed=3, es_policy="none", pool="process",
        experiment_dir=str(tmp_path / "exp")))
    trials = _finalized(str(tmp_path / "exp"))
    assert os.path.exists(flag)
    assert result["num_trials"] == len(trials) == 4
    assert all(t["status"] == "FINALIZED" for t in trials)
    assert result["lost_runners"] >= 1
    lost = {r["trial_id"] for r in result["recovery"]["requeued"]}
    assert lost <= {t["id"] for t in trials}
    if fault == "wedge":
        assert result["recovery"]["killed"]


def test_lost_assignments_are_silent_partitions_holding_a_trial():
    res = Reservations()
    for pid in range(3):
        res.add({"partition_id": pid, "trial_id": None})
    res.assign_trial(0, "a")
    res.assign_trial(1, "b")
    time.sleep(0.2)
    res.touch(1)
    assert res.lost_assignments(0.1) == [(0, "a")]
    assert sorted(res.silent(0.1)) == [0, 2]
    res.mark_released(2)  # told GSTOP: its silence is expected
    assert res.silent(0.1) == [0]
    assert res.lost_assignments(10.0) == []
    res.clear_trial_if(0, "a")
    assert res.lost_assignments(0.1) == []


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


@pytest.mark.parametrize("prefetch", [True, False])
def test_falsely_lost_runners_final_is_dropped_once(tmp_path, prefetch):
    """Runner 0 holds the only trial and goes silent; the scan declares it
    lost and the trial re-runs on runner 1 with a new run epoch. Runner 0
    was only slow: its FINAL arrives, and again on a retry. The first is
    dropped as stale, the retry finds the trial gone, and only runner 1's
    result counts. Prefetch on takes the FINALs on the RPC thread, off on
    the driver's worker thread."""
    config = OptimizationConfig(
        name="false_loss", num_trials=1, optimizer="randomsearch",
        searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2])), num_workers=2,
        hb_interval=0.05, hb_loss_timeout=0.3, seed=0, es_policy="none",
        prefetch=prefetch, experiment_dir=str(tmp_path))
    driver = OptimizationDriver(config, "app-false-loss", 0)
    driver.server_addr = driver.env.connect_host(driver.server)
    driver._start_worker()
    secret = driver.server.secret_hex
    slow = Client(driver.server_addr, 0, config.hb_interval, secret)
    live = Client(driver.server_addr, 1, config.hb_interval, secret)
    slow_rep, live_rep = Reporter(), Reporter()
    try:
        slow.register()
        trial_id, _ = slow.get_suggestion()
        assert slow.last_info["epoch"] == 0
        live.register()
        live.start_heartbeat(live_rep)  # runner 0 never beats
        _wait(lambda: driver.result["lost_runners"] == 1)
        rerun_id, _ = live.get_suggestion()
        assert rerun_id == trial_id and live.last_info["epoch"] == 1

        slow_rep.reset(trial_id=trial_id)
        slow.finalize_metric(0.5, slow_rep)
        _wait(lambda: driver.result["recovery"]["stale_finals_dropped"] == 1)
        assert driver.result["num_trials"] == 0

        live_rep.reset(trial_id=trial_id)
        live.finalize_metric(0.9, live_rep)
        _wait(lambda: driver.result["num_trials"] == 1)
        slow_rep.reset(trial_id=trial_id)
        slow.finalize_metric(0.5, slow_rep)  # a retry of the stale FINAL
        time.sleep(0.3)
        assert driver.result["num_trials"] == 1 and driver.result["best_val"] == 0.9
        assert driver.result["recovery"]["stale_finals_dropped"] == 1
        assert driver.result["lost_runners"] == 1
        assert driver.experiment_done
    finally:
        slow.stop()
        live.stop()
        driver.stop()


def test_device_env_pins_disjoint_devices(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert device_env(0) == {"CUDA_VISIBLE_DEVICES": "0"}
    assert device_env(1, 2) == {"CUDA_VISIBLE_DEVICES": "2,3"}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert device_env(1, 2) == {"CUDA_VISIBLE_DEVICES": "6,7"}
    with pytest.raises(ValueError, match="lists 4"):
        device_env(2, 2)


def test_gpu_pool_refuses_more_devices_than_visible(tmp_path):
    GPURunnerPool(2, chips_per_trial=2, visible_devices=4)
    with pytest.raises(ValueError, match="exceeds the 4 visible"):
        GPURunnerPool(3, chips_per_trial=2, visible_devices=4)
    # Through the driver, on a host with no card: the experiment fails.
    with pytest.raises(ValueError, match="visible CUDA devices"):
        experiment.lagom(torch_runner_fns.train_crash, OptimizationConfig(
            name="gpu_pool", num_trials=2, searchspace=Searchspace(**SPACE), num_workers=1,
            pool="gpu", es_policy="none", experiment_dir=str(tmp_path)))


@pytest.mark.parametrize("pool, error, match", [
    ("thread", None, None), ("process", None, None), ("gpu", None, None),
    ("tpu", ValueError, "pool='gpu'"), ("elastic", None, None),
    ("remote", None, None), ("spark", ValueError, "must be one of")])
def test_config_validates_the_pool(pool, error, match):
    if error is None:
        assert OptimizationConfig(pool=pool).pool == pool
    else:
        with pytest.raises(error, match=match):
            OptimizationConfig(pool=pool)
    with pytest.raises(ValueError, match="chips_per_trial"):
        OptimizationConfig(pool="gpu", chips_per_trial=0)


@pytest.mark.parametrize("kw", [dict(hb_interval=0.1), dict(hb_interval=1.0),
                                dict(hb_interval=0.1, hb_loss_timeout=3.0),
                                dict(hb_interval=0.5, hb_loss_factor=4.0, hb_loss_min_s=1.0)])
def test_loss_timeout_resolves_as_in_maggy_tpu(kw):
    assert OptimizationConfig(**kw).resolved_hb_loss_timeout() == \
        JaxConfig(**kw).resolved_hb_loss_timeout()
