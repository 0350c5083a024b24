"""Remote runners in the port against maggy_tpu's on the CPU: JOIN hands out
partition ids in order, refuses without admission, and reclaims a slot only
once its issue went stale; the registration barrier on both sides;
``load_train_fn``'s validation; a seeded ``pool="remote"`` RandomSearch
sweep served by two ``python -m maggy_tpu_torch.runner`` processes against
the same sweep of the JAX package served by ``python -m maggy_tpu.runner``
(the same trial count and finalized set); and a driver that fails instead
of hanging when no agent joins."""

import glob
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from maggy_tpu import experiment as jax_experiment
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.core.rpc import OptimizationServer as JaxServer
from maggy_tpu.runner import join_experiment as jax_join
from maggy_tpu.searchspace import Searchspace as JaxSearchspace

from maggy_tpu_torch import OptimizationConfig, Searchspace, constants, experiment
from maggy_tpu_torch.core import rpc
from maggy_tpu_torch.runner import join_experiment, load_train_fn, read_ticket

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
SPACE = dict(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64]))
INFO = {"hb_interval": 0.5, "exp_dir": "/tmp/x", "optimization_key": "metric",
        "trial_type": "optimization"}


def _join_sequence(server_cls, join):
    server = server_cls(num_executors=2)
    server.join_info = dict(INFO)
    addr = server.start()
    out = []
    try:
        for _ in range(2):
            r = join(addr, server.secret_hex)
            out.append((r["partition_id"], r["exp_dir"], r["hb_interval"]))
        for want in (None, 1):
            try:
                join(addr, server.secret_hex, partition_id=want)
            except RuntimeError as e:
                out.append(str(e).split(":", 1)[1].strip()[:28])
        # A slot issued to a joiner that never registered is reclaimed once
        # its issue is older than the liveness bound.
        server.hb_loss_timeout = 0.3
        time.sleep(0.4)
        out.append(join(addr, server.secret_hex, partition_id=1)["partition_id"])
        # A registered, live holder keeps its slot.
        server.reservations.add({"partition_id": 0})
        try:
            join(addr, server.secret_hex, partition_id=0)
        except RuntimeError as e:
            out.append(str(e).split(":", 1)[1].strip())
        server.join_info = None
        try:
            join(addr, server.secret_hex)
        except RuntimeError as e:
            out.append(str(e).split(":", 1)[1].strip())
    finally:
        server.stop()
    return out


def test_join_hands_out_pids_in_order_and_refuses_as_jax():
    port = _join_sequence(lambda num_executors: rpc.OptimizationServer(
        num_executors=num_executors), join_experiment)
    jax = _join_sequence(JaxServer, jax_join)
    assert port == jax
    assert port[:2] == [(0, "/tmp/x", 0.5), (1, "/tmp/x", 0.5)]
    assert port[2] == "experiment full"
    assert port[-1] == "this experiment does not accept remote runners"


def test_registration_barrier_on_both_sides(monkeypatch):
    monkeypatch.setattr(constants, "CLIENT_POLL_INTERVAL_S", 0.05)
    server = rpc.OptimizationServer(num_executors=2)
    addr = server.start()
    try:
        with pytest.raises(TimeoutError, match="2 of 2 executors missing"):
            server.await_reservations(timeout=0.2)
        client = rpc.Client(addr, 0, 1.0, server.secret_hex)
        with pytest.raises(TimeoutError):
            client.await_reservations(timeout=0.2)
        for pid in (0, 1):
            server.reservations.add({"partition_id": pid})
        client.await_reservations(timeout=2)
        assert set(server.await_reservations(timeout=1)) == {0, 1}
        client.stop()
    finally:
        server.stop()


def test_load_train_fn_and_read_ticket_validate(tmp_path):
    for bad in ("no_colon_here", ":fn", "mod:"):
        with pytest.raises(ValueError):
            load_train_fn(bad)
    with pytest.raises(TypeError):
        load_train_fn("maggy_tpu_torch.constants:DEFAULT_ES_POLICY")
    assert load_train_fn("torch_runner_fns:train_remote").__name__ == "train_remote"
    path = str(tmp_path / "ticket.json")
    with pytest.raises(FileNotFoundError):
        read_ticket(path, wait_s=0)
    with open(path, "w") as f:
        f.write('{"host": "127.0.0.1"')
    with pytest.raises(FileNotFoundError):
        read_ticket(path, wait_s=0)
    with open(path, "w") as f:
        json.dump({"host": "127.0.0.1", "port": 1, "secret": "s"}, f)
    assert read_ticket(path)["port"] == 1


def test_auto_workers_are_refused_for_remote_and_elastic_is_not_ported():
    from maggy_tpu_torch.core.runner_pool import resolve_num_workers

    with pytest.raises(ValueError, match="admission cap"):
        resolve_num_workers(OptimizationConfig(pool="remote", num_workers="auto"))
    # The elastic pool is ported; "auto" sizes it by the visible cards,
    # and a host without one is refused.
    assert OptimizationConfig(pool="elastic").pool == "elastic"
    with pytest.raises(ValueError, match="no CUDA device"):
        resolve_num_workers(OptimizationConfig(pool="elastic", num_workers="auto"))


def _remote_sweep(pkg, base, agent_cmd, env_extra):
    """A seeded RandomSearch sweep of 6 trials under pool="remote" with
    num_workers=2, served by two agent processes; returns (result, the
    finalized trial ids, the agents' exit codes and stderr tails)."""
    cfg_cls, space_cls, lagom = (
        (OptimizationConfig, Searchspace, experiment.lagom) if pkg == "port"
        else (JaxConfig, JaxSearchspace, jax_experiment.lagom))
    # Both drivers bind loopback (the JAX package's remote default is
    # 0.0.0.0, advertising this host's address): the agents are local.
    extra = {} if pkg == "port" else {"bind_host": "127.0.0.1"}
    config = cfg_cls(name="remote_" + pkg, num_trials=6, optimizer="randomsearch",
                     searchspace=space_cls(**SPACE), direction="max", num_workers=2,
                     pool="remote", es_policy="none", hb_interval=0.1, seed=7,
                     experiment_dir=base, **extra)
    out = {}
    if pkg == "jax":
        jax_experiment.APP_ID = "remote"

    def run():
        try:
            out["result"] = lagom(None, config)
        except BaseException as e:  # noqa: BLE001 - reported below
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    ticket = os.path.join(base, "remote_0", "runner_ticket.json")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, ROOT]), JAX_PLATFORMS="cpu",
               **env_extra)
    procs = []
    agents = []
    try:
        for _ in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", *agent_cmd, "--ticket", ticket, "--wait-ticket", "30"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for p in procs:
            try:
                _, err = p.communicate(timeout=90)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate(timeout=10)
            agents.append((p.returncode, err[-1500:]))
    finally:
        # The test's time limit may interrupt the waits above: no agent
        # outlives the test.
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    thread.join(30)
    assert "error" not in out, out.get("error")
    finals = set()
    for path in glob.glob(os.path.join(base, "remote_0", "*", "trial.json")):
        with open(path) as f:
            trial = json.load(f)
        if trial["status"] == "FINALIZED":
            finals.add(trial["id"])
    return out["result"], finals, agents


@pytest.mark.timeout(150)
def test_remote_sweep_on_two_agent_processes_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGGY_TPU_APP_ID", "remote")
    gate = str(tmp_path / "agents")
    os.makedirs(gate)
    port, port_finals, port_agents = _remote_sweep(
        "port", str(tmp_path / "port"),
        ["maggy_tpu_torch.runner", "--train", "torch_runner_fns:train_remote_gated"],
        {"MAGGY_TEST_AGENT_DIR": gate})
    jax, jax_finals, _ = _remote_sweep(
        "jax", str(tmp_path / "jax"), ["maggy_tpu.runner", "--train",
                                       "remote_train_module:train_fn"], {})
    assert [rc for rc, _ in port_agents] == [0, 0], port_agents
    assert port["num_trials"] == jax["num_trials"] == 6
    assert port_finals == jax_finals and len(port_finals) == 6
    # Both agent processes served trials of the port's sweep.
    pids = set()
    for path in glob.glob(str(tmp_path / "port" / "remote_0" / "*" / ".outputs.json")):
        with open(path) as f:
            pids.add(json.load(f)["pid"])
    assert len(pids) == 2 and os.getpid() not in pids
    assert port["best_val"] == pytest.approx(jax["best_val"], abs=0)


@pytest.mark.timeout(60)
def test_the_driver_fails_instead_of_hanging_when_no_agent_joins(tmp_path, monkeypatch):
    monkeypatch.setattr(constants, "REGISTRATION_TIMEOUT_S", 1.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="no remote runner registered"):
        experiment.lagom(None, OptimizationConfig(
            name="nobody", num_trials=2, searchspace=Searchspace(**SPACE), num_workers=1,
            pool="remote", es_policy="none", experiment_dir=str(tmp_path)))
    assert time.monotonic() - t0 < 30
    (ticket,) = glob.glob(str(tmp_path / "*" / "runner_ticket.json"))
    with open(ticket) as f:
        assert set(json.load(f)) >= {"host", "port", "secret", "num_workers"}


@pytest.mark.parametrize("hosts,cards,mode,pool", [
    ("", 0, "LOCAL", "thread"), ("", 1, "GPU_HOST", "gpu"), ("", 8, "GPU_HOST", "gpu"),
    ("a,b", 0, "GPU_CLUSTER", "gpu"), ("a", 0, "LOCAL", "thread")])
def test_core_config_detects_the_card_host(monkeypatch, hosts, cards, mode, pool):
    """The three-way shape of ``maggy_tpu/core/config.py`` with the TPU
    markers turned into a CUDA host check; the JAX package's answers for the
    same shape of environment stand beside it."""
    import torch

    from maggy_tpu.core import config as jax_core_config
    from maggy_tpu_torch.core import config as core_config

    monkeypatch.setenv("MAGGY_TPU_WORKER_HOSTNAMES", hosts)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert core_config.num_local_chips() == cards
    assert core_config.detect_mode() == mode
    assert core_config.default_pool_type() == pool
    # The JAX package: the same ladder over its own markers.
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", hosts)
    monkeypatch.delenv("TPU_SKIP_MDS_QUERY", raising=False)
    if cards:
        monkeypatch.setenv("TPU_WORKER_ID", "0")
    else:
        monkeypatch.delenv("TPU_WORKER_ID", raising=False)
    jax_mode = jax_core_config.detect_mode()
    assert {"LOCAL": "LOCAL", "TPU_VM": "GPU_HOST", "TPU_POD": "GPU_CLUSTER"}[jax_mode] == mode
    assert (jax_core_config.default_pool_type() == "thread") == (pool == "thread")


def test_core_config_survives_a_broken_cuda_runtime(monkeypatch):
    import torch

    from maggy_tpu_torch.core import config as core_config

    def broken():
        raise RuntimeError("no driver")

    monkeypatch.delenv("MAGGY_TPU_WORKER_HOSTNAMES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", broken)
    assert core_config.num_local_chips() == 0 and core_config.detect_mode() == "LOCAL"
