"""Distributed training through the port's ``lagom(train_fn,
DistributedConfig(...))`` on the CPU: ``tests/test_distributed.py:30-179``
carried over.

Process ranks are spawned runner processes joined in a gloo world through
worker 0's rendezvous store (a port bound to 0, advertised on its REG);
thread mode runs every worker in a thread of this process, each on a
world-1 mesh. Checked: the mesh each rank builds and the refusal of one
larger than the world, each rank's batch rows (``ShardingEnv.shard_batch``),
data-parallel linear regression converging on 2 process ranks and in thread
mode (final loss < 1e-3, as the JAX test), the result keys
(``average_metric``, ``per_worker``, ``num_workers``), a failing rank
failing the experiment with no rank process left alive (its survivor
blocked in a collective the failed rank never joins), and a silent worker
declared dead by the server's heartbeat-loss scan. The process experiments
run one after another from one module fixture.
"""

import json
import os
import time

import pytest

import torch_runner_fns
from maggy_tpu_torch import DistributedConfig, experiment
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]


def _config(name, **kw):
    return DistributedConfig(name=name, num_workers=2, mesh_shape={"data": 2}, hb_interval=0.05,
                             device="cpu", **kw)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture(scope="module")
def process_worlds(tmp_path_factory):
    """The DP world and the failing world, one after the other."""
    base = tmp_path_factory.mktemp("dist")
    EnvSing.set_instance(LocalEnv(base_dir=str(base / "exp")))
    out = {}
    try:
        for name, fn in (("dp", torch_runner_fns.dp_train_fn),
                         ("fail", torch_runner_fns.failing_rank1_train_fn)):
            d = base / name
            d.mkdir()
            os.environ["MAGGY_TEST_DIST_DIR"] = str(d)
            t0 = time.monotonic()
            try:
                out[name] = {"result": experiment.lagom(fn, _config("dist_" + name,
                                                                    backend="process"))}
            except RuntimeError as e:
                out[name] = {"error": str(e)}
            out[name]["wall"] = time.monotonic() - t0
            out[name]["dir"] = str(d)
    finally:
        os.environ.pop("MAGGY_TEST_DIST_DIR", None)
        EnvSing.reset()
    return out


@pytest.fixture
def local_env(tmp_path):
    EnvSing.set_instance(LocalEnv(base_dir=str(tmp_path / "exp")))
    yield
    EnvSing.reset()


def test_dp_on_two_process_ranks(process_worlds):
    run = process_worlds["dp"]
    result = run["result"]
    assert result["num_workers"] == 2 and len(result["per_worker"]) == 2
    assert max(result["per_worker"]) < 1e-3
    assert result["average_metric"] == pytest.approx(sum(result["per_worker"]) / 2)
    ranks = [json.load(open(os.path.join(run["dir"], "rank{}.json".format(r)))) for r in (0, 1)]
    # One process a rank, and the same averaged loss on both.
    assert ranks[0]["pid"] != ranks[1]["pid"] and ranks[0]["loss"] == ranks[1]["loss"]


def test_the_mesh_and_each_ranks_batch(process_worlds):
    run = process_worlds["dp"]
    for r in (0, 1):
        seen = json.load(open(os.path.join(run["dir"], "rank{}.json".format(r))))
        assert seen["axis_names"] == ["data"]
        assert seen["rows"] == 32 and seen["rows_match"]
        assert "needs 3 devices, have 2" in seen["bad_mesh"]


def test_a_failing_rank_fails_the_experiment_and_leaves_no_rank(process_worlds):
    run = process_worlds["fail"]
    assert "1 of 2 distributed workers failed" in run["error"]
    pids = [int(open(os.path.join(run["dir"], "pid{}".format(r))).read()) for r in (0, 1)]
    assert not any(_alive(pid) for pid in pids)
    # Rank 0 waited in a collective: the driver's kill ended it, well
    # before the group's timeout.
    assert run["wall"] < 60


def test_dp_in_thread_mode(local_env):
    result = experiment.lagom(torch_runner_fns.dp_train_fn, _config("dp_threads",
                                                                    backend="thread"))
    assert result["num_workers"] == 2 and len(result["per_worker"]) == 2
    assert max(result["per_worker"]) < 1e-3


def test_single_worker_runs_a_world_of_one(local_env):
    result = experiment.lagom(torch_runner_fns.dp_train_fn, DistributedConfig(
        name="dp_one", num_workers=1, mesh_shape={"data": 1}, hb_interval=0.05, device="cpu"))
    assert result["num_workers"] == 1 and result["average_metric"] < 1e-3


def test_failed_worker_fails_the_experiment_in_thread_mode(local_env, tmp_path):
    os.environ["MAGGY_TEST_DIST_DIR"] = str(tmp_path)
    try:
        with pytest.raises(RuntimeError, match="1 of 2 distributed workers"):
            experiment.lagom(torch_runner_fns.failing_rank1_train_fn,
                             _config("dp_fail_threads", backend="thread"))
    finally:
        os.environ.pop("MAGGY_TEST_DIST_DIR", None)


def test_unported_backend_and_bad_fields_raise():
    # "remote" and bind_host run (tests/test_torch_remote_dist.py): the
    # JAX package's defaults, and an unknown backend or device raises.
    assert DistributedConfig(backend="remote").bind_host == "0.0.0.0"
    assert DistributedConfig(backend="remote", bind_host="127.0.0.1").bind_host == "127.0.0.1"
    assert DistributedConfig(bind_host="0.0.0.0").backend is None
    assert DistributedConfig().bind_host is None
    with pytest.raises(ValueError, match="backend"):
        DistributedConfig(backend="mpi")
    with pytest.raises(ValueError, match="device"):
        DistributedConfig(device="tpu")


def test_silent_worker_detected_as_dead():
    """Server-side: a registered worker that stops heartbeating is reported
    as DEAD_WORKER."""
    from maggy_tpu_torch.core.rpc import Client, DistributedServer

    class FakeDriver:
        def __init__(self):
            self.messages = []

        def enqueue(self, msg):
            self.messages.append(msg)

        def progress_snapshot(self):
            return {}

    driver = FakeDriver()
    server = DistributedServer(num_executors=2)
    server.attach_driver(driver)
    server.hb_loss_timeout = 0.5
    addr = server.start()
    try:
        client = Client(addr, 0, 10.0, server.secret_hex)
        client.register(host_port="h:1")
        client.stop()  # dies silently: no heartbeats, no FINAL
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if any(m["type"] == "DEAD_WORKER" and m["partition_id"] == 0
                   for m in driver.messages):
                break
            time.sleep(0.05)
        else:
            pytest.fail("DEAD_WORKER never enqueued")
        assert server.reservations.get(0)["host_port"] == "h:1"
    finally:
        server.stop()


def test_dist_config_waits_for_every_registration():
    from maggy_tpu_torch.core.rpc import Client, DistributedServer

    server = DistributedServer(num_executors=2)
    addr = server.start()
    try:
        c0 = Client(addr, 0, 10.0, server.secret_hex)
        c0.register(host_port="127.0.0.1:4242")
        assert c0._request({"type": "DIST_CONFIG"})["config"] is None
        c1 = Client(addr, 1, 10.0, server.secret_hex)
        c1.register()
        c1.await_reservations(timeout=5)
        assert c1.get_dist_config(timeout=5) == {"coordinator_address": "127.0.0.1:4242",
                                                 "num_processes": 2}
        c0.stop()
        c1.stop()
    finally:
        server.stop()
