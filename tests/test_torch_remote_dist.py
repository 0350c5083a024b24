"""Distributed training over remote agents: ``lagom(train_fn,
DistributedConfig(backend="remote", bind_host="127.0.0.1"))`` with two
``python -m maggy_tpu_torch.runner`` agent processes on the CPU, as
``tests/test_remote_runner.py:138-181`` runs the JAX package's: the driver
publishes its ticket, each agent JOINs, takes its rank and the world's
shape from the JOIN reply, registers, meets the other at worker 0's
rendezvous store (advertised at the address the agent reaches the driver
from) and trains the data-parallel linear regression of
``tests/test_torch_distributed.py`` (final loss < 1e-3 on both, the same
averaged loss). Each agent runs with ``--chips-per-agent 1 --agent-index
i`` and sees CUDA_VISIBLE_DEVICES=i before its train function runs
(``tests/test_remote_runner.py:184-250``'s pinning; the ranks train on the
CPU, so the variable is inert). Every agent process is killed in a
``finally``."""

import glob
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from maggy_tpu_torch import DistributedConfig, experiment
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv
from maggy_tpu_torch.runner import load_train_fn

pytestmark = [pytest.mark.torch, pytest.mark.timeout(180)]

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def test_two_remote_agents_train_a_world(tmp_path):
    EnvSing.set_instance(LocalEnv(base_dir=str(tmp_path / "exp")))
    os.environ["MAGGY_TEST_DIST_DIR"] = str(tmp_path)
    config = DistributedConfig(name="remote_dist", num_workers=2, mesh_shape={"data": 2},
                               hb_interval=0.1, backend="remote", bind_host="127.0.0.1",
                               device="cpu")
    box = {}

    def drive():
        try:
            box["result"] = experiment.lagom(
                load_train_fn("torch_runner_fns:dp_train_fn"), config)
        except BaseException as e:  # noqa: BLE001 - read back by the test
            box["error"] = e

    driver = threading.Thread(target=drive, daemon=True)
    agents = []
    try:
        driver.start()
        ticket, deadline = None, time.monotonic() + 30
        while ticket is None and time.monotonic() < deadline:
            hits = glob.glob(str(tmp_path / "exp" / "*" / "runner_ticket.json"))
            ticket = hits[0] if hits else None
            time.sleep(0.1)
        assert ticket, "the driver never published runner_ticket.json"
        assert json.load(open(ticket))["host"] == "127.0.0.1"
        env = dict(os.environ, PYTHONPATH=TESTS_DIR + os.pathsep + os.environ.get(
            "PYTHONPATH", ""))
        agents = [subprocess.Popen(
            [sys.executable, "-m", "maggy_tpu_torch.runner", "--ticket", ticket,
             "--train", "torch_runner_fns:dp_train_fn", "--chips-per-agent", "1",
             "--agent-index", str(i)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for i in range(2)]
        for a in agents:
            out, _ = a.communicate(timeout=120)
            assert a.returncode == 0, out.decode()
        driver.join(60)
        assert not driver.is_alive(), "the driver did not finish"
    finally:
        for a in agents:
            if a.poll() is None:
                a.kill()
                a.wait(10)
        os.environ.pop("MAGGY_TEST_DIST_DIR", None)
        EnvSing.reset()
    assert "error" not in box, box.get("error")
    result = box["result"]
    assert result["num_workers"] == 2 and len(result["per_worker"]) == 2
    assert max(result["per_worker"]) < 1e-3
    ranks = [json.load(open(tmp_path / "rank{}.json".format(r))) for r in (0, 1)]
    assert ranks[0]["loss"] == ranks[1]["loss"] and ranks[0]["pid"] != ranks[1]["pid"]
    assert {ranks[0]["pid"], ranks[1]["pid"]} == {a.pid for a in agents}
    assert sorted(r["cuda_visible"] for r in ranks) == ["0", "1"]
    assert all(r["rows_match"] and r["rows"] == 32 for r in ranks)
