"""The elastic pool (``ElasticRunnerPool``, ``pool="elastic"``) through the
port's lagom, with both scenarios of ``tests/test_experiment.py:394-463``:
ASHA promotions whose budgets need bigger chip leases make 1-chip runners
exit and respawn re-pinned, and the pool migrates through three lease sizes
(park, herd-bounded resize, retirement). Every trial runs on the lease its
budget maps to, and the journal's lease events never hold more than
``total_chips`` at once. Runner processes are spawned on the CPU."""

import glob
import os

import pytest

import torch_runner_fns
from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.core.runner_pool import (CAPACITY_ENV, LEASE_CHIPS_ENV, lease_env)
from maggy_tpu_torch.optimizers import Asha
from maggy_tpu_torch.telemetry import read_events

pytestmark = [pytest.mark.torch, pytest.mark.timeout(90)]


def _space():
    return Searchspace(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64]))


def _leases_held(exp_dir):
    """The most chips the journal's lease events hold at once, and the
    number of lease starts."""
    (journal,) = glob.glob(os.path.join(exp_dir, "*", "telemetry.jsonl"))
    held, peak, starts = 0, 0, 0
    for ev in read_events(journal):
        if ev.get("ev") != "lease":
            continue
        if ev["phase"] == "start":
            held += ev["capacity"]
            starts += 1
        else:
            held -= ev["capacity"]
        peak = max(peak, held)
    return peak, starts, held


def _sweep(tmp_path, monkeypatch, name, seed, asha_seed, chips_per_budget):
    d = tmp_path / "markers"
    d.mkdir()
    monkeypatch.setenv("MAGGY_TPU_ELASTIC_DIR", str(d))
    exp_dir = str(tmp_path / "exp")
    result = experiment.lagom(torch_runner_fns.train_elastic, OptimizationConfig(
        name=name, num_trials=9,
        optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=9, seed=asha_seed),
        searchspace=_space(), direction="max", num_workers=2, hb_interval=0.1, seed=seed,
        es_policy="none", pool="elastic", chips_per_trial=1, total_chips=4,
        chips_per_budget=chips_per_budget, experiment_dir=exp_dir))
    return result, os.listdir(d), exp_dir


def test_budget_sized_subslices(tmp_path, monkeypatch):
    """Promoted budget-9 trials need 2-chip leases: 1-chip runners exit and
    respawn re-pinned; every trial runs on the lease size its budget maps
    to, and the schedule completes."""
    result, markers, exp_dir = _sweep(tmp_path, monkeypatch, "elastic_e2e", 4, 0,
                                      {1: 1, 3: 1, 9: 2})
    assert markers, "no trials recorded"
    for m in markers:
        budget, chips, _ = m.split("_")
        assert (chips == "2") == (budget == "9"), (budget, chips, markers)
    assert any(m.startswith("9_") for m in markers), markers
    assert result["num_trials"] >= 9
    peak, starts, held = _leases_held(exp_dir)
    assert peak <= 4 and starts > 2 and held == 0


def test_pool_migrates_through_three_rung_sizes(tmp_path, monkeypatch):
    """Chips migrate as rungs drain: 2 one-chip runners (a 4-chip budget)
    serve rung 0, resize to 2-chip leases for rung 1, and consolidate into
    one 4-chip lease for the last rung."""
    result, markers, exp_dir = _sweep(tmp_path, monkeypatch, "elastic_rungs", 6, 1,
                                      {1: 1, 3: 2, 9: 4})
    expect = {"1": "1", "3": "2", "9": "4"}
    for m in markers:
        budget, chips, _ = m.split("_")
        assert chips == expect[budget], (m, markers)
    assert {m.split("_")[0] for m in markers} == {"1", "3", "9"}
    assert result["num_trials"] >= 9
    peak, starts, held = _leases_held(exp_dir)
    assert peak <= 4 and held == 0


def test_lease_env_pins_the_distinct_devices_of_a_lease(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    env = lease_env({3, 1}, device_count=1)
    assert env == {LEASE_CHIPS_ENV: "1,3", CAPACITY_ENV: "2", "CUDA_VISIBLE_DEVICES": "0"}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,7")
    assert lease_env({0, 1, 2}, device_count=2)["CUDA_VISIBLE_DEVICES"] == "5,7"
    assert "CUDA_VISIBLE_DEVICES" not in lease_env({0}, device_count=0)
