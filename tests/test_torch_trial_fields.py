"""The JAX configs' per-trial fields in the port against maggy_tpu on the
CPU: ``description`` (kept in the experiment's metadata), ``verbose`` (a
live progress line and the result summary on stdout), ``ship_prints`` (a
trial's ``print`` teed into its runner's log) and ``profile`` (one trace a
trial, a trial that finds the process's profiler taken runs untraced and
journals ``profile_skipped``). Each runs the same seeded sweep through both
packages' ``lagom``; the comparisons are exact."""

import glob
import json
import os
import threading

import pytest

from maggy_tpu import experiment as jax_experiment
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu.telemetry import read_events as jax_read_events

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.telemetry import profiling, read_events

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

SPACE = dict(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64]))


@pytest.fixture(autouse=True)
def envs(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGGY_TPU_APP_ID", "fields")
    EnvSing.set_instance(LocalEnv(base_dir=str(tmp_path / "port")))
    JaxEnvSing.set_instance(JaxLocalEnv(base_dir=str(tmp_path / "jax")))
    yield
    EnvSing.reset()
    JaxEnvSing.reset()


def train_printing(lr, units):
    """No reporter: print() is the only channel, the user code ship_prints
    exists for (``tests/test_experiment.py:293``)."""
    print("USER_PRINT lr={:.4f}".format(lr))
    return {"metric": 1.0 - (lr - 0.1) ** 2}


def _sweep(pkg, base, trials=3, workers=2, train_fn=train_printing, **fields):
    cfg, space, lagom = ((OptimizationConfig, Searchspace, experiment.lagom) if pkg == "port"
                         else (JaxConfig, JaxSearchspace, jax_experiment.lagom))
    config = cfg(name="fields_" + pkg, num_trials=trials, optimizer="randomsearch",
                 searchspace=space(**SPACE), direction="max", num_workers=workers,
                 hb_interval=0.05, seed=11, es_policy="none", experiment_dir=base, **fields)
    result = lagom(train_fn, config)
    (exp_dir,) = [d for d in glob.glob(os.path.join(base, "*")) if os.path.isdir(d)]
    return result, exp_dir


def _executor_logs(exp_dir):
    text = ""
    for path in sorted(glob.glob(os.path.join(exp_dir, "executor_*.log"))):
        with open(path) as f:
            text += f.read()
    return text


def test_description_lands_in_the_experiment_metadata_as_jax(tmp_path):
    meta = {}
    for pkg in ("port", "jax"):
        _, exp_dir = _sweep(pkg, str(tmp_path / pkg / "runs"), trials=1, workers=1,
                            description="lr sweep for the docs")
        with open(os.path.join(exp_dir, "experiment.json")) as f:
            meta[pkg] = json.load(f)
    assert meta["port"]["description"] == meta["jax"]["description"] == "lr sweep for the docs"
    assert OptimizationConfig().description == JaxConfig().description == ""


def test_verbose_prints_progress_and_the_summary_as_jax(tmp_path, capsys):
    out = {}
    for pkg in ("port", "jax"):
        for verbose in (False, True):
            capsys.readouterr()
            result, _ = _sweep(pkg, str(tmp_path / pkg / str(verbose)), verbose=verbose)
            assert result["num_trials"] == 3
            out[pkg, verbose] = capsys.readouterr().out
    summary = {}
    for pkg in ("port", "jax"):
        quiet, loud = out[pkg, False], out[pkg, True]
        assert "[fields_{}]".format(pkg) not in quiet, pkg
        assert "results ------" not in quiet, pkg
        progress = [ln for ln in loud.splitlines()
                    if ln.startswith("[fields_{}] [".format(pkg))]
        assert progress, (pkg, loud)
        # The result summary (the driver's maggy_log) closes the run: its
        # lines' labels, without their numbers.
        tail = loud[loud.index("------ RandomSearch results ------"):]
        summary[pkg] = [ln.split(" -- ")[0].split(" ")[0] for ln in tail.splitlines()]
    assert summary["port"] == summary["jax"]
    assert OptimizationConfig().verbose is JaxConfig().verbose is False


def test_ship_prints_tees_a_trials_prints_into_its_log_as_jax(tmp_path):
    shipped = {}
    for pkg in ("port", "jax"):
        for ship in (False, True):
            _, exp_dir = _sweep(pkg, str(tmp_path / pkg / str(ship)), ship_prints=ship)
            shipped[pkg, ship] = sorted(
                ln.strip() for ln in _executor_logs(exp_dir).splitlines()
                if "USER_PRINT" in ln)
    assert shipped["port", False] == shipped["jax", False] == []
    # The same three seeded trials' lines, each once.
    assert len(shipped["port", True]) == 3
    assert shipped["port", True] == shipped["jax", True]


def test_the_print_tee_ships_only_the_trials_own_thread():
    """Thread runners share builtins.print: a print on another thread while
    a shipping trial runs stays out of that trial's log."""
    from maggy_tpu_torch.core.executors import trial_executor

    class Reporter:
        def __init__(self):
            self.lines = []

        def log(self, line):
            self.lines.append(line)

    reporter = Reporter()
    trial_executor._install_print_tee()
    trial_executor._print_ship.reporter = reporter
    try:
        print("mine", 1)
        other = threading.Thread(target=print, args=("theirs",))
        other.start()
        other.join(5)
        print("to a file", file=open(os.devnull, "w"))
    finally:
        trial_executor._print_ship.reporter = None
    print("after")
    assert reporter.lines == ["mine 1"]


def train_plain(lr, units):
    return {"metric": 1.0 - (lr - 0.1) ** 2}


def test_profile_traces_each_trial_or_journals_a_skip_as_jax(tmp_path):
    """One runner: every trial traced (the port's torch.profiler trace and
    the JAX package's both in <trial>/tensorboard/), no skip.
    Then, with the process's profiler held by a capture, every port trial
    runs untraced and journals profile_skipped."""
    traced = {}
    for pkg, pattern in (("port", "tensorboard/*.pt.trace.json"),
                         ("jax", "tensorboard/plugins/profile/*")):
        result, exp_dir = _sweep(pkg, str(tmp_path / pkg), trials=2, workers=1,
                                 train_fn=train_plain, profile=True)
        assert result["num_trials"] == 2
        traced[pkg] = len(glob.glob(os.path.join(exp_dir, "*", pattern)))
        events = (read_events if pkg == "port" else jax_read_events)(
            os.path.join(exp_dir, "telemetry.jsonl"))
        assert not [e for e in events if e.get("phase") == "profile_skipped"], pkg
    assert traced["port"] == traced["jax"] == 2
    with open(glob.glob(str(tmp_path / "port" / "*" / "*" / "tensorboard" / "*.pt.trace.json"))[0]) \
            as f:
        assert json.load(f)["traceEvents"]
    with profiling._CAPTURE_LOCK:
        result, exp_dir = _sweep("port", str(tmp_path / "busy"), trials=2, workers=1,
                                 train_fn=train_plain, profile=True)
    skipped = [e for e in read_events(os.path.join(exp_dir, "telemetry.jsonl"))
               if e.get("phase") == "profile_skipped"]
    assert result["num_trials"] == 2 and len(skipped) == 2
    assert not glob.glob(os.path.join(exp_dir, "*", "tensorboard", "*.pt.trace.json"))
    assert OptimizationConfig().profile is JaxConfig().profile is False
