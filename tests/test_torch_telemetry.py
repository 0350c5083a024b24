"""The port's telemetry against the JAX package's: the journal's pure
functions (read_events, derive, compute_goodput, build_trace) give exactly
the same output on the same journals; a port sweep's journal has the JAX
sweep's per-trial phase sequences and replays through the JAX package; the
journal's mechanics (buffer-only record, flusher-owned I/O, torn tail,
incremental flush, rotation) hold in both packages; the CLIs print the
same JSON; the runner-side stats never create a CUDA context or sync a
lazy metric; and Trainer.init lands in the running trial's record."""

import glob
import json
import os
import subprocess
import sys
import threading
import time
from collections import defaultdict

import pytest
import torch

import maggy_tpu.telemetry as jax_telemetry
from maggy_tpu import experiment as jax_experiment
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu.telemetry import goodput as jax_goodput
from maggy_tpu.telemetry import journal as jax_journal
from maggy_tpu.telemetry import trace as jax_trace

import maggy_tpu_torch.telemetry as port_telemetry
from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.core.environment import LocalEnv
from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.telemetry import goodput as port_goodput
from maggy_tpu_torch.telemetry import journal as port_journal
from maggy_tpu_torch.telemetry import trace as port_trace
from maggy_tpu_torch.telemetry import runnerstats
from maggy_tpu_torch.telemetry.runnerstats import RunnerStats
from maggy_tpu_torch.train import Trainer, adam, warm

import test_goodput
import test_trace

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-6
GRID = dict(units=("DISCRETE", [8, 16, 32]), act=("CATEGORICAL", ["relu", "tanh"]))


def _grid_train(units, act):
    """Closed form, no broadcast: no heartbeat timing enters the journal's
    phase sequences."""
    return {"metric": units / 32 + (act == "relu")}


def _grid_sweep(package, exp_dir, num_workers):
    """The GridSearch sweep (6 trials) through one package's lagom; returns
    its journal path."""
    kw = dict(name="grid_telemetry", num_trials=1, optimizer="gridsearch", direction="max",
              num_workers=num_workers, hb_interval=0.05, es_policy="none", seed=0,
              experiment_dir=exp_dir)
    if package == "jax":
        jax_experiment.lagom(_grid_train, JaxConfig(searchspace=JaxSearchspace(**GRID), **kw))
    else:
        experiment.lagom(_grid_train, OptimizationConfig(searchspace=Searchspace(**GRID), **kw))
    (journal,) = glob.glob(os.path.join(exp_dir, "*", "telemetry.jsonl"))
    return journal


def _phase_sequences(events):
    seq = defaultdict(list)
    for ev in events:
        if ev.get("ev") == "trial":
            seq[ev["trial"]].append(ev["phase"])
    return dict(seq)


def _assert_closure(gp):
    assert abs(sum(gp["buckets"].values()) - gp["held_chip_s"]) < EPS
    for pid, p in gp["per_partition"].items():
        assert abs(sum(p["buckets"].values()) - p["held_s"]) < EPS, pid


# ------------------------------------------------- pure functions, same input


def _synthetic_journals():
    """The JAX tests' hand-built journals: test_trace's two-partition
    journal and the geometries of test_goodput's fold tests."""
    reg, tev, end = test_goodput._reg, test_goodput._tev, test_goodput._end
    return {
        "trace_two_partitions": test_trace._journal(),
        "goodput_all_train": [reg(0.0, 0), tev(0.0, "t1", "running", partition=0),
                              tev(10.0, "t1", "finalized", partition=0), end(10.0)],
        "goodput_compile_ckpt": [
            reg(0.0, 0), tev(0.0, "t1", "running", partition=0),
            tev(2.0, "t1", "compiled", partition=0, init_ms=1000.0, trace_ms=500.0,
                compile_ms=1500.0),
            tev(5.0, "t1", "ckpt_saved", partition=0, save_ms=1000.0, restore_ms=500.0,
                saves=2, restores=1),
            tev(10.0, "t1", "finalized", partition=0), end(10.0)],
        "goodput_dead_attempt": [
            reg(0.0, 0), reg(0.0, 1), tev(1.0, "t1", "running", partition=0),
            tev(3.0, "t1", "lost", partition=0),
            tev(3.0, "t1", "requeued", partition=0, reason="heartbeat_loss"),
            tev(3.5, "t1", "running", partition=1), tev(6.0, "t1", "finalized", partition=1),
            end(6.0)],
        "goodput_scratch_promotion": [
            reg(0.0, 0), tev(0.0, "p", "running", partition=0),
            tev(4.0, "p", "finalized", partition=0), tev(4.0, "c", "queued", info={"parent": "p"}),
            tev(4.0, "c", "running", partition=0), tev(10.0, "c", "finalized", partition=0),
            end(10.0)],
        "goodput_gang": [
            reg(0.0, 0), reg(0.0, 1),
            tev(0.0, "g1", "gang_assembled", partition=0, members=[0, 1]),
            tev(0.0, "g1", "running", partition=0),
            tev(1.0, "g1", "compiled", partition=0, compile_ms=5000.0),
            tev(10.0, "g1", "finalized", partition=0),
            tev(10.0, "g1", "gang_released", partition=0), end(10.0)],
        "goodput_gaps": [
            reg(0.0, 0), tev(1.0, "t1", "running", partition=0),
            tev(4.0, "t1", "finalized", partition=0), tev(4.5, "t2", "running", partition=0),
            tev(6.0, "t2", "finalized", partition=0), tev(9.0, "t3", "running", partition=0),
            tev(10.0, "t3", "finalized", partition=0), end(11.0)],
        "goodput_assigned_never_running": [
            reg(0.0, 0), tev(1.0, "t1", "assigned", partition=0),
            tev(3.0, "t1", "lost", partition=0), end(5.0)],
    }


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """Journal files: a JAX-package sweep's (GridSearch, 2 thread runners,
    closed-form train_fn) and each synthetic journal written as JSONL."""
    root = tmp_path_factory.mktemp("journals")
    paths = {"jax_grid_sweep": _grid_sweep("jax", str(root / "sweep"), num_workers=2)}
    for name, events in _synthetic_journals().items():
        path = str(root / (name + ".jsonl"))
        with open(path, "w") as f:
            f.write("".join(json.dumps(e) + "\n" for e in events))
        paths[name] = path
    return paths


@pytest.mark.parametrize("name", ["jax_grid_sweep"] + sorted(_synthetic_journals()))
def test_pure_functions_equal_exactly(journals, name):
    ours = port_telemetry.read_events(journals[name])
    ref = jax_telemetry.read_events(journals[name])
    assert list(ours) == list(ref) and ours.torn_lines == ref.torn_lines == 0
    assert port_telemetry.derive(ours) == jax_telemetry.derive(ref)
    assert port_goodput.compute_goodput(ours) == jax_goodput.compute_goodput(ref)
    assert port_trace.build_trace(ours) == jax_trace.build_trace(ref)
    assert port_telemetry.replay_journal(journals[name]) == \
        jax_telemetry.replay_journal(journals[name])
    gp = port_goodput.compute_goodput(ours)
    if gp:
        _assert_closure(gp)
        assert port_goodput.render_goodput(gp) == jax_goodput.render_goodput(gp)


def test_sweep_journal_derives_the_schedule(journals):
    derived = port_telemetry.replay_journal(journals["jax_grid_sweep"])
    assert derived["trials"]["created"] == derived["trials"]["finalized"] == 6
    assert port_trace.validate_trace(port_trace.build_trace(
        port_telemetry.read_events(journals["jax_grid_sweep"]))) > 6


# ------------------------------------------ the port's journal, read by JAX


def test_port_journal_matches_jax_phase_sequences(tmp_path):
    """The one-runner GridSearch sweep through both packages: each trial's
    phase sequence (timestamps dropped) is the same, and the JAX package's
    replay reads the port's journal whole."""
    ours = _grid_sweep("port", str(tmp_path / "port"), num_workers=1)
    ref = _grid_sweep("jax", str(tmp_path / "jax"), num_workers=1)
    seq = _phase_sequences(port_telemetry.read_events(ours))
    assert seq == _phase_sequences(jax_telemetry.read_events(ref))
    assert len(seq) == 6
    for phases in seq.values():
        lifecycle = [p for p in phases if p in ("queued", "assigned", "running", "finalized")]
        assert lifecycle == ["queued", "assigned", "running", "finalized"]
    replay = jax_telemetry.replay_journal(ours)
    assert replay["torn_lines"] == 0
    assert replay["trials"]["created"] == replay["trials"]["finalized"] == 6
    _assert_closure(replay["goodput"])
    kinds = {e["ev"] for e in jax_telemetry.read_events(ours)}
    assert {"driver_epoch", "experiment", "runner", "suggest", "trial"} <= kinds


# --------------------------------------------------- the journal's mechanics


class _CountingEnv:
    """Wraps a package's LocalEnv, recording which thread made each write
    and how (full rewrite, or append)."""

    def __init__(self, env):
        self.env = env
        self.writes = []

    def dump(self, data, path):
        self.writes.append((threading.current_thread().name, "dump", path))
        self.env.dump(data, path)

    def open_file(self, path, mode="r"):
        if "a" in mode:
            self.writes.append((threading.current_thread().name, "append", path))
        return self.env.open_file(path, mode)

    def __getattr__(self, name):
        return getattr(self.env, name)


PACKAGES = {"jax": (jax_journal, JaxLocalEnv), "port": (port_journal, LocalEnv)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request, tmp_path):
    module, env_cls = PACKAGES[request.param]
    env = _CountingEnv(env_cls(base_dir=str(tmp_path)))
    return module, env, str(tmp_path / "j" / "telemetry.jsonl")


def _ev(i, pad=0):
    return {"t": float(i), "ev": "trial", "trial": "t{}".format(i), "phase": "queued",
            "pad": "x" * pad}


def test_journal_record_is_buffer_only(pkg):
    module, env, path = pkg
    journal = module.TelemetryJournal(env, path, flush_interval_s=3600)
    for i in range(50):
        journal.record(_ev(i))
    assert env.writes == [] and not os.path.exists(path)
    journal.flush()
    assert [e["trial"] for e in module.read_events(path)] == ["t{}".format(i) for i in range(50)]
    journal.close()


def test_journal_flusher_thread_owns_the_io(pkg):
    module, env, path = pkg
    journal = module.TelemetryJournal(env, path, flush_interval_s=0.05)
    journal.record(_ev(0))
    deadline = time.monotonic() + 5
    while not env.writes and time.monotonic() < deadline:
        time.sleep(0.01)
    journal.record(_ev(1))
    while len(env.writes) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(env.writes) >= 2
    assert {name for name, _, _ in env.writes} == {module.FLUSHER_THREAD_NAME}
    journal.close()
    assert len(module.read_events(path)) == 2


def test_journal_torn_tail_line_is_counted_and_skipped(pkg):
    module, env, path = pkg
    journal = module.TelemetryJournal(env, path, flush_interval_s=3600)
    for i in range(3):
        journal.record(_ev(i))
    journal.close()
    with open(path, "a") as f:
        f.write('{"t": 3.0, "ev": "tri')  # a hard kill mid-append
    events = module.read_events(path)
    assert [e["trial"] for e in events] == ["t0", "t1", "t2"]
    assert events.torn_lines == 1


def test_journal_flush_is_incremental(pkg):
    module, env, path = pkg
    env.dump('{"t": 0.0, "ev": "stale"}\n', path)  # an unrelated earlier run
    env.writes.clear()
    journal = module.TelemetryJournal(env, path, flush_interval_s=3600)
    journal.record(_ev(1))
    journal.flush()  # full rewrite: truncates the stale file
    journal.record(_ev(2))
    journal.flush()  # appends only the new event
    journal.flush()  # nothing new: no write
    journal.close()
    assert [op for _, op, _ in env.writes] == ["dump", "append"]
    assert [e["trial"] for e in module.read_events(path)] == ["t1", "t2"]


def test_journal_rotation_replays_continuously(pkg):
    module, env, path = pkg
    journal = module.TelemetryJournal(env, path, flush_interval_s=3600,
                                      max_mb=1024 / (1024 * 1024.0))
    for i in range(100):
        journal.record(_ev(i, pad=64))
        if i % 10 == 9:
            journal.flush()
    journal.close()
    segments = [f for f in os.listdir(os.path.dirname(path)) if f.startswith("telemetry.jsonl.")]
    assert len(segments) >= 2
    events = module.read_events(path)
    assert [e["trial"] for e in events] == ["t{}".format(i) for i in range(100)]
    assert events.torn_lines == 0


# ------------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def port_journal_path(tmp_path_factory):
    return _grid_sweep("port", str(tmp_path_factory.mktemp("cli") / "exp"), num_workers=2)


@pytest.mark.parametrize("command", [["replay"], ["goodput", "--json"], ["trace"]])
def test_cli_prints_what_the_jax_cli_prints(port_journal_path, tmp_path, command):
    outs = []
    for package in ("maggy_tpu_torch", "maggy_tpu"):
        args = [sys.executable, "-m", package + ".telemetry"] + command + [port_journal_path]
        trace_out = str(tmp_path / (package + ".json"))
        if command == ["trace"]:
            args += ["-o", trace_out]
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              timeout=100, env=env, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        if command == ["trace"]:
            with open(trace_out) as f:
                outs.append(json.load(f))
        else:
            outs.append(json.loads(proc.stdout))
    assert outs[0] == outs[1]
    if command == ["replay"]:
        assert outs[0]["torn_lines"] == 0 and outs[0]["trials"]["finalized"] == 6


def test_cli_refuses_a_fleet_home(tmp_path):
    """``replay`` reads an experiment journal, which a fleet home does not
    hold, and ``trace --unified`` needs a fleet home, as in the JAX package.
    A facade with no journal path ignores a sink binding. The fleet home's
    trace, goodput and unified trace: test_torch_fleet and
    test_torch_sink."""
    (tmp_path / "fleet.jsonl").write_text("")
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp" / "telemetry.jsonl").write_text("")
    from maggy_tpu.telemetry.__main__ import main as jax_main
    from maggy_tpu_torch.telemetry.__main__ import main

    with pytest.raises(FileNotFoundError, match="no telemetry journal"):
        main(["replay", str(tmp_path)])
    for cli in (main, jax_main):
        with pytest.raises(SystemExit, match="needs a fleet home"):
            cli(["trace", "--unified", str(tmp_path / "exp")])
    assert port_telemetry.Telemetry(sink=object()).journal is None


# ------------------------------------------------------------ runner stats


def test_runner_stats_never_create_a_cuda_context(monkeypatch):
    """The device probe reads memory only where a CUDA context already
    lives: a fresh RunnerStats snapshot leaves torch.cuda uninitialized
    and never calls memory_allocated without a context."""
    assert not torch.cuda.is_initialized()
    stats = RunnerStats(mem_interval_s=0.0)
    snap = stats.snapshot()
    assert not torch.cuda.is_initialized()
    assert "dev_mem_mb" not in snap and snap["rss_mb"] > 0

    def no_context(*a, **k):
        raise AssertionError("memory_allocated called without a CUDA context")

    monkeypatch.setattr(torch.cuda, "memory_allocated", no_context)
    assert runnerstats._device_mem_mb() is None
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 123_000_000)
    assert runnerstats._device_mem_mb() == 123.0
    assert RunnerStats(mem_interval_s=0.0).snapshot()["dev_mem_mb"] == 123.0


def test_broadcast_counts_without_materializing_the_metric(monkeypatch):
    """on_broadcast rides the user's step: the lazy tensor metric is never
    read back, and nothing synchronizes."""
    rep, stats = Reporter(), RunnerStats()
    rep.stats = stats
    rep.reset(trial_id="t1", span="s1")
    stats.trial_start("t1")

    def forbidden(*a, **k):
        raise AssertionError("the broadcast read the metric back")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "item", forbidden)
        m.setattr(torch.Tensor, "__float__", forbidden)
        m.setattr(torch.cuda, "synchronize", forbidden)
        for step in range(3):
            rep.broadcast(torch.tensor(0.5 * step), step=step)
    snap = stats.snapshot()
    assert snap["steps"] == 3 and snap["ttfm_ms"] is not None and "cadence_ms" in snap
    data = rep.get_data()
    assert data["span"] == "s1" and data["metric"] == 1.0


def test_trainer_init_lands_in_the_trial_record():
    """Trainer.init inside the trial scope notes init_ms (no trace or
    compile phase in eager PyTorch); the first broadcast closes ttfm and
    the record ships once, at trial end."""
    from maggy_tpu_torch.models import MnistCNN

    stats = RunnerStats()
    stats.trial_start("t1")
    with warm.trial_scope(trial_id="t1", stats=stats):
        model = MnistCNN(kernel_size=3, pool_size=2, features=4, num_classes=2,
                         image_size=8, device="cpu")
        Trainer(model, adam(1e-3), lambda out, b: out.sum(), device="cpu").init(seed=0)
        assert warm.current_scope().trial_id == "t1"
        stats.on_broadcast(0)
    assert warm.current_scope() is None
    warm.note_compile(init_ms=5.0)  # outside a scope: dropped
    stats.trial_end("t1")
    (record,) = stats.snapshot_delta()["compile_events"]
    assert record["trial"] == "t1" and record["warm"] is False
    assert record["init_ms"] > 0 and record["first_step_ms"] >= 0
    assert "trace_ms" not in record and "compile_ms" not in record
    assert "compile_events" not in stats.snapshot_delta()  # shipped once


def test_runner_stats_match_jax_on_the_same_calls(monkeypatch):
    """The port's RunnerStats is the JAX package's with another device
    probe: the same calls give the same delta-encoded ships."""
    from maggy_tpu.telemetry import runnerstats as jax_runnerstats

    fixed = {"t": 0.0}

    def fake_monotonic():
        return fixed["t"]

    out = []
    for module in (runnerstats, jax_runnerstats):
        fixed["t"] = 0.0
        monkeypatch.setattr(module.time, "monotonic", fake_monotonic)
        monkeypatch.setattr(module, "_rss_mb", lambda: 100.0)
        monkeypatch.setattr(module, "_device_mem_mb", lambda: None)
        stats = module.RunnerStats(mem_interval_s=0.0)
        ships = []
        stats.trial_start("a")
        stats.note_compile(warm=False, init_ms=3.0)
        for step in range(4):
            fixed["t"] += 0.01
            stats.on_broadcast(step)
            ships.append(stats.snapshot_delta())
        stats.observe_hb_rtt(2.0)
        stats.trial_end("a")
        ships.append(stats.snapshot_delta())
        out.append(ships)
    assert out[0] == out[1]
