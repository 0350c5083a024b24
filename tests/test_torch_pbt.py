"""The port's PBT against the JAX package's: validation, the schedule's size
and concurrency clamp, the exploit/continue segment sequence and the
checkpoint-GC lists driven in lockstep, a one-runner PBT sweep through both
packages whose closed-form train function carries its metric through its
checkpoints, a three-runner sweep in which an exploit forks a donor further
along, and the config fields still to port. Control-plane decisions
and parameters compare exactly."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import maggy_tpu.telemetry as jax_telemetry
import maggy_tpu_torch.telemetry as port_telemetry
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.core.driver.optimization_driver import OptimizationDriver as JaxDriver
from maggy_tpu.optimizers import PBT as JaxPBT
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu.telemetry import trace as jax_trace
from maggy_tpu.train import warm as jax_warm
from maggy_tpu_torch.config import OptimizationConfig
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
from maggy_tpu_torch.optimizers import PBT
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.telemetry import trace as port_trace
from maggy_tpu_torch.train import warm as port_warm

# Each test bounded (a test that hangs fails alone instead of cutting the
# whole run); the tests that set their own, longer bound keep it.
pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

SPACES = {
    "mixed": dict(lr=("DOUBLE", [0.001, 1.0]), units=("INTEGER", [8, 64]),
                  act=("CATEGORICAL", ["relu", "gelu"])),
    "pbt_sweep": dict(lr=("DOUBLE", [1e-4, 3e-2]), wd=("DOUBLE", [0.0, 0.1])),
    "categorical": dict(act=("CATEGORICAL", ["a", "b"]), opt=("DISCRETE", [1, 2, 3])),
}


def metric(p):
    """Deterministic, higher is better, touching every space's names."""
    return (p.get("lr", 0.0) - p.get("wd", 0.0) + p.get("units", 0) / 640
            + {"relu": 0.0, "gelu": 0.02, "a": 0.0, "b": 0.1}.get(p.get("act"), 0.0)
            + p.get("opt", 0) / 10 + p["generation"] / 100)


def run_pbt(opt, space_cls, space, workers=2, error_at=()):
    """Drive ``opt`` as the driver does: up to ``workers`` segments in
    flight, the oldest finalizing first (the ones listed in ``error_at``,
    by suggestion index, as errors). Returns per finalized segment its
    (member, generation, parent, sample type, params, GC list)."""
    opt.searchspace, opt.num_trials, opt.direction = space_cls(**space), opt.schedule_size(), "max"
    opt.trial_store, opt.final_store = {}, []
    opt._initialize()
    out, in_flight, n = [], [], 0
    for _ in range(500):
        while len(in_flight) < workers:
            t = opt.suggest()
            if t in (None, "IDLE"):
                break
            opt.trial_store[t.trial_id] = t
            in_flight.append((n, t))
            n += 1
        if not in_flight:
            break
        k, t = in_flight.pop(0)
        t.final_metric = None if k in error_at else metric(t.params)
        t.status = "ERROR" if k in error_at else "FINALIZED"
        opt.trial_store.pop(t.trial_id)
        opt.final_store.append(t)
        opt.report(t)
        out.append((t.info_dict["member"], t.info_dict["generation"], t.info_dict.get("parent"),
                    t.info_dict["sample_type"], dict(t.params), list(opt.fork_gc_eligible())))
    return out


CASES = {
    "mixed_seed0": (dict(population=4, generations=3, seed=0), "mixed", 2, ()),
    "mixed_seed3_exploit": (dict(population=4, generations=4, exploit_quantile=0.25, seed=3),
                            "mixed", 2, ()),
    "pbt_sweep_space": (dict(population=6, generations=4, seed=0), "pbt_sweep", 3, ()),
    "categorical_resample": (dict(population=3, generations=3, seed=0,
                                  resample_probability=0.5), "categorical", 1, ()),
    "errored_segments": (dict(population=3, generations=3, seed=1), "mixed", 2, (1, 4, 7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pbt_schedule_and_gc_lists_match_jax(case):
    kwargs, space, workers, errors = CASES[case]
    ours = run_pbt(PBT(**kwargs), Searchspace, SPACES[space], workers, errors)
    ref = run_pbt(JaxPBT(**kwargs), JaxSearchspace, SPACES[space], workers, errors)
    assert ours == ref
    assert len(ours) >= kwargs["population"] * kwargs["generations"]
    if not errors:
        assert any(gc for *_, gc in ours)  # superseded segments are spent


def test_pbt_validation_and_sizes_match_jax():
    for kwargs, match in ((dict(population=1), "population"), (dict(generations=1), "generations"),
                          (dict(exploit_quantile=0.8), "exploit_quantile")):
        for cls in (PBT, JaxPBT):
            with pytest.raises(ValueError, match=match):
                cls(**kwargs)
    for p, g in ((6, 4), (2, 2), (8, 3)):
        ours, ref = PBT(population=p, generations=g), JaxPBT(population=p, generations=g)
        assert (ours.schedule_size(), ours.max_concurrency()) == \
            (ref.schedule_size(), ref.max_concurrency()) == (p * g, p)
    assert PBT.SYNTHETIC_PARAMS == JaxPBT.SYNTHETIC_PARAMS


def test_driver_sizes_the_schedule_and_clamps_the_pool(tmp_path):
    """num_trials = population x generations whatever the config says, and
    never more runners than members."""
    sizes = {}
    for name, cls, cfg, space in (("port", OptimizationDriver, OptimizationConfig, Searchspace),
                                  ("jax", JaxDriver, JaxConfig, JaxSearchspace)):
        extra = {"health": False} if name == "jax" else {}
        pbt = (PBT if name == "port" else JaxPBT)(population=3, generations=2, seed=0)
        driver = cls(cfg(name="pbt", num_trials=1, optimizer=pbt, num_workers=5, seed=0,
                         searchspace=space(**SPACES["pbt_sweep"]), es_policy="none",
                         experiment_dir=str(tmp_path / name), **extra), "pbt", 0)
        sizes[name] = (driver.num_trials, driver.num_executors)
        driver.stop()
    assert sizes["port"] == sizes["jax"] == (6, 3)


@pytest.mark.parametrize("field,value,item", [
    ("chips_per_budget", {1: 2}, "8"), ("fleet", object(), "9")])
def test_unported_config_fields_raise(field, value, item):
    with pytest.raises(NotImplementedError, match="item {}".format(item)):
        OptimizationConfig(**{field: value})


def test_fork_is_on_by_default_as_in_jax():
    assert OptimizationConfig().fork is JaxConfig().fork is True
    assert OptimizationConfig(fork=False).fork is False


# ---------------------------------------------- one-runner sweep, both packages


def pbt_sweep(pkg, exp_dir):
    """PBT(4 members, 3 generations, seed 0) on one runner; the train
    function adds a closed-form increment to the value restored from its
    parent's checkpoint and saves the sum as checkpoint ``generation``."""
    jax_side = pkg == "jax"
    fresh = {}

    def train(lr, wd, generation, member, budget, reporter, ctx):
        fresh[reporter.trial_id] = (jax_warm if jax_side else port_warm).fresh_state_only()
        v = 0.0
        if ctx.parent_trial_id is not None:
            template = {"v": np.zeros((), np.float64)} if jax_side else \
                {"v": torch.zeros((), dtype=torch.float64)}
            v = float(ctx.restore_parent(template)["v"])
        v += lr - wd + 0.001 * member
        reporter.broadcast(v, step=0)
        ctx.save_checkpoint(generation, {"v": np.asarray(v, np.float64)} if jax_side
                            else {"v": torch.tensor(v, dtype=torch.float64)})
        return v

    common = dict(name="pbt1", num_trials=12, direction="max", num_workers=1, seed=0,
                  es_policy="none", hb_interval=0.02, experiment_dir=exp_dir)
    if jax_side:
        driver = JaxDriver(JaxConfig(optimizer=JaxPBT(population=4, generations=3, seed=0),
                                     searchspace=JaxSearchspace(**SPACES["pbt_sweep"]),
                                     health=False, **common), "pbt1", 0)
    else:
        driver = OptimizationDriver(OptimizationConfig(
            optimizer=PBT(population=4, generations=3, seed=0),
            searchspace=Searchspace(**SPACES["pbt_sweep"]), **common), "pbt1", 0)
    result = driver.run_experiment(train)
    order = [e["trial"] for e in driver.telemetry.events()
             if e.get("ev") == "trial" and e["phase"] == "finalized"]
    forks = {e["trial"]: (e["parent"], e["step"]) for e in driver.telemetry.events()
             if e.get("ev") == "trial" and e["phase"] == "forked_from"}
    (run,) = os.listdir(exp_dir)
    seq = []
    for tid in order:
        with open(os.path.join(exp_dir, run, tid, "trial.json")) as f:
            t = json.load(f)
        info, p = t["info_dict"], t["params"]
        seq.append((tid, info["member"], info["generation"], info.get("parent"), p["lr"],
                    p["wd"], t["final_metric"], forks.get(tid), fresh[tid]))
    return seq, (result["best_id"], result["best_val"], result["best_hp"]), \
        os.path.join(exp_dir, run, "telemetry.jsonl")


@pytest.mark.timeout(120)
def test_one_runner_pbt_sweep_matches_jax(tmp_path):
    ours, best, journal = pbt_sweep("port", str(tmp_path / "port"))
    ref, ref_best, _ = pbt_sweep("jax", str(tmp_path / "jax"))
    assert ours == ref and best == ref_best
    assert sorted((m, g) for _, m, g, *_ in ours) == [(m, g) for m in range(4) for g in range(3)]
    # Every later segment forked from the parent PBT named, at the step the
    # parent saved (its generation); generation 0 runs from scratch.
    generation = {tid: g for tid, _, g, *_ in ours}
    for _, _, g, parent, *_, fork, fresh in ours:
        assert fork == ((parent, generation[parent]) if g else None)
        assert fresh == bool(g)  # a forked segment restores into fresh state
    # The port's journal of the forking sweep, read by both packages: the
    # fork block, the checkpoint records and GC, and the trace's fork flows.
    port_events, jax_events = port_telemetry.read_events(journal), \
        jax_telemetry.read_events(journal)
    derived = port_telemetry.derive(port_events)
    assert derived == jax_telemetry.derive(jax_events)
    assert derived["fork"]["forked"] == 8 and derived["fork"]["ckpt_gc"] > 0
    assert derived["goodput"]["buckets"]["ckpt_save"] > 0
    trace = port_trace.build_trace(port_events)
    assert trace == jax_trace.build_trace(jax_events)
    assert sum(e.get("name") == "fork-flow" and e["ph"] == "s" for e in trace["traceEvents"]) == 8


# ------------------------------------ three runners, an exploit of a donor ahead


def donor_ahead_sweep(pkg, exp_dir):
    """PBT(3 members, 3 generations, seed 0) on three runners. Member 0
    runs its whole chain while members 1 and 2 hold their generation-0
    segments, so member 1 finalizes last-ranked against member 0's
    generation-2 segment and exploits it: its generation-1 segment stages
    the donor's checkpoint step 2 and then saves its own step 1. Returns,
    by (member, generation), what each segment forked and what its own
    checkpoint holds after its save."""
    jax_side = pkg == "jax"
    chain_done, own = threading.Event(), {}

    def box(v):
        return {"v": np.asarray(v, np.float64)} if jax_side else \
            {"v": torch.tensor(v, dtype=torch.float64)}

    def train(lr, wd, generation, member, budget, reporter, ctx):
        v = 0.0
        if ctx.parent_trial_id is not None:
            v = float(ctx.restore_parent(box(0.0))["v"])
        v += 1.0 + lr - wd
        if member and not generation:
            chain_done.wait(60)
            time.sleep(1.5 * member)  # member 0's last FINAL lands first
        reporter.broadcast(v, step=0)
        ctx.save_checkpoint(generation, box(v))
        own[reporter.trial_id] = (ctx.checkpointer().latest_step(),
                                  float(ctx.restore_checkpoint(box(0.0))["v"]))
        if member == 0 and generation == 2:
            chain_done.set()
        return v

    common = dict(name="pbt3", num_trials=9, direction="max", num_workers=3, seed=0,
                  es_policy="none", hb_interval=0.02, experiment_dir=exp_dir)
    if jax_side:
        driver = JaxDriver(JaxConfig(optimizer=JaxPBT(population=3, generations=3, seed=0),
                                     searchspace=JaxSearchspace(**SPACES["pbt_sweep"]),
                                     health=False, **common), "pbt3", 0)
    else:
        driver = OptimizationDriver(OptimizationConfig(
            optimizer=PBT(population=3, generations=3, seed=0),
            searchspace=Searchspace(**SPACES["pbt_sweep"]), **common), "pbt3", 0)
    result = driver.run_experiment(train)
    forks = {e["trial"]: e["step"] for e in driver.telemetry.events()
             if e.get("ev") == "trial" and e["phase"] == "forked_from"}
    (run,) = os.listdir(exp_dir)
    trials = {}
    for tid in os.listdir(os.path.join(exp_dir, run)):
        path = os.path.join(exp_dir, run, tid, "trial.json")
        if os.path.exists(path):
            with open(path) as f:
                trials[tid] = json.load(f)
    key = {tid: (t["info_dict"]["member"], t["info_dict"]["generation"])
           for tid, t in trials.items()}
    return {key[tid]: (t["status"], t["info_dict"]["sample_type"],
                       key.get(t["info_dict"].get("parent")), forks.get(tid), own.get(tid),
                       t["final_metric"])
            for tid, t in trials.items()}, result["best_val"]


@pytest.mark.timeout(120)
def test_exploit_of_a_donor_ahead_keeps_the_donors_checkpoint_as_jax(tmp_path):
    """Both packages skip the exploiting segment's save below its staged
    step, so no segment errors and member 1's lineage continues from the
    donor's weights; the segments, forks and checkpoints are equal."""
    ours, best = donor_ahead_sweep("port", str(tmp_path / "port"))
    ref, ref_best = donor_ahead_sweep("jax", str(tmp_path / "jax"))
    assert ours == ref and best == ref_best
    assert sorted(ours) == [(m, g) for m in range(3) for g in range(3)]
    assert all(status == "FINALIZED" for status, *_ in ours.values())
    donor_v = ours[(0, 2)][4][1]
    # Member 1's exploit forks member 0's last segment at its step 2; its own
    # step-1 save is skipped, so its checkpoint is the donor's.
    assert ours[(1, 1)][1:5] == ("exploit", (0, 2), 2, (2, donor_v))
    # Its next segment forks that copy and restores the donor's weights.
    assert ours[(1, 2)][2:4] == ((1, 1), 2) and ours[(1, 2)][4][0] == 2
