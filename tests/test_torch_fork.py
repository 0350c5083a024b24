"""The port's checkpoint forking against the JAX package's: fork staging
(``fork_checkpoint``) on identical directory trees, the trial context and
the fresh-state rule, the driver's fork stamp, lineage edge, fork-source
check, parent-affinity hold and checkpoint GC, the controllers' GC lists,
BO's near-duplicate warm start (``fork_eps``) in TPE and GP, a graceful
preemption on a one-runner sweep through both packages, and orbax's rule
for a save at or below a staged fork step. Port-only: the executor's
downgrade of a fork whose source is gone (and no other), and the
``torch.save`` checkpointer (bitwise split-and-resume training of the
MNIST CNN, the template's device, retention and mismatches, the lock wait
recorded apart).

Control-plane decisions are compared exactly; GP proposals within 1e-4 in
the unit-cube transform (its regressor is the port's own); state round
trips bitwise."""

import copy
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
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.core.executors import context as jax_context
from maggy_tpu.optimizers import Asha as JaxAsha
from maggy_tpu.optimizers.bayes import GP as JaxGP
from maggy_tpu.optimizers.bayes import TPE as JaxTPE
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu.train import checkpoint as jax_ckpt
from maggy_tpu.trial import Trial as JaxTrial
from maggy_tpu_torch import constants
from maggy_tpu_torch.config import OptimizationConfig
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.core.executors import context as port_context
from maggy_tpu_torch.optimizers import Asha
from maggy_tpu_torch.optimizers.bayes import GP, TPE
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.train import checkpoint as port_ckpt
from maggy_tpu_torch.trial import Trial

from tests.test_torch_bayes import MIXED, objective, wire

# Each test bounded (a test that hangs fails alone instead of cutting the
# whole run); the tests that set their own, longer bound keep it.
pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

#: (checkpoint module, LocalEnv class) of each package.
PACKAGES = {"jax": (jax_ckpt, JaxLocalEnv), "port": (port_ckpt, LocalEnv)}


def write_ckpts(trial_dir, steps):
    for step in steps:
        d = os.path.join(trial_dir, "checkpoints", str(step))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "state.json"), "w") as f:
            json.dump({"step": step}, f)


def tree(path):
    """Sorted (relative path, bytes) of every file under ``path``."""
    out = []
    for root, _, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            with open(full, "rb") as f:
                out.append((os.path.relpath(full, path), f.read()))
    return sorted(out)


# ------------------------------------------------------------ fork staging


def _stages_latest(ck, env, exp):
    write_ckpts(os.path.join(exp, "parent"), [0, 1, 3])
    step = ck.fork_checkpoint(env, exp, "parent", os.path.join(exp, "child"))
    return [step, tree(os.path.join(exp, "child")), tree(os.path.join(exp, "parent"))]


def _step_and_idempotence(ck, env, exp):
    write_ckpts(os.path.join(exp, "parent"), [0, 1, 2])
    child = os.path.join(exp, "child")
    first = ck.fork_checkpoint(env, exp, "parent", child, step=1)
    with open(os.path.join(child, "checkpoints", "1", "extra"), "w") as f:
        f.write("x")  # a re-stage must not copy over it
    return [first, ck.fork_checkpoint(env, exp, "parent", child, step=1), tree(child)]


def _torn_env_copy_restaged(ck, env, exp):
    env.FAST_LOCAL_WRITES = False  # the environment-abstracted path
    write_ckpts(os.path.join(exp, "parent"), [2])
    child = os.path.join(exp, "child")
    os.makedirs(os.path.join(child, "checkpoints", "2"))  # torn: no file, no marker
    first = ck.fork_checkpoint(env, exp, "parent", child)
    with open(os.path.join(child, "checkpoints", "2", "probe"), "w") as f:
        f.write("x")  # marker present: no re-copy
    return [first, ck.fork_checkpoint(env, exp, "parent", child), tree(child),
            ck.latest_checkpoint_step(child)]


def _torn_local_copy_restaged(ck, env, exp):
    write_ckpts(os.path.join(exp, "parent"), [4])
    child = os.path.join(exp, "child")
    os.makedirs(os.path.join(child, "checkpoints", "4.fork_tmp"))  # a death mid-copy
    before = ck.latest_checkpoint_step(child)
    return [before, ck.fork_checkpoint(env, exp, "parent", child), tree(child)]


def _missing_parent(ck, env, exp):
    os.makedirs(exp)
    child = os.path.join(exp, "child")
    return [ck.fork_checkpoint(env, exp, "ghost", child),
            ck.fork_checkpoint(env, exp, "ghost", child, step=7), os.path.exists(child)]


def _latest_step_env(ck, env, exp):
    trial_dir = os.path.join(exp, "t")
    before = ck.latest_checkpoint_step_env(env, trial_dir)
    write_ckpts(trial_dir, [2, 5])
    os.makedirs(os.path.join(trial_dir, "checkpoints", ".fork_complete.9"))
    return [before, ck.latest_checkpoint_step_env(env, trial_dir),
            ck.latest_checkpoint_step(trial_dir)]


@pytest.mark.parametrize("scenario", [
    _stages_latest, _step_and_idempotence, _torn_env_copy_restaged, _torn_local_copy_restaged,
    _missing_parent, _latest_step_env], ids=lambda f: f.__name__.strip("_"))
def test_fork_checkpoint_matches_jax(tmp_path, scenario):
    got = {}
    for name, (ck, env_cls) in PACKAGES.items():
        base = str(tmp_path / name)
        got[name] = scenario(ck, env_cls(base_dir=base), os.path.join(base, "exp"))
    assert got["port"] == got["jax"]


# ------------------------------------------------------------ trial context


@pytest.mark.parametrize("info", [
    {}, {"resume_step": 3}, {"resume_step": 0}, {"parent": "abc"},
    {"forked_from": {"trial": "abc", "step": 3}}, {"resume_step": None, "parent": None},
    {"sample_type": "promoted", "rung": 1}], ids=str)
def test_info_needs_fresh_state_matches_jax(info):
    assert port_context.info_needs_fresh_state(info) == jax_context.info_needs_fresh_state(info)


CONTEXTS = [
    ({"lr": 0.1, "budget": 4}, {"run_budget": 4, "parent": "par", "sample_type": "promoted"}),
    ({"lr": 0.1, "budget": 0}, {}),
    ({"lr": 0.2, "budget": 2}, {"parent": "par", "forked_from": {"trial": "par", "step": 4},
                                "resume_step": 4}),
    ({"lr": 0.3}, {"resume_step": 7}),
]


@pytest.mark.parametrize("params,info", CONTEXTS, ids=range(len(CONTEXTS)))
def test_trial_context_matches_jax(tmp_path, params, info):
    """The properties, and stage_fork on identical trees (each package's
    environment singleton pointed at its own copy)."""
    seen = {}
    for name, module, sing, env_cls in (
            ("jax", jax_context, JaxEnvSing, JaxLocalEnv),
            ("port", port_context, EnvSing, LocalEnv)):
        exp = str(tmp_path / name / "exp")
        write_ckpts(os.path.join(exp, "par"), [0, 4])
        sing.set_instance(env_cls(base_dir=str(tmp_path / name)))
        try:
            ctx = module.TrialContext("child", os.path.join(exp, "child"), exp, params, info)
            seen[name] = [ctx.budget, ctx.parent_trial_id, ctx.forked_from, ctx.resume_step,
                          ctx.needs_fresh_state, ctx.stage_fork(),
                          tree(os.path.join(exp, "child"))]
            ctx.close()
        finally:
            sing.reset()
    assert seen["port"] == seen["jax"]


def test_trial_context_refuses_gangs(tmp_path):
    """Gangs are ported: a gang assignment's context carries the gang as
    the JAX context does, and a 1-chip trial's has none. (The name is kept
    from when the context refused gangs.)"""
    from maggy_tpu.core.executors.context import TrialContext as JaxContext

    info = {"gang": {"chips": [2, 3], "members": [2, 3], "leader": 2,
                     "mesh": {"data": 2}, "strategy": "dp"}, "partition": 3}
    port = port_context.TrialContext("t", str(tmp_path / "t"), str(tmp_path), {}, info)
    jax = JaxContext("t", str(tmp_path / "t"), str(tmp_path), {}, info)
    assert port.gang.to_dict() == jax.gang.to_dict()
    assert port.gang.size == 2 and port.gang.partition == 3
    assert port_context.TrialContext("t", str(tmp_path / "t"), str(tmp_path), {},
                                     {}).gang is None


# ------------------------------------------------------------ the driver


def drivers(tmp_path, fork=True):
    """A JAX and a port driver over the same config, each with its own
    experiment dir (stopped by the caller)."""
    common = dict(name="forkunit", num_trials=4, optimizer="randomsearch", direction="max",
                  num_workers=2, seed=5, es_policy="none", hb_loss_timeout=30.0, fork=fork)
    jax = JaxDriver(JaxConfig(searchspace=JaxSearchspace(lr=("DOUBLE", [0.0, 0.2])),
                              experiment_dir=str(tmp_path / "jax"), health=False, **common),
                    "forkunit", 0)
    port = OptimizationDriver(OptimizationConfig(
        searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2])),
        experiment_dir=str(tmp_path / "port"), **common), "forkunit", 0)
    return {"jax": (jax, JaxTrial), "port": (port, Trial)}


def stop_all(pair):
    for driver, _ in pair.values():
        driver.stop()


def trial_events(driver, trial_id=None):
    return [{k: v for k, v in ev.items() if k not in ("t", "span")}
            for ev in driver.telemetry.events()
            if ev.get("ev") == "trial" and (trial_id is None or ev.get("trial") == trial_id)]


STAMPS = {
    "checkpointed_parent": (True, [0, 1, 2], {"parent": "par", "rung": 1,
                                              "sample_type": "promoted"}),
    "fork_off": (False, [0], {"parent": "par"}),
    "parent_never_saved": (True, None, {"parent": "par"}),
    "already_stamped": (True, [0, 5], {"parent": "par",
                                       "forked_from": {"trial": "par", "step": 1}}),
    "no_parent": (True, [0, 5], {"sample_type": "random"}),
}


@pytest.mark.parametrize("case", sorted(STAMPS))
def test_stamp_fork_and_queued_edge_match_jax(tmp_path, case):
    fork, steps, info = STAMPS[case]
    pair = drivers(tmp_path, fork=fork)
    try:
        out = {}
        for name, (driver, trial_cls) in pair.items():
            if steps is not None:
                write_ckpts(os.path.join(driver.exp_dir, "par"), steps)
            trial = trial_cls({"lr": 0.1, "budget": 2}, info_dict=copy.deepcopy(info))
            driver._mint_span(trial)
            queued = [e for e in trial_events(driver, trial.trial_id) if e["phase"] == "queued"]
            out[name] = [trial.trial_id, {k: v for k, v in trial.info_dict.items() if k != "span"},
                         queued]
        assert out["port"] == out["jax"]
    finally:
        stop_all(pair)


@pytest.mark.parametrize("layout", ["gone", "staged_child_copy", "parent_original"])
def test_fork_source_check_matches_jax(tmp_path, layout):
    pair = drivers(tmp_path)
    try:
        out = {}
        for name, (driver, trial_cls) in pair.items():
            trial = trial_cls({"lr": 0.1, "budget": 2}, info_dict={
                "parent": "par", "forked_from": {"trial": "par", "step": 5}, "resume_step": 5})
            if layout == "staged_child_copy":
                write_ckpts(os.path.join(driver.exp_dir, trial.trial_id), [5])
            elif layout == "parent_original":
                write_ckpts(os.path.join(driver.exp_dir, "par"), [5])
            driver._verify_fork_source(trial, 0)
            driver._journal_fork_edge(trial, 0)
            driver._journal_fork_edge(trial, 1)  # once per span
            out[name] = [trial.info_dict, trial_events(driver)]
        assert out["port"] == out["jax"]
    finally:
        stop_all(pair)


def test_fork_gc_sweep_matches_jax_and_spares_live_trials(tmp_path):
    pair = drivers(tmp_path)
    try:
        out = {}
        for name, (driver, trial_cls) in pair.items():
            for tid in ("livet", "donet", "queued"):
                write_ckpts(os.path.join(driver.exp_dir, tid), [0])
            with driver._store_lock:
                driver._trial_store["livet"] = trial_cls({"lr": 0.11})
                driver._requeue.append("queued")
                driver._trial_store["queued"] = trial_cls({"lr": 0.12})
            driver.controller.fork_gc_eligible = lambda: ["livet", "donet", "queued", "absent"]
            for _ in range(2):  # a second sweep journals nothing new
                with driver._sched_lock:
                    driver._sweep_fork_gc()
                for t in threading.enumerate():
                    if t.name == "fork-gc":
                        t.join(10)
            out[name] = [sorted(tid for tid in ("livet", "donet", "queued") if os.path.isdir(
                             os.path.join(driver.exp_dir, tid, "checkpoints"))),
                         [(e["trial"], e["why"]) for e in driver.telemetry.events()
                          if e.get("ev") == "ckpt_gc"]]
        assert out["port"] == out["jax"] == [["livet", "queued"],
                                              [("donet", "no_schedulable_child")]]
    finally:
        stop_all(pair)


def test_parent_affinity_hold_matches_jax(tmp_path, monkeypatch):
    from maggy_tpu import constants as jax_constants

    pair = drivers(tmp_path)
    try:
        out = {}
        for name, (driver, trial_cls) in pair.items():
            mod = jax_constants if name == "jax" else constants
            monkeypatch.setattr(mod, "FORK_AFFINITY_HOLD_S", 0.5)
            driver.telemetry.trial_event("par", "running", partition=1)
            driver.telemetry.trial_event("par", "finalized", partition=1)
            for pid in (0, 1):
                driver.server.reservations.add({"partition_id": pid, "task_attempt": 0})
            held, expired = (trial_cls({"lr": lr, "budget": 2}, info_dict={
                "parent": "par", "forked_from": {"trial": "par", "step": 3}, "resume_step": 3})
                for lr in (0.1, 0.15))
            with driver._store_lock:
                driver._trial_store[held.trial_id] = held
                driver._trial_store[expired.trial_id] = expired
            seq = []
            with driver._sched_lock:
                seq.append(driver._maybe_hold_for_parent(held, 0))
                seq.append(driver._maybe_hold_for_parent(held, 1))  # the parent's runner
            seq.append(driver._pop_fork_hold(0))
            seq.append(driver._pop_fork_hold(1) is held)
            with driver._sched_lock:
                seq.append(driver._maybe_hold_for_parent(held, 0))  # held at most once
            monkeypatch.setattr(mod, "FORK_AFFINITY_HOLD_S", 0.0)
            with driver._sched_lock:
                seq.append(driver._maybe_hold_for_parent(expired, 0))
            time.sleep(0.01)
            seq.append(driver._pop_fork_hold(0) is expired)  # past its deadline
            out[name] = seq
        assert out["port"] == out["jax"] == [True, False, None, True, False, True, True]
    finally:
        stop_all(pair)


def test_preempt_partition_arms_the_trial(tmp_path):
    pair = drivers(tmp_path)
    try:
        out = {}
        for name, (driver, trial_cls) in pair.items():
            driver.server.reservations.add({"partition_id": 0, "task_attempt": 0})
            trial = trial_cls({"lr": 0.1})
            with driver._store_lock:
                driver._trial_store[trial.trial_id] = trial
            idle = driver.preempt_partition(0)
            driver.server.reservations.assign_trial(0, trial.trial_id)
            out[name] = [idle, driver.preempt_partition(0), trial.get_preempt(),
                         trial.get_early_stop(), trial_events(driver)]
            trial.reset_run_state()
            out[name].append([trial.get_preempt(), trial.get_early_stop()])
        # With eviction (the fleet's preemption) the partition is also
        # marked for release, in both packages.
        for name, (driver, _) in pair.items():
            driver.server.reservations.assign_trial(0, None)
            out[name].append([driver.preempt_partition(0, evict=True),
                              driver.server.reservations.evict_requested(0)])
        assert out["port"] == out["jax"]
        assert out["port"][-1] == [None, True]
    finally:
        stop_all(pair)


# ------------------------------------------------------- controllers' GC lists


def finalize(opt, trial, metric):
    trial.final_metric = metric
    trial.status = type(trial).FINALIZED
    opt.trial_store.pop(trial.trial_id, None)
    opt.final_store.append(trial)


def gc_stream(opt, space, num_trials, metric, workers=2):
    """Drive ``opt`` as the driver does (``workers`` in flight, the oldest
    finalizing first) and record, after each report, the finalized trial
    and ``fork_gc_eligible()``."""
    opt.searchspace, opt.num_trials, opt.direction = space, num_trials, "max"
    opt.trial_store, opt.final_store = {}, []
    opt._initialize()
    out, in_flight = [], []
    for _ in range(200):
        while len(in_flight) < workers:
            t = opt.suggest()
            if t in (None, "IDLE"):
                break
            opt.trial_store[t.trial_id] = t
            in_flight.append(t)
        if not in_flight:
            break
        t = in_flight.pop(0)
        finalize(opt, t, metric(t.params))
        opt.report(t)
        out.append((t.trial_id, t.info_dict.get("parent"), list(opt.fork_gc_eligible())))
    return out


def test_asha_fork_gc_lists_match_jax():
    def metric(p):
        return p["lr"] * p["budget"]

    ours = gc_stream(Asha(2, 1, 4, seed=1), Searchspace(lr=("DOUBLE", [0.0, 1.0])), 8, metric)
    ref = gc_stream(JaxAsha(2, 1, 4, seed=1), JaxSearchspace(lr=("DOUBLE", [0.0, 1.0])), 8,
                    metric)
    assert ours == ref
    assert any(eligible for _, _, eligible in ours)  # parents are retired on the way


# --------------------------------------------- BO near-duplicate warm starts


def fork_lockstep(opt, num_trials, workers=2):
    """test_torch_bayes.lockstep, recording each proposal's fork parent."""
    out, in_flight = [], []
    while True:
        while len(in_flight) < workers:
            t = opt.suggest()
            if t in (None, "IDLE"):
                break
            opt.trial_store[t.trial_id] = t
            in_flight.append(t)
            out.append((dict(t.params), t.info_dict["sample_type"], t.info_dict.get("parent"),
                        t.info_dict.get("near_duplicate")))
        if not in_flight:
            return out
        t = in_flight.pop(0)
        t.final_metric = objective(t.params)
        opt.trial_store.pop(t.trial_id)
        opt.final_store.append(t)
        opt.report(t)


@pytest.mark.parametrize("fork_eps", [0.4, 0.8])
def test_tpe_fork_eps_matches_jax(fork_eps):
    import warnings

    ours = fork_lockstep(wire(TPE(seed=0, num_warmup_trials=5, fork_eps=fork_eps),
                              Searchspace(**MIXED), 20), 20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = fork_lockstep(wire(JaxTPE(seed=0, num_warmup_trials=5, fork_eps=fork_eps),
                                 JaxSearchspace(**MIXED), 20), 20)
    assert ours == ref
    assert any(parent for _, _, parent, _ in ours)  # near-duplicates did fork


def test_gp_fork_eps_matches_jax():
    import warnings

    ours = fork_lockstep(wire(GP(seed=3, num_warmup_trials=5, fork_eps=0.8),
                              Searchspace(**MIXED), 14), 14)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's ConvergenceWarning on tiny fits
        ref = fork_lockstep(wire(JaxGP(seed=3, num_warmup_trials=5, fork_eps=0.8),
                                 JaxSearchspace(**MIXED), 14), 14)
    sp = Searchspace(**MIXED)
    assert [o[1:] for o in ours] == [o[1:] for o in ref]
    assert any(parent for _, _, parent, _ in ours)
    np.testing.assert_allclose(sp.transform_batch([o[0] for o in ours]),
                               sp.transform_batch([o[0] for o in ref]), rtol=0, atol=1e-4)


def test_warm_neighbor_proximity_and_weight_match_jax():
    rng = np.random.default_rng(4)
    ours, ref = (wire(cls(seed=0, fork_eps=0.3), space(**MIXED), 8)
                 for cls, space in ((TPE, Searchspace), (JaxTPE, JaxSearchspace)))
    for opt, trial_cls in ((ours, Trial), (ref, JaxTrial)):
        assert opt.warm_neighbor_proximity(rng.uniform(size=(3, 5))) is None  # nothing final
        for params in Searchspace(**MIXED).get_random_parameter_values(
                4, rng=np.random.default_rng(9)):
            t = trial_cls(params)
            t.final_metric = objective(params)
            opt.final_store.append(t)
    cand = rng.uniform(size=(64, 5))
    np.testing.assert_array_equal(ours.warm_neighbor_proximity(cand),
                                  ref.warm_neighbor_proximity(cand))
    assert ours.fork_discount_weight() == ref.fork_discount_weight() == 0.125


# ---------------------------------------- graceful preemption, both packages


def preempt_sweep(pkg, exp_dir, case):
    """A one-runner ASHA(2, 1, 2) sweep (two rung-0 trials of 4 steps, one
    promotion of 8) whose closed-form train function carries its value
    through its checkpoints. ``case`` "fork": the promotion is preempted
    after one step, before it saves; "own": the first trial saves at step 1
    and is preempted after it. Returns the victim's journal chain and the
    trials' final metrics."""
    jax_side = pkg == "jax"
    holder, done = {}, threading.Event()

    def state(w, steps_done):
        if jax_side:
            return {"w": np.asarray(w, np.float64), "steps_done": np.asarray(steps_done, np.int64)}
        return {"w": torch.tensor(w, dtype=torch.float64), "steps_done": steps_done}

    def preempt_here(reporter, w, i):
        holder["victim"] = reporter.trial_id
        done.set()
        holder["driver"].preempt_partition(0)
        for j in range(i + 1, i + 400):  # each report may raise the STOP
            reporter.broadcast(w, step=j)
            time.sleep(0.02)
        raise RuntimeError("the preemption's STOP never arrived")

    def train(lr, budget, reporter, ctx):
        w, start = 0.0, 0
        if ctx.resume_step is not None:
            st = ctx.restore_checkpoint(state(0.0, 0))
            w, start = float(st["w"]), int(st["steps_done"])
        total = int(budget) * 4
        for i in range(start, total):
            w += lr
            reporter.broadcast(w, step=i)
            if case == "own" and i == 1 and not done.is_set():
                ctx.save_checkpoint(i, state(w, i + 1))
                preempt_here(reporter, w, i)
            if case == "fork" and ctx.forked_from and not done.is_set():
                preempt_here(reporter, w, i)
        ctx.save_checkpoint(total - 1, state(w, total))
        return w

    common = dict(name="preempt", num_trials=2, direction="max", num_workers=1, seed=3,
                  es_policy="none", hb_interval=0.02, experiment_dir=exp_dir)
    if jax_side:
        driver = JaxDriver(JaxConfig(optimizer=JaxAsha(2, 1, 2, seed=3), health=False,
                                     searchspace=JaxSearchspace(lr=("DOUBLE", [0.1, 0.2])),
                                     **common), "preempt", 0)
    else:
        driver = OptimizationDriver(OptimizationConfig(
            optimizer=Asha(2, 1, 2, seed=3), searchspace=Searchspace(lr=("DOUBLE", [0.1, 0.2])),
            **common), "preempt", 0)
    holder["driver"] = driver
    result = driver.run_experiment(train)
    keep = ("phase", "step", "checkpointed", "reason", "from_step", "requeue", "parent")
    chain = [{k: e[k] for k in keep if k in e} for e in driver.telemetry.events()
             if e.get("ev") == "trial" and e.get("trial") == holder["victim"]
             and e["phase"] in ("preempt_requested", "preempted", "requeued", "assigned",
                                "forked_from", "resumed", "finalized")]
    metrics, (run,) = {}, os.listdir(exp_dir)
    journal = os.path.join(exp_dir, run, "telemetry.jsonl")
    for run in os.listdir(exp_dir):
        for tid in os.listdir(os.path.join(exp_dir, run)):
            path = os.path.join(exp_dir, run, tid, "trial.json")
            if os.path.exists(path):
                with open(path) as f:
                    metrics[tid] = json.load(f)["final_metric"]
    return holder["victim"], chain, metrics, result.get("preemptions"), journal


@pytest.mark.timeout(120)
@pytest.mark.parametrize("case", ["fork", "own"])
def test_graceful_preemption_chain_matches_jax(tmp_path, case):
    *ours, journal = preempt_sweep("port", str(tmp_path / "port"), case)
    *ref, _ = preempt_sweep("jax", str(tmp_path / "jax"), case)
    victim, chain, metrics, preemptions = ours
    assert ours == ref
    # The port's journal read by both packages (derive's preempt block).
    derived = port_telemetry.derive(port_telemetry.read_events(journal))
    assert derived == jax_telemetry.derive(jax_telemetry.read_events(journal))
    assert derived["preempt"]["n"] == derived["preempt"]["resumed"] == 1
    assert preemptions == 1 and len(metrics) == 3
    phases = [e["phase"] for e in chain]
    assert phases[phases.index("preempt_requested"):] == [
        "preempt_requested", "preempted", "requeued", "assigned", "resumed", "finalized"]
    resumed = next(e for e in chain if e["phase"] == "resumed")
    assert resumed["from_step"] == (3 if case == "fork" else 1)


# ------------------------------------------------------------ port-only


@pytest.mark.timeout(120)
@pytest.mark.parametrize("staging", ["source_gone", "disk_full"])
def test_fork_staging_downgrades_only_a_missing_source(tmp_path, monkeypatch, staging):
    """A promotion whose parent checkpoint is gone runs from scratch; a
    copy that fails for another reason fails the trial instead of hiding
    the fault."""
    import errno

    def stage(*args, **kwargs):
        if staging == "source_gone":
            return None
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(port_ckpt, "fork_checkpoint", stage)
    seen = {}

    def train(lr, budget, reporter, ctx):
        seen[reporter.trial_id] = (ctx.parent_trial_id, ctx.resume_step)
        reporter.broadcast(lr * budget, step=0)
        ctx.save_checkpoint(int(budget) - 1, {"w": torch.tensor(lr * budget)})
        return lr * budget

    exp_dir = str(tmp_path / "exp")
    driver = OptimizationDriver(OptimizationConfig(
        name="stage", num_trials=2, optimizer=Asha(2, 1, 2, seed=3), direction="max",
        searchspace=Searchspace(lr=("DOUBLE", [0.1, 0.2])), num_workers=1, seed=3,
        es_policy="none", hb_interval=0.02, experiment_dir=exp_dir), "stage", 0)
    driver.run_experiment(train)
    (run,) = os.listdir(exp_dir)
    status = {}
    for tid in os.listdir(os.path.join(exp_dir, run)):
        path = os.path.join(exp_dir, run, tid, "trial.json")
        if os.path.exists(path):
            with open(path) as f:
                t = json.load(f)
            status[tid] = (t["status"], t["info_dict"].get("parent"))
    (promoted,) = [tid for tid, (_, parent) in status.items() if parent]
    forked = [e for e in driver.telemetry.events()
              if e.get("ev") == "trial" and e["phase"] == "forked_from"]
    assert [e["trial"] for e in forked] == [promoted]  # the driver stamped the fork
    if staging == "source_gone":
        assert status[promoted][0] == "FINALIZED"
        assert seen[promoted] == (status[promoted][1], None)  # from scratch
    else:
        assert status[promoted][0] == "ERROR" and promoted not in seen



def mnist_trainer():
    from maggy_tpu_torch.models import MnistCNN
    from maggy_tpu_torch.train import Trainer, adamw, cross_entropy_loss

    model = MnistCNN(kernel_size=3, pool_size=2, features=8, num_classes=2, image_size=16,
                     device="cpu")
    return Trainer(model, adamw(3e-3, weight_decay=0.05),
                   lambda lo, b: cross_entropy_loss(lo, b["labels"]), device="cpu").init(seed=0)


def mnist_batches(n):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 32, 16, 16, 1)).astype(np.float32)
    y = (X.mean(axis=(2, 3, 4)) > 0).astype(np.int64)
    return [{"inputs": (torch.from_numpy(X[i]),), "labels": torch.from_numpy(y[i])}
            for i in range(n)]


def trainer_state(t):
    return {"model": t.model.state_dict(), "optimizer": t.optimizer.state_dict(),
            "scheduler": t.scheduler.state_dict()}


def test_split_training_through_ctx_is_bitwise_straight_training(tmp_path):
    """10 straight AdamW steps of the MNIST CNN against 5 steps, a save
    through ctx, a restore into a freshly built trainer, and 5 more."""
    batches = mnist_batches(10)
    straight = mnist_trainer()
    for b in batches:
        straight.step(b)
    first = mnist_trainer()
    for b in batches[:5]:
        first.step(b)
    ctx = port_context.TrialContext("t", str(tmp_path / "t"), str(tmp_path), {})
    ctx.save_checkpoint(4, {**trainer_state(first), "steps_done": 5})
    ctx.close()
    resumed = mnist_trainer()
    ctx = port_context.TrialContext("t", str(tmp_path / "t"), str(tmp_path), {},
                                    {"resume_step": 4})
    st = ctx.restore_checkpoint({**trainer_state(resumed), "steps_done": 0})
    assert st["steps_done"] == ctx.resume_step + 1 == 5
    resumed.model.load_state_dict(st["model"])
    resumed.optimizer.load_state_dict(st["optimizer"])
    resumed.scheduler.load_state_dict(st["scheduler"])
    for b in batches[5:]:
        resumed.step(b)
    for (name, a), (_, b) in zip(straight.model.state_dict().items(),
                                 resumed.model.state_dict().items()):
        assert torch.equal(a, b), name
    for a, b in zip(straight.optimizer.state_dict()["state"].values(),
                    resumed.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_restore_follows_the_templates_device(tmp_path):
    ck = port_ckpt.TrialCheckpointer(str(tmp_path / "t"))
    ck.save(0, {"w": torch.arange(4.0), "n": 3, "extra": torch.ones(2)})
    meta = ck.restore({"w": torch.empty(4, device="meta")})
    assert meta["w"].device.type == meta["extra"].device.type == "meta" and meta["n"] == 3
    cpu = ck.restore({"w": torch.zeros(4)})
    assert torch.equal(cpu["w"], torch.arange(4.0)) and cpu["w"].device.type == "cpu"
    # No template tensor: each tensor comes back where it was saved.
    assert ck.restore({})["w"].device.type == "cpu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's slice_fork restores on the card")
    return torch.device("cuda")


def test_restore_keeps_a_card_checkpoint_on_the_card(tmp_path, cuda_device):
    ck = port_ckpt.TrialCheckpointer(str(tmp_path / "t"))
    ck.save(0, {"w": torch.arange(4.0, device=cuda_device)})
    out = ck.restore({"w": torch.zeros(4, device=cuda_device)})
    assert out["w"].is_cuda and torch.equal(out["w"].cpu(), torch.arange(4.0))


def test_checkpointer_keeps_newest_and_refuses_mismatches(tmp_path):
    """Retention by step, orbax's rule for a save that is not newer than
    the latest kept step (skipped), and the template checks."""
    ck = port_ckpt.TrialCheckpointer(str(tmp_path / "t"), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore({"w": torch.zeros(2)}) is None
    for step in (1, 3, 7):
        ck.save(step, {"w": torch.full((2,), float(step))})
    assert sorted(os.listdir(ck.path)) == ["3", "7"] and ck.latest_step() == 7
    ck.save(7, {"w": torch.full((2,), 8.0)})  # the same step is skipped
    assert torch.equal(ck.restore({"w": torch.zeros(2)})["w"], torch.full((2,), 7.0))
    assert torch.equal(ck.restore({"w": torch.zeros(2)}, step=3)["w"], torch.full((2,), 3.0))
    with pytest.raises(ValueError, match="template"):
        ck.restore({"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="template"):
        ck.restore({"w": torch.zeros(2, dtype=torch.float64)})
    with pytest.raises(ValueError, match="template"):
        ck.restore({"v": torch.zeros(2)})
    assert sorted(os.listdir(ck.path)) == ["3", "7"]  # no temporary dir is left
    # A save below the kept steps (a fork staged a parent's later step) is
    # skipped as well, and prunes nothing.
    ck.save(5, {"w": torch.full((2,), 5.0)})
    assert sorted(os.listdir(ck.path)) == ["3", "7"] and ck.latest_step() == 7
    ck.save(9, {"w": torch.full((2,), 9.0)})
    assert sorted(os.listdir(ck.path)) == ["7", "9"]
    assert port_ckpt.latest_checkpoint_step(str(tmp_path / "t")) == 9


@pytest.mark.parametrize("saves", [(2,), (3,), (2, 4)], ids=["below", "same", "below_then_above"])
def test_save_at_or_below_a_staged_fork_step_matches_jax(tmp_path, saves):
    """The layout of a PBT exploit whose donor is further along: the parent
    checkpointed step 3, the child stages it and then saves its own steps.
    Both packages skip a save that is not newer than step 3 and keep the
    parent's copy; a later save lands and prunes it (max_to_keep=1)."""
    out = {}
    for name, (ck, env_cls) in PACKAGES.items():
        exp = str(tmp_path / name)

        def state(v):
            return {"w": np.full((2,), v, np.float32)} if name == "jax" else \
                {"w": torch.full((2,), v)}

        parent = ck.TrialCheckpointer(os.path.join(exp, "parent"))
        parent.save(3, state(3.0))
        parent.close()
        child_dir = os.path.join(exp, "child")
        staged = ck.fork_checkpoint(env_cls(), exp, "parent", child_dir)
        child = ck.TrialCheckpointer(child_dir)
        for step in saves:
            child.save(step, state(float(10 + step)))
        template = {"w": np.zeros(2, np.float32)} if name == "jax" else {"w": torch.zeros(2)}
        w = child.restore(template)["w"]
        child.close()
        out[name] = [staged, ck.latest_checkpoint_step(child_dir),
                     sorted(n for n in os.listdir(os.path.join(child_dir, "checkpoints"))
                            if n.isdigit()), np.asarray(w).tolist()]
    assert out["port"] == out["jax"]
    assert out["port"][3] == ([14.0] * 2 if 4 in saves else [3.0] * 2)


def test_checkpoint_lock_wait_is_recorded_apart(tmp_path):
    """A save that waits for another runner's checkpoint call records the
    wait as save_lock_ms beside the whole save_ms."""
    from maggy_tpu_torch.telemetry.runnerstats import RunnerStats
    from maggy_tpu_torch.train import warm

    stats = RunnerStats()
    ctx = port_context.TrialContext("t", str(tmp_path / "t"), str(tmp_path), {})
    held = threading.Event()

    def other_runner():
        with port_ckpt._CKPT_LOCK:
            held.set()
            time.sleep(0.3)

    thread = threading.Thread(target=other_runner)
    thread.start()
    held.wait(10)
    stats.trial_start("t")
    with warm.trial_scope(trial_id="t", stats=stats):
        ctx.save_checkpoint(0, {"w": torch.zeros(2)})
        ctx.restore_checkpoint({"w": torch.zeros(2)})
    stats.trial_end("t")
    thread.join(10)
    assert not thread.is_alive()
    (record,) = stats.snapshot_delta()["ckpt_events"]
    assert record["saves"] == record["restores"] == 1
    assert 250.0 <= record["save_lock_ms"] <= record["save_ms"]
    assert 0.0 <= record["restore_lock_ms"] < 250.0
    assert port_ckpt.last_lock_wait_ms() == record["restore_lock_ms"]
