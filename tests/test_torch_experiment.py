"""The port's control plane: whole ASHA, TPE and GP + Hyperband sweeps with
JAX, scikit-learn and the JAX package unimportable, the import boundary by
AST, schedule parity of the port's ASHA and RandomSearch with maggy_tpu's,
and a one-runner TPE sweep giving the JAX package's parameter sequence."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from maggy_tpu import experiment as jax_experiment
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.optimizers import Asha as JaxAsha
from maggy_tpu.optimizers import RandomSearch as JaxRandomSearch
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
import socket

import torch

from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.core.rpc import MessageSocket
from maggy_tpu_torch.exceptions import (AuthenticationError, BroadcastMetricTypeError,
                                        EarlyStopException)
from maggy_tpu_torch import OptimizationConfig, experiment
from maggy_tpu_torch.optimizers import Asha, RandomSearch
from maggy_tpu_torch.searchspace import Searchspace

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "sklearn", "maggy_tpu")

_SWEEP = textwrap.dedent("""
    import importlib.abc, importlib.machinery, json, os, sys, tempfile

    BANNED = {banned!r}

    class Refuse(importlib.abc.Loader):
        def create_module(self, spec):
            raise ImportError("blocked import: " + spec.name)

        def exec_module(self, module):
            pass

    class Block(importlib.abc.MetaPathFinder):
        # An origin-less spec whose loader refuses: importing fails, while a
        # find_spec probe (torch._dynamo's for sklearn) sees no module file,
        # as on a machine where the package is not installed.
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                return importlib.machinery.ModuleSpec(name, Refuse())
            return None

    sys.meta_path.insert(0, Block())
    for name in list(sys.modules):
        if name.split(".")[0] in BANNED:
            del sys.modules[name]
    sys.path.insert(0, {root!r})

    import numpy as np
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.models import BertConfig, BertEncoder
    from maggy_tpu_torch.optimizers import Asha
    from maggy_tpu_torch.optimizers.bayes import GP, TPE
    from maggy_tpu_torch.train import (Trainer, adamw, cross_entropy_loss,
                                       warmup_cosine_decay_schedule)

    cfg = BertConfig.tiny()
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, cfg.vocab_size, (64, 128))
    mask = np.arange(128)[None] < rng.integers(16, 129, 64)[:, None]
    labels = ((tokens > cfg.vocab_size // 2) & mask).sum(1) * 2 > mask.sum(1)

    def train(lr, warmup_frac, reporter, budget=1, batch=8, steps_per_budget=3):
        steps = int(budget) * steps_per_budget
        sched = warmup_cosine_decay_schedule(0.0, lr, int(steps * warmup_frac), steps)
        t = Trainer(BertEncoder(cfg, device="cpu"), adamw(sched),
                    lambda lo, b: cross_entropy_loss(lo, b["labels"]),
                    device="cpu").init(seed=0)
        for i in range(steps):
            lo = (i * batch) % (64 - batch)
            loss = t.step(t.place_batch({{"inputs": (tokens[lo:lo + batch], mask[lo:lo + batch]),
                                          "labels": labels[lo:lo + batch]}}))
            reporter.broadcast(-loss, step=i)
        return {{"metric": -float(loss)}}

    def sweep(name, optimizer, num_trials, space, fn=train):
        exp_dir = tempfile.mkdtemp()
        result = experiment.lagom(fn, OptimizationConfig(
            name=name, num_trials=num_trials, optimizer=optimizer, searchspace=space,
            direction="max", num_workers=2, es_policy="median", es_min=2, hb_interval=0.05,
            seed=0, experiment_dir=exp_dir))
        trials = []
        for run in os.listdir(exp_dir):
            for entry in os.listdir(os.path.join(exp_dir, run)):
                p = os.path.join(exp_dir, run, entry, "trial.json")
                if os.path.exists(p):
                    trials.append(json.load(open(p)))
        return {{"result": result, "trials": trials}}

    sp = Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))
    bo_sp = Searchspace(lr=("DOUBLE", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]),
                        batch=("DISCRETE", [4, 8]))
    out = {{"asha": sweep("blocked_imports", Asha(2, 1, 4, seed=0), 6, sp),
            "tpe": sweep("blocked_tpe", TPE(num_warmup_trials=3, seed=0), 14, bo_sp,
                         lambda reporter, **p: train(reporter=reporter, steps_per_budget=2, **p)),
            "gp": sweep("blocked_gp", GP(num_warmup_trials=3, seed=0, pruner="hyperband",
                                         pruner_kwargs=dict(min_budget=1, max_budget=9, eta=3,
                                                            n_iterations=1)), 1, bo_sp,
                        lambda reporter, **p: train(reporter=reporter, steps_per_budget=1, **p))}}
    out["leaked"] = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    print(json.dumps(out))
""")


@pytest.mark.timeout(300)
def test_sweep_runs_with_jax_and_maggy_tpu_blocked():
    script = _SWEEP.format(banned=BANNED, root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=280, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    result, trials = out["asha"]["result"], out["asha"]["trials"]
    assert set(result) >= {"best_id", "best_val", "best_hp", "worst_val", "avg",
                           "num_trials", "early_stopped", "pipeline"}
    assert set(result["best_hp"]) == {"lr", "warmup_frac"}
    assert np.isfinite(result["best_val"])
    # 6 rung-0 samples, then promotions up the rf=2 ladder (budgets 1, 2, 4).
    rung0 = [t for t in trials if t["info_dict"].get("rung", 0) == 0]
    promoted = [t for t in trials if t["info_dict"].get("sample_type") == "promoted"]
    assert len(rung0) == 6 and len(promoted) >= 2
    assert max(t["params"]["budget"] for t in trials) == 4
    assert result["num_trials"] == len(trials)
    assert all(t["status"] == "FINALIZED" for t in trials)
    assert result["early_stopped"] == sum(t["early_stop"] for t in trials)
    # TPE over the BERT example's space: every trial finalized, and the KDEs
    # proposed once 2(d+1) = 8 trials had finalized.
    result, trials = out["tpe"]["result"], out["tpe"]["trials"]
    assert result["num_trials"] == len(trials) == 14
    assert set(result["best_hp"]) == {"lr", "warmup_frac", "batch"}
    assert any(t["info_dict"]["sample_type"] == "model" for t in trials)
    assert result["pipeline"]["prefetch_hits"] > 0
    assert "rpc-server" not in result["pipeline"]["suggest_threads"]
    # GP + Hyperband(1, 9, 3, one bracket): 9 + 3 + 1 trials at budgets 1, 3, 9.
    result, trials = out["gp"]["result"], out["gp"]["trials"]
    budgets = sorted(t["params"]["budget"] for t in trials)
    assert result["num_trials"] == len(trials) == 13
    assert budgets == [1] * 9 + [3] * 3 + [9]
    assert sum(t["info_dict"]["sample_type"] == "promoted" for t in trials) == 4
    assert "rpc-server" not in result["pipeline"]["suggest_threads"]


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_maggy_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "maggy_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    offenders = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f)) & set(BANNED))
                 for f in files}
    assert {f: r for f, r in offenders.items() if r} == {}


def _simulate(opt, initialize, num_trials, workers=2):
    """Drive an optimizer like the driver does, deterministically: up to
    ``workers`` trials in flight, the oldest finalizing first with a
    closed-form metric. Returns the suggested params in order."""
    opt.num_trials = num_trials
    opt.direction = "max"
    initialize()
    order, in_flight, last = [], [], None
    while True:
        while len(in_flight) < workers:
            suggestion = opt.get_suggestion(last)
            last = None
            if suggestion in (None, "IDLE"):
                break
            opt.trial_store[suggestion.trial_id] = suggestion
            in_flight.append(suggestion)
            order.append(dict(suggestion.params))
        if not in_flight:
            return order
        trial = in_flight.pop(0)
        p = trial.params
        trial.final_metric = -(np.log10(p["lr"]) + 3.5) ** 2 - p["warmup_frac"] \
            + 0.05 * p.get("budget", 1)
        opt.trial_store.pop(trial.trial_id)
        opt.final_store.append(trial)
        last = trial


SPACE = dict(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))


@pytest.mark.parametrize("kind", ["asha", "randomsearch"])
def test_schedule_parity_with_maggy_tpu(kind):
    if kind == "asha":
        ours, ref = Asha(3, 1, 9, seed=0), JaxAsha(3, 1, 9, seed=0)
        n = 9
    else:
        ours, ref = RandomSearch(seed=7), JaxRandomSearch(seed=7)
        n = 8
    ours.searchspace = Searchspace(**SPACE)
    ref.searchspace = JaxSearchspace(**SPACE)
    ours_order = _simulate(ours, ours.initialize, n)
    ref_order = _simulate(ref, ref._initialize, n)
    assert ours_order == ref_order
    if kind == "asha":
        assert len(ours_order) == 13  # 9 + 3 promoted to rung 1 + 1 to rung 2
        assert max(p["budget"] for p in ours_order) == 9


def _closed_form(lr, warmup_frac, batch, reporter):
    reporter.broadcast(lr, step=0)
    return {"metric": -(np.log10(lr) + 3.5) ** 2 - warmup_frac + 0.01 * (batch == 64)}


def _param_sequence(exp_dir):
    trials = []
    for run in os.listdir(exp_dir):
        for entry in os.listdir(os.path.join(exp_dir, run)):
            path = os.path.join(exp_dir, run, entry, "trial.json")
            if os.path.exists(path):
                trials.append(json.load(open(path)))
    trials.sort(key=lambda t: t["info_dict"]["sampling_time"])
    return [(t["params"], t["info_dict"]["sample_type"]) for t in trials]


@pytest.mark.timeout(120)
def test_one_runner_tpe_sweep_gives_maggy_tpus_parameter_sequence(tmp_path):
    """The whole sweep through both packages' lagom, one runner, the same
    seed: the same parameters in the same order. With prefetch off, each
    suggestion sees every earlier trial finalized in both packages; with it
    on, how many a prefetched suggestion sees depends on thread timing."""
    from maggy_tpu.optimizers.bayes import TPE as JaxTPE
    from maggy_tpu_torch.optimizers.bayes import TPE

    space = dict(lr=("DOUBLE", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]),
                 batch=("DISCRETE", [32, 64]))
    kw = dict(name="tpe_parity", num_trials=14, direction="max", num_workers=1,
              es_policy="none", hb_interval=0.05, seed=0, prefetch=False)
    experiment.lagom(_closed_form, OptimizationConfig(
        optimizer=TPE(num_warmup_trials=4, seed=0), searchspace=Searchspace(**space),
        experiment_dir=str(tmp_path / "port"), **kw))
    jax_experiment.lagom(_closed_form, JaxConfig(
        optimizer=JaxTPE(num_warmup_trials=4, seed=0), searchspace=JaxSearchspace(**space),
        experiment_dir=str(tmp_path / "jax"), **kw))
    ours, ref = _param_sequence(str(tmp_path / "port")), _param_sequence(str(tmp_path / "jax"))
    assert len(ours) == 14 and sum(s == "model" for _, s in ours) >= 2
    assert ours == ref


def test_reporter_keeps_tensor_metrics_lazy_and_stops_on_flag():
    rep = Reporter()
    rep.reset(trial_id="t1")
    loss = torch.tensor(0.25)
    rep.broadcast(loss, step=0)
    assert rep.metric is loss  # stored as given: no host sync in the training thread
    assert rep.get_data()["metric"] == 0.25
    with pytest.raises(BroadcastMetricTypeError):
        rep.broadcast(torch.tensor(True), step=1)
    with pytest.raises(BroadcastMetricTypeError):
        rep.broadcast(torch.ones(2), step=1)
    rep.early_stop(trial_id="other")  # a STOP about another trial is ignored
    rep.broadcast(torch.tensor(0.5), step=1)
    rep.early_stop(trial_id="t1")
    with pytest.raises(EarlyStopException) as e:
        rep.broadcast(torch.tensor(0.75), step=2)
    assert e.value.metric == 0.75


def test_frames_carry_json_and_reject_a_bad_hmac():
    a, b = socket.socketpair()
    try:
        MessageSocket.send_msg(a, {"type": "METRIC", "value": np.float32(1.5)}, b"k1")
        assert MessageSocket.recv_msg(b, b"k1") == {"type": "METRIC", "value": 1.5}
        MessageSocket.send_msg(a, {"type": "GET"}, b"k1")
        with pytest.raises(AuthenticationError):
            MessageSocket.recv_msg(b, b"k2")
    finally:
        a.close()
        b.close()
