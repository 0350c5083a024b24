"""The port's control plane: a whole ASHA sweep with JAX and the JAX package
unimportable, the import boundary by AST, and schedule parity of the
port's ASHA and RandomSearch with maggy_tpu's."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from maggy_tpu.optimizers import Asha as JaxAsha
from maggy_tpu.optimizers import RandomSearch as JaxRandomSearch
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
import socket

import torch

from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.core.rpc import MessageSocket
from maggy_tpu_torch.exceptions import (AuthenticationError, BroadcastMetricTypeError,
                                        EarlyStopException)
from maggy_tpu_torch.optimizers import Asha, RandomSearch
from maggy_tpu_torch.searchspace import Searchspace

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "maggy_tpu")

_SWEEP = textwrap.dedent("""
    import importlib.abc, json, os, sys, tempfile

    BANNED = {banned!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError("blocked import: " + name)
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
    from maggy_tpu_torch.train import (Trainer, adamw, cross_entropy_loss,
                                       warmup_cosine_decay_schedule)

    cfg = BertConfig.tiny()
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, cfg.vocab_size, (64, 128))
    mask = np.arange(128)[None] < rng.integers(16, 129, 64)[:, None]
    labels = ((tokens > cfg.vocab_size // 2) & mask).sum(1) * 2 > mask.sum(1)

    def train(lr, warmup_frac, budget, reporter):
        steps = int(budget) * 3
        sched = warmup_cosine_decay_schedule(0.0, lr, int(steps * warmup_frac), steps)
        t = Trainer(BertEncoder(cfg, device="cpu"), adamw(sched),
                    lambda lo, b: cross_entropy_loss(lo, b["labels"]),
                    device="cpu").init(seed=0)
        for i in range(steps):
            lo = (i * 8) % 56
            loss = t.step(t.place_batch({{"inputs": (tokens[lo:lo + 8], mask[lo:lo + 8]),
                                          "labels": labels[lo:lo + 8]}}))
            reporter.broadcast(-loss, step=i)
        return {{"metric": -float(loss)}}

    exp_dir = tempfile.mkdtemp()
    sp = Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))
    result = experiment.lagom(train, OptimizationConfig(
        name="blocked_imports", num_trials=6, optimizer=Asha(2, 1, 4, seed=0),
        searchspace=sp, direction="max", num_workers=2, es_policy="median",
        es_min=2, hb_interval=0.05, seed=0, experiment_dir=exp_dir))
    trials = []
    for run in os.listdir(exp_dir):
        for entry in os.listdir(os.path.join(exp_dir, run)):
            p = os.path.join(exp_dir, run, entry, "trial.json")
            if os.path.exists(p):
                trials.append(json.load(open(p)))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    print(json.dumps({{"result": result, "trials": trials, "leaked": leaked}}))
""")


@pytest.mark.timeout(300)
def test_sweep_runs_with_jax_and_maggy_tpu_blocked():
    script = _SWEEP.format(banned=BANNED, root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=280, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    result, trials = out["result"], out["trials"]
    assert out["leaked"] == []
    assert set(result) >= {"best_id", "best_val", "best_hp", "worst_val", "avg",
                           "num_trials", "early_stopped"}
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
