"""The port's vectorized lanes on the CPU, against maggy_tpu.

Counterparts of ``tests/test_vmap.py``. The engine (``train/vmap.py``): a
K-lane ``VmapTrainer`` block trains each lane as the JAX package's
``VmapTrainer`` does and as the port's own scalar ``Trainer`` does (within
fp32 tolerances: a vmapped product is a batched kernel, so lanes are not
bitwise the scalar runs; ROADMAP queue 3 item 3), while masking a lane, and
re-initializing a block from the retired K-lane unit, move nothing by a bit.
The flash kernels' batching rules (``ops/attention.py``, plain versions on
the CPU) against a per-lane loop, one call a wrapper for all lanes. The
driver: block admission and compatibility, ASHA's rung drain and BO's fork
discount against the JAX package; seeded sweeps with ``vmap_lanes=4``
through both packages' ``lagom`` (lane-tagged edges, per-lane FINALs, the
goodput's ``lane_idle`` split), the scalar-only fallback, ``vmap_lanes=1``
as the scalar schedule, a lost block leader, and a resume with a block in
flight. The CUDA-graph half runs in ``chip_smoke.py``'s ``slice_lanes``.
"""

import glob
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maggy_tpu import experiment as jax_experiment
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.core.driver.optimization_driver import OptimizationDriver as JaxDriver
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.models import MnistMLP as JaxMnistMLP
from maggy_tpu.optimizers import Asha as JaxAsha
from maggy_tpu.optimizers.bayes import TPE as JaxTPE
from maggy_tpu.parallel import make_mesh
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu.telemetry.goodput import compute_goodput as jax_compute_goodput
from maggy_tpu.train import VmapTrainer as JaxVmapTrainer
from maggy_tpu.train import clear_warm as jax_clear_warm
from maggy_tpu.train import cross_entropy_loss as jax_xent
from maggy_tpu.trial import Trial as JaxTrial

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.models import BertConfig, BertEncoder, MnistMLP, ResNet
from maggy_tpu_torch.models.mnist_cnn import flax_to_state_dict
from maggy_tpu_torch.ops import attention
from maggy_tpu_torch.optimizers import Asha
from maggy_tpu_torch.optimizers.bayes import TPE
from maggy_tpu_torch.telemetry.goodput import compute_goodput
from maggy_tpu_torch.train import (Trainer, adam, adamw, clear_warm, cross_entropy_loss,
                                   swept_transform, warm)
from maggy_tpu_torch.train.vmap import VmapTrainer
from maggy_tpu_torch.trial import Trial

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

STEPS = 6
LRS = [1e-3, 3e-3, 1e-2, 3e-2]
RNG = np.random.RandomState(0)
X = RNG.rand(32, 16, 16, 1).astype("float32")
Y = (X.mean(axis=(1, 2, 3)) > 0.5).astype("int32")
BATCH = {"inputs": (torch.from_numpy(X),), "labels": torch.from_numpy(Y).long()}
#: fp32 on both sides, sums in another order (tests/test_torch_warm.py's).
REL, ABS = 1e-5, 1e-6


def loss_fn(logits, batch):
    return cross_entropy_loss(logits, batch["labels"])


def mlp(device="meta"):
    return MnistMLP(features=8, num_classes=2, image_size=16, device=device)


@pytest.fixture(autouse=True)
def fresh_cache():
    clear_warm()
    yield
    clear_warm()


@pytest.fixture(scope="module")
def jax_block():
    """The JAX package's block over LRS (its lanes' losses, STEPS steps) and
    the Flax weights every lane started from, as the port's state dict."""
    jax_clear_warm()
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    vt = JaxVmapTrainer(JaxMnistMLP(features=8, num_classes=2), optax.adam,
                        [{"learning_rate": lr} for lr in LRS],
                        lambda logits, b: jax_xent(logits, b["labels"]), mesh, strategy="dp")
    vt.init(jax.random.key(0), (jnp.asarray(X[:1]),))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), vt.variables["params"])
    batch = {"inputs": (jnp.asarray(X),), "labels": jnp.asarray(Y)}
    losses = np.stack([np.asarray(vt.step(batch)) for _ in range(STEPS)])
    jax_clear_warm()
    return losses, flax_to_state_dict(params)


def block(lrs=LRS, state=None, **kw):
    return VmapTrainer(mlp(), adam, [{"learning_rate": lr} for lr in lrs], loss_fn,
                       device="cpu", **kw).init(seed=0, state_dict=state)


def run_block(vt, steps=STEPS, mask_at=None, lane=1):
    out = []
    for t in range(steps):
        if t == mask_at:
            vt.mask_lane(lane)
        out.append(vt.step(BATCH).numpy().copy())
    return np.stack(out)


def scalar_run(lr, state=None, steps=STEPS):
    trainer = Trainer(mlp(), swept_transform(adam, learning_rate=lr), loss_fn,
                      device="cpu", warm_start=False).init(seed=0, state_dict=state)
    return np.asarray([float(trainer.step(BATCH)) for _ in range(steps)])


# ------------------------------------------------------------------ engine


def test_lanes_match_the_jax_vmap_trainer(jax_block):
    """4 learning rates, 6 steps, from the same Flax weights: each lane's
    losses within fp32 tolerance of the JAX package's lane."""
    jlosses, state = jax_block
    losses = run_block(block(state=state))
    np.testing.assert_allclose(losses, jlosses, rtol=REL, atol=ABS)


def test_each_lane_matches_the_port_scalar_trainer(jax_block):
    _, state = jax_block
    losses = run_block(block(state=state))
    for i, lr in enumerate(LRS):
        np.testing.assert_allclose(losses[:, i], scalar_run(lr, state), rtol=REL, atol=ABS)
    assert not np.array_equal(losses[:, 0], losses[:, 3])  # the rates differ


def test_masked_lane_survivors_are_bitwise_unchanged():
    full = run_block(block())
    masked_vt = block()
    masked = run_block(masked_vt, mask_at=2)
    for i in (0, 2, 3):
        assert np.array_equal(masked[:, i], full[:, i])
    assert masked_vt.active_lanes() == [0, 2, 3]


def test_refilled_lane_matches_a_scalar_cold_run():
    vt = block()
    run_block(vt, steps=3, mask_at=1)
    before = {i: vt.lane_state_dict(i) for i in (0, 2)}
    before = {i: {k: v.clone() for k, v in sd.items()} for i, sd in before.items()}
    storage = unit_storage(vt._unit)
    vt.refill_lane(1, {"learning_rate": 5e-3})
    assert vt.active_lanes() == [0, 1, 2, 3] and unit_storage(vt._unit) == storage
    for i, sd in before.items():  # the refill wrote lane 1's row alone
        for k, v in vt.lane_state_dict(i).items():
            assert torch.equal(v, sd[k])
    refilled = run_block(vt)[:, 1]
    np.testing.assert_allclose(refilled, scalar_run(5e-3), rtol=REL, atol=ABS)
    with pytest.raises(ValueError, match="family"):
        vt.refill_lane(1, {"learning_rate": 5e-3, "b1": 0.8})


def unit_storage(unit):
    """The addresses of every tensor a captured K-lane step reads or writes:
    the stacked parameters, the gradient buffer and the optimizer's state
    (a rebound one would leave a replayed graph writing the old memory)."""
    state = [v.data_ptr() for st in unit.optimizer.state.values() for v in st.values()
             if isinstance(v, torch.Tensor)]
    return ([t.data_ptr() for t in unit.stacked.values()],
            [t.data_ptr() for t in unit.grads.values()], state)


def test_reinit_from_the_retired_unit_is_bitwise_a_fresh_block():
    fresh = run_block(block(warm_start=False))
    c0 = warm.counters()
    first = block(lrs=[2e-3, 4e-3, 6e-3, 8e-3])
    run_block(first, steps=2)
    unit = first._unit
    storage = unit_storage(unit)
    assert len(storage[2]) == 3 * 4 * len(unit.stacked)  # step, exp_avg, exp_avg_sq a view
    first.retire_to_warm_cache()
    second = block()
    assert second._unit is unit  # the retired K-lane unit, written in place
    assert np.array_equal(run_block(second), fresh)
    assert unit_storage(unit) == storage
    delta = {k: warm.counters()[k] - c0[k] for k in ("warm_hits", "warm_misses")}
    assert delta == {"warm_hits": 1, "warm_misses": 1}


def test_another_lane_count_takes_another_unit():
    first = block()
    first.retire_to_warm_cache()
    other = block(lrs=LRS[:2])
    assert other._unit is not first._unit and other.k == 2


def test_validation_as_jax():
    with pytest.raises(ValueError, match="at least one lane"):
        VmapTrainer(mlp(), adam, [], loss_fn, device="cpu")
    with pytest.raises(ValueError, match="SAME hyperparameter names"):
        VmapTrainer(mlp(), adam, [{"learning_rate": 1e-3}, {"b1": 0.9}], loss_fn, device="cpu")
    with pytest.raises(ValueError, match="family"):
        VmapTrainer(mlp(), adamw, [{"learning_rate": 1e-3, "weight_decay": 0.1},
                                   {"learning_rate": 1e-3, "weight_decay": 0.2}], loss_fn,
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            VmapTrainer(mlp(), adam, [{"learning_rate": 1e-3}], loss_fn)


def test_models_with_buffers_or_sowed_losses_are_refused():
    with pytest.raises(NotImplementedError, match="item 7b"):
        VmapTrainer(mlp(), adam, [{"learning_rate": 1e-3}], loss_fn, device="cpu",
                    has_aux_collections=True)
    resnet = ResNet(depth=18, num_classes=2, width=4, device="meta")
    with pytest.raises(NotImplementedError, match="item 7b"):
        VmapTrainer(resnet, adam, [{"learning_rate": 1e-3}], loss_fn, device="cpu")

    class Sowing(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = mlp("cpu")

        def init_weights(self, gen):
            self.inner.init_weights(gen)

        def forward(self, x):
            from maggy_tpu_torch.models import variables

            out = self.inner(x)
            variables.sow_loss(out.float().pow(2).mean())
            return out

    vt = VmapTrainer(Sowing(), adam, [{"learning_rate": 1e-3}] * 2, loss_fn,
                     device="cpu").init(seed=0)
    with pytest.raises(NotImplementedError, match="item 7b"):
        vt.step(BATCH)


# ------------------------------------------------- flash kernels under vmap


@pytest.fixture
def counted(monkeypatch):
    """Each kernel wrapper's calls (on the CPU a wrapper runs its plain
    version and counts no launch)."""
    calls = {}
    for kernel in attention.KERNELS:
        def wrapper(*args, _fn=kernel, **kwargs):
            calls[_fn.__name__] = calls.get(_fn.__name__, 0) + 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(attention, kernel.__name__, wrapper)
    return calls


@pytest.mark.parametrize("causal,mask_per_lane", [(False, False), (True, False), (True, True)],
                         ids=["padded", "causal_padded", "causal_lane_masks"])
def test_vmapped_flash_attention_matches_a_per_lane_loop(counted, causal, mask_per_lane):
    """GQA 4:2, key padding with a fully padded row; the forward and
    torch.func.grad of vmap over 3 lanes against each lane alone, and one
    call of each wrapper for the whole vmapped call."""
    K, B, S, H, Hkv, D = 3, 2, 128, 4, 2, 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(K, B, S, h, D, generator=g) for h in (H, Hkv, Hkv))
    lens = torch.tensor([[100, 0], [128, 40], [16, 128]])
    masks = torch.arange(S)[None, None] < lens[:, :, None]
    if not mask_per_lane:
        masks = masks[0]

    def attend(q, k, v, m):
        return attention.multi_head_attention(q, k, v, causal=causal, mask=m[:, None, None, :],
                                              force="flash")

    def objective(q, k, v, m):
        return attend(q, k, v, m).float().square().sum()

    m_dim = 0 if mask_per_lane else None
    lane_mask = (lambda i: masks[i]) if mask_per_lane else (lambda i: masks)
    out = torch.func.vmap(attend, in_dims=(0, 0, 0, m_dim))(q, k, v, masks)
    assert counted == {"flash_fwd": 1}
    grads = torch.func.vmap(torch.func.grad(objective, argnums=(0, 1, 2)),
                            in_dims=(0, 0, 0, m_dim))(q, k, v, masks)
    assert counted == {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1}
    for i in range(K):
        leaves = [x[i].clone().requires_grad_() for x in (q, k, v)]
        ref = attend(*leaves, lane_mask(i))
        torch.testing.assert_close(out[i], ref.detach(), rtol=1e-6, atol=1e-6)
        ref.float().square().sum().backward()
        for got, leaf in zip(grads, leaves):
            torch.testing.assert_close(got[i], leaf.grad, rtol=1e-5, atol=1e-5)


def test_bert_lanes_run_the_flash_functions_once_a_layer(counted, monkeypatch):
    """A tiny BERT block of 3 lanes through the flash path: one call of each
    wrapper per layer and step for the whole block, and each lane within
    bf16 tolerance of its scalar Trainer."""
    from maggy_tpu_torch.models import bert

    plain = attention.multi_head_attention
    monkeypatch.setattr(bert, "multi_head_attention",
                        lambda q, k, v, causal=True, mask=None: plain(
                            q, k, v, causal=causal, mask=mask, force="flash"))
    cfg = BertConfig.tiny()
    rng = np.random.default_rng(0)
    batch = {"inputs": (torch.as_tensor(rng.integers(2, 128, size=(4, 128))),
                        torch.arange(128)[None] < torch.tensor([128, 60, 16, 100])[:, None]),
             "labels": torch.tensor([0, 1, 1, 0])}
    lrs = [1e-4, 3e-4, 1e-3]
    vt = VmapTrainer(BertEncoder(cfg, device="meta"), adamw,
                     [{"learning_rate": lr} for lr in lrs], loss_fn, device="cpu").init(seed=0)
    lanes = np.stack([vt.step(batch).float().numpy() for _ in range(2)])
    assert counted == {name: cfg.num_layers * 2 for name in
                       ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    for i, lr in enumerate(lrs):
        trainer = Trainer(BertEncoder(cfg, device="meta"), swept_transform(adamw, learning_rate=lr),
                          loss_fn, device="cpu", warm_start=False).init(seed=0)
        scalar = [float(trainer.step(batch)) for _ in range(2)]
        np.testing.assert_allclose(lanes[:, i], scalar, rtol=1e-2, atol=1e-3)


# ------------------------------------------------------------------- driver


TRIALS = [
    ({"lr": 0.1}, {}), ({"lr": [0.1, 0.2]}, {}), ({"lr": 0.1}, {"resume_step": 3}),
    ({"lr": 0.1}, {"forked_from": "t0"}), ({"lr": 0.1}, {"parent": "t0"}),
    ({"lr": 0.1}, {"parent": "t0", "near_duplicate": True})]


@pytest.mark.parametrize("params,info", TRIALS)
def test_block_admission_as_jax(params, info):
    ours = object.__new__(OptimizationDriver)
    ref = object.__new__(JaxDriver)
    ref._gang_mode = False
    assert ours._vmap_blockable_locked(Trial(params, info_dict=dict(info))) == \
        ref._vmap_blockable_locked(JaxTrial(params, info_dict=dict(info)))


PAIRS = [
    ({"lr": 0.1, "batch": 128}, {"lr": 0.2, "batch": 128}, None),
    ({"lr": 0.1, "batch": 128}, {"lr": 0.2, "batch": 256}, None),
    ({"lr": 0.1}, {"lr": 0.1, "mu": 0.9}, None),
    ({"lr": 0.1}, {"lr": 0.1}, "ablation"),
    ({"lr": 0.1, "act": "relu"}, {"lr": 0.3, "act": "relu"}, None)]


@pytest.mark.parametrize("a,b,trial_type", PAIRS)
def test_block_compatibility_as_jax(a, b, trial_type):
    kw = {} if trial_type is None else {"trial_type": trial_type}
    assert OptimizationDriver._vmap_compatible(Trial(a), Trial(b, **kw)) == \
        JaxDriver._vmap_compatible(JaxTrial(a), JaxTrial(b, **kw))


def wire(opt, space, lanes, num_trials):
    opt.searchspace = space
    opt.num_trials = num_trials
    opt.trial_store = {}
    opt.final_store = []
    opt.direction = "max"
    opt.vmap_lanes = lanes
    opt._initialize()
    return opt


def lockstep(opt, workers=4):
    """Suggest/report as the driver runs them, up to ``workers`` in flight,
    the oldest finalizing first; (params, rung, parent) in suggestion order."""
    out, in_flight = [], []
    while True:
        while len(in_flight) < workers:
            t = opt.suggest()
            if t in (None, "IDLE"):
                break
            opt.trial_store[t.trial_id] = t
            in_flight.append(t)
            out.append((dict(t.params), t.info_dict.get("rung"), t.info_dict.get("parent")))
        if not in_flight:
            return out
        t = in_flight.pop(0)
        t.final_metric = 1.0 - (t.params["lr"] - 0.1) ** 2 + 0.01 * t.params["budget"]
        opt.trial_store.pop(t.trial_id)
        opt.final_store.append(t)
        opt.report(t)


@pytest.mark.parametrize("lanes", [1, 4])
def test_asha_rung_drain_in_lockstep_with_jax(lanes):
    space = dict(lr=("DOUBLE", [0.0, 0.2]))
    ours = lockstep(wire(Asha(2, 1, 4, seed=5), Searchspace(**space), lanes, 16))
    ref = lockstep(wire(JaxAsha(2, 1, 4, seed=5), JaxSearchspace(**space), lanes, 16))
    assert ours == ref and any(parent is not None for _, _, parent in ours)
    if lanes > 1:  # the drain moved the promotions
        assert ours != lockstep(wire(Asha(2, 1, 4, seed=5), Searchspace(**space), 1, 16))


@pytest.mark.parametrize("lanes,weight", [(1, 0.125), (4, 0.25)])
def test_fork_discount_weight_as_jax(lanes, weight):
    space = dict(lr=("DOUBLE", [0.0, 0.2]))
    ours = wire(TPE(seed=0, fork_eps=0.3), Searchspace(**space), lanes, 8)
    ref = wire(JaxTPE(seed=0, fork_eps=0.3), JaxSearchspace(**space), lanes, 8)
    assert ours.fork_discount_weight() == ref.fork_discount_weight() == weight


# ---------------------------------------------------------------- sweeps


def train_vec(lr, lanes=None, reporter=None):
    """``tests/test_vmap.py``'s closed-form lanes-capable trial: lane 0 is
    stopped at step 1 (and masked, its tail billed to lane_idle); the
    scalar branch serves each runner's first dispatch."""
    if lanes is None:
        for step in range(5):
            reporter.broadcast(1.0 - (lr - 0.1) ** 2 + 0.001 * step, step=step)
            time.sleep(0.02)
        return 1.0 - (lr - 0.1) ** 2
    lrs = [h["lr"] for h in lanes.hparams]
    for step in range(5):
        vals = [1.0 - (x - 0.1) ** 2 + 0.001 * step for x in lrs]
        reporter.broadcast_lanes(vals, step=step)
        if step == 1 and len(lanes) >= 2:
            reporter.stop_lanes([lanes.trial_ids[0]])
        for i in lanes.take_stopped():
            lanes.retire(i, float(vals[i]))
        time.sleep(0.02)
    return {tid: 1.0 - (x - 0.1) ** 2 for tid, x in zip(lanes.trial_ids, lrs)}


def journal(exp_root):
    (path,) = glob.glob(os.path.join(str(exp_root), "*", "telemetry.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def finals(events):
    return [e for e in events if e.get("ev") == "trial" and e["phase"] == "finalized"]


def sweep(package, exp_dir, train, **kw):
    kw = dict(dict(name="vmap_e2e", num_trials=8, optimizer="randomsearch", direction="max",
                   num_workers=1, hb_interval=0.05, seed=3, es_policy="none",
                   experiment_dir=str(exp_dir)), **kw)
    space = dict(lr=("DOUBLE", [0.0, 0.2]))
    if package == "port":
        return experiment.lagom(train, OptimizationConfig(searchspace=Searchspace(**space), **kw))
    return jax_experiment.lagom(train, JaxConfig(searchspace=JaxSearchspace(**space), **kw))


@pytest.mark.timeout(120)
def test_lane_sweep_journal_and_goodput_as_jax(tmp_path):
    """A seeded vmap_lanes=4 sweep through both packages: lane-tagged
    assigned, running and finalized edges with their block, every trial
    finalized once with its own metric, the same trials; the port journal's
    goodput equal under both packages' compute_goodput, with lane_idle > 0
    and an exact identity."""
    results, events = {}, {}
    for package in ("port", "jax"):
        results[package] = sweep(package, tmp_path / package, train_vec, vmap_lanes=4)
        events[package] = journal(tmp_path / package)
    for package, evs in events.items():
        assert results[package]["num_trials"] == 8, package
        done = finals(evs)
        assert len(done) == len({e["trial"] for e in done}) == 8, package
        lane_edges = {ph: [e for e in evs if e.get("ev") == "trial" and e["phase"] == ph
                           and e.get("lane") is not None]
                      for ph in ("assigned", "running", "finalized")}
        assert len(lane_edges["assigned"]) >= 4 and len(lane_edges["finalized"]) >= 4, package
        assert all(e.get("block") for e in lane_edges["assigned"] + lane_edges["finalized"])
        assert {e["trial"] for e in lane_edges["running"]} <= \
            {e["trial"] for e in lane_edges["assigned"]}
    assert {e["trial"] for e in finals(events["port"])} == \
        {e["trial"] for e in finals(events["jax"])}
    ours, ref = compute_goodput(events["port"]), jax_compute_goodput(events["port"])
    assert ours["buckets"] == ref["buckets"] and ours["held_chip_s"] == ref["held_chip_s"]
    for g in (ours, jax_compute_goodput(events["jax"])):
        assert g["buckets"].get("lane_idle", 0.0) > 0.0
        assert abs(sum(g["buckets"].values()) - g["held_chip_s"]) < 1e-6
    exp_dir = os.path.dirname(glob.glob(os.path.join(str(tmp_path / "port"), "*",
                                                     "telemetry.jsonl"))[0])
    for e in finals(events["port"]):
        with open(os.path.join(exp_dir, e["trial"], "trial.json")) as f:
            trial = json.load(f)
        assert trial["status"] == "FINALIZED" and trial["final_metric"] is not None


@pytest.mark.timeout(120)
def test_scalar_train_fn_runs_a_block_sequentially(tmp_path):
    def train_scalar_only(lr, reporter=None):
        reporter.broadcast(1.0 - (lr - 0.1) ** 2, step=0)
        time.sleep(0.05)  # the suggester fills the queue blocks assemble from
        return 1.0 - (lr - 0.1) ** 2

    result = sweep("port", tmp_path, train_scalar_only, num_trials=6, seed=5, vmap_lanes=3)
    evs = journal(tmp_path)
    assert result["num_trials"] == 6 and result["best_val"] is not None
    assert any(e.get("lane") is not None for e in finals(evs))
    assert len(finals(evs)) == 6


@pytest.mark.timeout(120)
def test_one_lane_is_the_scalar_schedule(tmp_path):
    schedules = {}
    for arm, kw in (("scalar", {}), ("lanes1", {"vmap_lanes": 1})):
        sweep("port", tmp_path / arm, train_vec, **kw)
        evs = journal(tmp_path / arm)
        assert not [e for e in evs if e.get("lane") is not None]
        schedules[arm] = [e["trial"] for e in finals(evs)]
    assert schedules["scalar"] == schedules["lanes1"] and len(schedules["scalar"]) == 8


def dies_in_first_block(after_step):
    """train_vec, except that the first block's call raises SystemExit
    (which ends its runner thread) once it has broadcast ``after_step``
    steps: at once, or after its leader's lane was stopped and retired."""
    lock, state = threading.Lock(), {"died": False}

    class Dying:
        def __init__(self, reporter):
            self.reporter, self.steps = reporter, 0

        def broadcast_lanes(self, values, step):
            if self.steps == after_step:
                raise SystemExit(3)
            self.steps += 1
            self.reporter.broadcast_lanes(values, step=step)

        def stop_lanes(self, trial_ids):
            self.reporter.stop_lanes(trial_ids)

    def train(lr, lanes=None, reporter=None):
        if lanes is not None:
            with lock:
                first, state["died"] = not state["died"], True
            if first:
                reporter = Dying(reporter)
        return train_vec(lr, lanes=lanes, reporter=reporter)

    return train


@pytest.mark.timeout(120)
@pytest.mark.parametrize("after_step", [0, 3], ids=["at_once", "after_the_leader_retired"])
def test_a_lost_block_leader_requeues_every_live_lane_once(tmp_path, after_step):
    """Two runners, vmap_lanes=4: the first block's runner thread dies
    holding the block, at once or after lane 0 (the leader) was stopped and
    finalized. The leader, if live, requeues on heartbeat loss and the other
    live lanes as vmap_block_lost; every trial then finalizes exactly once
    on the survivor."""
    train = dies_in_first_block(after_step)

    result = sweep("port", tmp_path, train, num_workers=2, hb_loss_timeout=1.0, vmap_lanes=4)
    evs = journal(tmp_path)
    assert result["num_trials"] == 8 and result["lost_runners"] == 1
    done = finals(evs)
    assert len(done) == len({e["trial"] for e in done}) == 8
    requeued = [e for e in evs if e.get("ev") == "trial" and e["phase"] == "requeued"]
    reasons = sorted(e["reason"] for e in requeued)
    lost = [e["trial"] for e in evs if e.get("ev") == "trial" and e["phase"] == "lost"]
    blocks = {}
    for e in evs:
        if e.get("ev") == "trial" and e["phase"] == "assigned" and e.get("block"):
            blocks.setdefault(e["block"], []).append(e["trial"])
    requeued_lanes = {e["trial"] for e in requeued if e["reason"] == "vmap_block_lost"}
    (dead,) = [leader for leader, lanes in blocks.items() if requeued_lanes & set(lanes)]
    assert requeued_lanes == set(blocks[dead]) - {dead} and len(requeued_lanes) >= 1
    if after_step == 0:
        assert lost == [dead] and reasons.count("heartbeat_loss") == 1
    else:  # the leader finalized before the loss: only the other lanes requeue
        assert lost == [] and "heartbeat_loss" not in reasons


# ------------------------------------------------------------------- resume


def interrupted_block_run(base, trial_cls):
    """What a driver that crashed mid-block leaves on disk: a journal with a
    3-lane block (leader first) assigned and running on partition 0 at
    epoch 0, partition 1 idle, and the dead incarnation's markers."""
    run_dir = os.path.join(base, "recapp_0")
    params = Searchspace(lr=("DOUBLE", [0.0, 0.2])).get_random_parameter_values(
        3, rng=np.random.default_rng(5))
    ids = [trial_cls(p).trial_id for p in params]
    t0 = time.time() - 60
    events = [{"t": t0, "ev": "driver_epoch", "epoch": 1},
              {"t": t0, "ev": "experiment", "phase": "start", "name": "rec"}]
    events += [{"t": t0 + 0.1, "ev": "runner", "phase": "registered", "partition": pid}
               for pid in (0, 1)]
    for lane, (tid, p) in enumerate(zip(ids, params)):
        span = "span-{}".format(lane)
        events += [
            {"t": t0 + 0.2, "ev": "trial", "trial": tid, "span": span, "phase": "queued",
             "params": p, "trial_type": "optimization", "info": {"sample_type": "random"}},
            {"t": t0 + 0.3, "ev": "trial", "trial": tid, "span": span, "phase": "assigned",
             "partition": 0, "lane": lane, "block": ids[0]},
            {"t": t0 + 0.4, "ev": "trial", "trial": tid, "span": span, "phase": "running",
             "partition": 0, "epoch": 0, **({} if lane == 0 else {"lane": lane,
                                                                 "block": ids[0]})}]
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "telemetry.jsonl"), "w") as f:
        f.writelines(json.dumps(ev) + "\n" for ev in events)
    for marker, body in ((".run_claim", "{}"), (".driver_epoch.1", "{}"),
                         ("experiment.json", json.dumps({"name": "rec", "state": "RUNNING"})),
                         ("driver_state.json", json.dumps({
                             "secret": "aa" * 16, "host": "127.0.0.1", "port": 0,
                             "driver_epoch": 1}))):
        with open(os.path.join(run_dir, marker), "w") as f:
            f.write(body)
    return ids


def test_resume_with_a_block_in_flight_holds_the_leader_and_requeues_the_lanes(tmp_path):
    """The port's recovery holds the block's leader on its partition and
    requeues the other lanes, so no trial is left in the store without a
    way back to a runner. The JAX package holds the lane journaled last
    and strands the other two (ROADMAP queue 3)."""
    EnvSing.reset()
    JaxEnvSing.reset()
    drivers = []
    try:
        for pkg, cfg, space, trial_cls, cls, extra in (
                ("port", OptimizationConfig, Searchspace, Trial, OptimizationDriver, {}),
                ("jax", JaxConfig, JaxSearchspace, JaxTrial, JaxDriver, {"health": False})):
            base = str(tmp_path / pkg)
            ids = interrupted_block_run(base, trial_cls)
            drv = cls(cfg(name="rec", num_trials=4, optimizer="randomsearch",
                          searchspace=space(lr=("DOUBLE", [0.0, 0.2])), direction="max",
                          num_workers=2, seed=5, es_policy="none", experiment_dir=base,
                          resume=True, prefetch=False, hb_loss_timeout=30.0, vmap_lanes=4,
                          **extra), "recapp", 0)
            drivers.append(drv)
            held = drv.server.reservations.get_assigned_trial(0)
            with drv._store_lock:
                stranded = set(drv._trial_store) - {held} - set(drv._requeue)
            if pkg == "port":
                assert held == ids[0] and drv._requeue == ids[1:] and not stranded
            else:
                assert held == ids[2] and stranded == set(ids[:2])
    finally:
        for drv in drivers:
            drv.stop()
        EnvSing.reset()
        JaxEnvSing.reset()
