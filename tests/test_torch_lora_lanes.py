"""LoRA, remat, the chunked loss and lazy modules in the port's vectorized
lanes, on the CPU, against maggy_tpu.

- The vocab-chunked loss under ``torch.func.vmap(grad_and_value(...))``:
  value and gradients with the head batched (a lane's own) and unbatched
  (a frozen head shared by every lane) against a loop over the lanes
  (1e-6: the same arithmetic, rows folded), and against
  ``jax.vmap(jax.value_and_grad(...))`` of the JAX package's loss (1e-5:
  fp32 sums in another order).
- Remat under lanes: per-lane gradients of a LoRA Llama with and without
  remat (1e-5), and the attention forward run again in the backward, each
  flash wrapper called once a layer for all lanes.
- LoRA lanes: 3 lanes x 5 steps of a tiny LoRA Llama (fp32, remat, the
  chunked loss) against the JAX package's ``VmapTrainer`` from the same
  Flax init with ``lora_b`` nonzero (losses rel 1e-4 and adapters 1e-4, as
  tests/test_torch_llama.py's five Trainer steps), the JAX side's frozen
  updates set to zero (``optax.masked`` passes them through); each lane
  against the port's scalar ``Trainer`` (rel 1e-5, abs 1e-6: a lane's
  adapter products are batched matmuls, the scalar's matmuls).
- The shared base: one storage per frozen parameter, no gradient buffer or
  optimizer state for it, unmoved by a bit after steps; a masked lane
  leaves the others bitwise unmoved; a refill matches a scalar cold run.
- Lazy modules: examples/titanic_ablation.py's model (a ``LazyLinear``
  input layer) in ``VmapTrainer`` against the JAX ``VmapTrainer`` of its
  Flax counterpart (rel 1e-5).
- Through ``lagom``: ``vmap_lanes=3`` with a tiny LoRA lane train function.
"""

import dataclasses
import glob
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maggy_tpu.models import surgery as jax_surgery
from maggy_tpu.models.llama import Llama as JaxLlama
from maggy_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from maggy_tpu.ops.losses import chunked_next_token_loss as jax_chunked_loss
from maggy_tpu.parallel import make_mesh
from maggy_tpu.telemetry.goodput import compute_goodput as jax_compute_goodput
from maggy_tpu.train import VmapTrainer as JaxVmapTrainer
from maggy_tpu.train import clear_warm as jax_clear_warm
from maggy_tpu.train import cross_entropy_loss as jax_xent
from maggy_tpu.train.lora import lora_mask, only_lora as jax_only_lora

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.models import Llama, LlamaConfig, surgery
from maggy_tpu_torch.models.llama import flax_to_state_dict
from maggy_tpu_torch.ops import attention, chunked_next_token_loss
from maggy_tpu_torch.telemetry import read_events
from maggy_tpu_torch.telemetry.goodput import compute_goodput
from maggy_tpu_torch.train import (Trainer, adam, adamw, clear_warm, cross_entropy_loss,
                                   is_lora_param, only_lora, swept_transform)
from maggy_tpu_torch.train.vmap import VmapTrainer

pytestmark = [pytest.mark.torch, pytest.mark.timeout(180)]

K, B, S, VOCAB, CHUNK = 3, 2, 64, 256, 100  # 256 = 100 + 100 + 56: the last chunk slides
STEPS = 5
LRS = [1e-3, 3e-3, 1e-2]
LOSS_RTOL, PARAM_TOL = 1e-4, 1e-4
REL, ABS = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def fresh_cache():
    clear_warm()
    yield
    clear_warm()


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (tests/test_torch_vmap.py's reason: a loaded CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lora_adamw(learning_rate):
    """The lanes' LoRA family: a factory of ``only_lora`` builders."""
    return only_lora(adamw(learning_rate))


def jax_lora_adamw(learning_rate):
    """The JAX package's ``only_lora(optax.adamw(lr))`` with its frozen
    leaves' updates set to zero (tests/test_torch_llama.py's
    ``_jax_lora_tx``; ``optax.masked`` passes them through)."""
    frozen = lambda params: jax.tree_util.tree_map(lambda m: not m, lora_mask(params))  # noqa: E731
    return optax.chain(jax_only_lora(optax.adamw(learning_rate)),
                       optax.masked(optax.set_to_zero(), frozen))


def loss_fn(out, batch):
    return chunked_next_token_loss(out[0], out[1], batch["tokens"], CHUNK)


def jax_loss_fn(out, batch):
    return jax_chunked_loss(out[0], out[1], batch["tokens"], CHUNK)


def tokens(seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(B, S)).astype(np.int32)


def batch(seed):
    t = torch.as_tensor(tokens(seed), dtype=torch.long)
    return {"inputs": (t,), "tokens": t}


def configs(**overrides):
    """The tiny LoRA Llama of both packages, fp32, remat on."""
    fields = dict(lora_rank=4, remat=True)
    fields.update(overrides)
    return (dataclasses.replace(JaxLlamaConfig.tiny(VOCAB), dtype=jnp.float32, **fields),
            dataclasses.replace(LlamaConfig.tiny(VOCAB), dtype=torch.float32, **fields))


def with_lora_b(params, seed=7):
    """Every ``lora_b`` drawn from numpy (Flax inits them to zero)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "lora_b":
            return rng.normal(0.0, 0.05, size=x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def lane_block(cfg, state=None, lrs=LRS, **kw):
    return VmapTrainer(Llama(cfg, device="meta"), lora_adamw,
                       [{"learning_rate": lr} for lr in lrs], loss_fn, device="cpu",
                       train_kwargs={"return_hidden": True}, **kw).init(seed=0, state_dict=state)


def run(vt, steps=STEPS, mask_at=None, lane=1):
    out = []
    for t in range(steps):
        if t == mask_at:
            vt.mask_lane(lane)
        out.append(vt.step(batch(10 + t)).detach().numpy().copy())
    return np.stack(out)


def scalar_run(cfg, lr, state=None, steps=STEPS):
    trainer = Trainer(Llama(cfg, device="meta"), swept_transform(lora_adamw, learning_rate=lr),
                      loss_fn, device="cpu", train_kwargs={"return_hidden": True},
                      warm_start=False).init(seed=0, state_dict=state)
    losses = [float(trainer.step(batch(10 + t))) for t in range(steps)]
    return np.asarray(losses), trainer.model.state_dict()


# ------------------------------------------------------ the chunked loss


@pytest.mark.parametrize("head_batched", [False, True], ids=["frozen_head", "lane_heads"])
def test_chunked_loss_under_vmap_matches_a_loop_over_lanes(head_batched):
    rng = np.random.default_rng(3)
    hidden = torch.as_tensor(rng.normal(size=(K, B, S, 16)), dtype=torch.float32)
    shape = (K, 16, VOCAB) if head_batched else (16, VOCAB)
    head = torch.as_tensor(rng.normal(0.0, 0.3, size=shape), dtype=torch.float32)
    toks = torch.as_tensor(tokens(4), dtype=torch.long)

    def f(h, k):
        return chunked_next_token_loss(h, k, toks, CHUNK)

    (dh, dk), value = torch.func.vmap(torch.func.grad_and_value(f, argnums=(0, 1)),
                                      in_dims=(0, 0 if head_batched else None))(hidden, head)
    for i in range(K):
        h = hidden[i].clone().requires_grad_()
        k = (head[i] if head_batched else head).clone().requires_grad_()
        loss = f(h, k)
        gh, gk = torch.autograd.grad(loss, (h, k))
        torch.testing.assert_close(value[i], loss.detach(), rtol=0, atol=1e-6)
        torch.testing.assert_close(dh[i], gh, rtol=0, atol=1e-6)
        torch.testing.assert_close(dk[i], gk, rtol=0, atol=1e-6)
    # The LoRA case: the frozen head is shared and not differentiated.
    (dh_only,), value_only = torch.func.vmap(torch.func.grad_and_value(f, argnums=(0,)),
                                             in_dims=(0, None))(hidden, head[0] if
                                                                head_batched else head)
    assert dh_only.shape == hidden.shape and value_only.shape == (K,)


@pytest.mark.parametrize("head_batched", [False, True], ids=["frozen_head", "lane_heads"])
def test_chunked_loss_under_vmap_matches_jax_vmap(head_batched):
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(K, B, S, 16)).astype(np.float32)
    shape = (K, 16, VOCAB) if head_batched else (16, VOCAB)
    head = rng.normal(0.0, 0.3, size=shape).astype(np.float32)
    toks = tokens(6)
    axis = 0 if head_batched else None
    ref, (ref_dh, ref_dk) = jax.vmap(jax.value_and_grad(
        lambda h, k: jax_chunked_loss(h, k, jnp.asarray(toks), CHUNK), (0, 1)),
        in_axes=(0, axis))(jnp.asarray(hidden), jnp.asarray(head))
    (dh, dk), value = torch.func.vmap(torch.func.grad_and_value(
        lambda h, k: chunked_next_token_loss(h, k, torch.as_tensor(toks).long(), CHUNK),
        argnums=(0, 1)), in_dims=(0, axis))(torch.from_numpy(hidden), torch.from_numpy(head))
    np.testing.assert_allclose(value.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dh.numpy(), np.asarray(ref_dh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), np.asarray(ref_dk), rtol=0, atol=1e-5)


# ------------------------------------------------------ remat under lanes


def lane_grads(model, trained, frozen, toks):
    def objective(tr, fr):
        hidden, head = torch.func.functional_call(model, (tr, fr), (toks,),
                                                  {"return_hidden": True})
        return chunked_next_token_loss(hidden, head, toks, CHUNK)

    return torch.func.vmap(torch.func.grad_and_value(objective), in_dims=(0, None))(
        trained, frozen)


def lane_params(model, seed=11):
    """Each adapter stacked over K lanes, each lane moved apart; the rest
    frozen and shared."""
    gen = torch.Generator().manual_seed(seed)
    trained = {n: p.detach() + 0.02 * torch.randn((K,) + tuple(p.shape), generator=gen)
               for n, p in model.named_parameters() if is_lora_param(n)}
    frozen = {n: p.detach() for n, p in model.named_parameters() if not is_lora_param(n)}
    return trained, frozen


def test_remat_under_lanes_matches_no_remat():
    _, tcfg = configs()
    toks = batch(1)["tokens"]
    out = {}
    for remat in (True, False):
        model = Llama(dataclasses.replace(tcfg, remat=remat), device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        out[remat] = lane_grads(model, *lane_params(model), toks)
    (g_r, v_r), (g_p, v_p) = out[True], out[False]
    torch.testing.assert_close(v_r, v_p, rtol=0, atol=1e-5)
    assert g_r.keys() == g_p.keys() and all(is_lora_param(n) for n in g_r)
    for name in g_r:
        assert g_r[name].shape[0] == K
        torch.testing.assert_close(g_r[name], g_p[name], rtol=0, atol=1e-5)


def test_remat_under_lanes_leaves_no_graph_behind_its_gradients(monkeypatch):
    """The outer grad transform runs each layer's backward with grad mode
    on. A recompute whose gradients kept a graph behind them would keep
    every layer's recomputed activations alive until the step's end: as
    much memory as no remat at all. They come back without one."""
    from maggy_tpu_torch.models import remat

    tracked = []
    backward = remat._RematLayer.backward

    def spy(ctx, *grads):
        out = backward(ctx, *grads)
        tracked.extend(t.requires_grad for t in out if isinstance(t, torch.Tensor))
        return out

    monkeypatch.setattr(remat._RematLayer, "backward", staticmethod(spy))
    _, tcfg = configs()
    model = Llama(tcfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    lane_grads(model, *lane_params(model), batch(1)["tokens"])
    assert tracked and not any(tracked)


@pytest.fixture
def counted(monkeypatch):
    """Each flash wrapper's calls, with the Llama's attention forced onto
    the kernels' path (their plain versions on the CPU)."""
    from maggy_tpu_torch.models import llama as llama_module

    calls = {}
    for kernel in attention.KERNELS:
        def wrapper(*args, _fn=kernel, **kwargs):
            calls[_fn.__name__] = calls.get(_fn.__name__, 0) + 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(attention, kernel.__name__, wrapper)
    plain = attention.multi_head_attention
    monkeypatch.setattr(llama_module, "multi_head_attention",
                        lambda q, k, v, causal, mask: plain(q, k, v, causal=causal, mask=mask,
                                                            force="flash"))
    return calls


def test_remat_under_lanes_reruns_the_attention_forward(counted):
    """D = 64, S = 128 (the flash path's smallest tiles): with remat the
    forward kernel runs twice a layer (forward and recompute) and each
    backward kernel once, for all K lanes at once, as the scalar path runs
    them for one trial (tests/test_torch_llama.py)."""
    _, tcfg = configs(hidden_dim=128, num_heads=2, num_kv_heads=1, head_dim=64)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, VOCAB, size=(B, 128)))
    for remat, fwd in ((True, 2), (False, 1)):
        model = Llama(dataclasses.replace(tcfg, remat=remat), device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        counted.clear()
        lane_grads(model, *lane_params(model), toks)
        n = tcfg.num_layers
        assert counted == {"flash_fwd": fwd * n, "flash_bwd_dkdv": n, "flash_bwd_dq": n}, remat


# ------------------------------------------------------ LoRA lanes vs JAX


@pytest.fixture(scope="module")
def jax_lora_block():
    """The JAX package's 3-lane block of the tiny LoRA Llama (remat, the
    chunked loss through return_hidden) from one Flax init with lora_b
    drawn: its per-step lane losses, each lane's params after STEPS steps
    as the port's state dicts, and the init as the port's state dict."""
    jax_clear_warm()
    jcfg, _ = configs()
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    vt = JaxVmapTrainer(JaxLlama(jcfg), jax_lora_adamw, [{"learning_rate": lr} for lr in LRS],
                        jax_loss_fn, mesh, train_kwargs={"return_hidden": True})
    vt.init(jax.random.key(0), (jnp.ones((1, S), jnp.int32),))
    params = with_lora_b(jax.tree_util.tree_map(lambda x: np.asarray(x[0]),
                                                vt.variables["params"]))
    vt.variables = {"params": jax.tree_util.tree_map(
        lambda x: jnp.stack([jnp.asarray(x)] * K), params)}
    losses = []
    for t in range(STEPS):
        toks = tokens(10 + t)
        losses.append(np.asarray(vt.step({"inputs": (jnp.asarray(toks),),
                                          "tokens": jnp.asarray(toks)})))
    after = [flax_to_state_dict(jax.tree_util.tree_map(lambda x: np.asarray(x[i]),
                                                       vt.variables["params"]))
             for i in range(K)]
    jax_clear_warm()
    return np.stack(losses), after, flax_to_state_dict(params)


def test_lora_lanes_match_the_jax_vmap_trainer(jax_lora_block):
    jlosses, jafter, state = jax_lora_block
    _, tcfg = configs()
    vt = lane_block(tcfg, state)
    losses = run(vt)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    for i in range(K):
        mine = vt.lane_state_dict(i)
        for name in mine:
            if is_lora_param(name):
                assert float((mine[name] - jafter[i][name]).abs().max()) < PARAM_TOL, (i, name)
    assert not np.array_equal(losses[:, 0], losses[:, 2])  # the rates differ


def test_each_lora_lane_matches_the_port_scalar_trainer(jax_lora_block):
    _, _, state = jax_lora_block
    _, tcfg = configs()
    vt = lane_block(tcfg, state)
    losses = run(vt)
    for i, lr in enumerate(LRS):
        scalar, after = scalar_run(tcfg, lr, state)
        np.testing.assert_allclose(losses[:, i], scalar, rtol=REL, atol=ABS)
        for name, value in vt.lane_state_dict(i).items():
            torch.testing.assert_close(value, after[name], rtol=REL, atol=ABS)


# ------------------------------------------------------ the shared base


def test_the_unit_holds_each_frozen_parameter_once():
    _, tcfg = configs()
    vt = lane_block(tcfg)
    unit = vt._unit
    params = dict(unit.model.named_parameters())
    trained = {n for n in params if is_lora_param(n)}
    assert set(unit.stacked) == set(unit.grads) == trained
    assert set(unit.frozen) == set(params) - trained and unit.frozen
    for name, t in unit.frozen.items():
        assert t.data_ptr() == params[name].data_ptr() and not params[name].requires_grad
        assert t.dtype == tcfg.dtype
    run(vt, steps=2)
    # AdamW's state: the adapter rows alone (step, exp_avg, exp_avg_sq each).
    rows = {t.data_ptr() for rows in unit.stacked.values() for t in rows}
    held = [p for group in unit.optimizer.param_groups for p in group["params"]]
    assert len(held) == K * len(trained) and {p.data_ptr() for p in held} == rows
    assert set(unit.optimizer.state) == set(held)
    frozen_ptrs = {t.data_ptr() for t in unit.frozen.values()}
    for state in unit.optimizer.state.values():
        assert not {v.data_ptr() for v in state.values()} & frozen_ptrs


def test_steps_leave_the_base_bitwise_unmoved_and_masking_leaves_lanes_unmoved():
    _, tcfg = configs()
    vt = lane_block(tcfg)
    base = {n: t.clone() for n, t in vt._unit.frozen.items()}
    full = run(vt)
    for name, t in vt._unit.frozen.items():
        assert torch.equal(t, base[name]), name
    clear_warm()
    masked_vt = lane_block(tcfg)
    masked = run(masked_vt, mask_at=2)
    for i in (0, 2):
        assert np.array_equal(masked[:, i], full[:, i])
    assert masked_vt.active_lanes() == [0, 2]


def test_a_refilled_lora_lane_matches_a_scalar_cold_run():
    _, tcfg = configs()
    vt = lane_block(tcfg)
    run(vt, steps=2, mask_at=1)
    base = {n: t.clone() for n, t in vt._unit.frozen.items()}
    vt.refill_lane(1, {"learning_rate": 5e-3})
    assert vt.active_lanes() == [0, 1, 2]
    refilled = run(vt)[:, 1]
    np.testing.assert_allclose(refilled, scalar_run(tcfg, 5e-3)[0], rtol=REL, atol=ABS)
    for name, t in vt._unit.frozen.items():
        assert torch.equal(t, base[name]), name
    with pytest.raises(ValueError, match="frozen base"):
        vt.refill_lane(1, {"learning_rate": 5e-3}, seed=1)


def test_a_lora_block_and_a_full_block_never_share_a_unit():
    _, tcfg = configs()
    lora = lane_block(tcfg)
    assert lora.family[0] == "only_lora"
    unit = lora._unit
    lora.retire_to_warm_cache()
    full = VmapTrainer(Llama(tcfg, device="meta"), adamw, [{"learning_rate": lr} for lr in LRS],
                       loss_fn, device="cpu", train_kwargs={"return_hidden": True}).init(seed=0)
    assert full._unit is not unit and not full._unit.frozen
    full.retire_to_warm_cache()
    again = lane_block(tcfg)
    assert again._unit is unit  # the retired LoRA unit, re-initialized in place


# ------------------------------------------------------ lazy modules


def flax_titanic_layers():
    return (("input_dense", lambda: fnn.Dense(32)),
            ("hidden_1", lambda: fnn.Sequential([fnn.Dense(32), fnn.relu])),
            ("hidden_2", lambda: fnn.Sequential([fnn.Dense(32), fnn.relu])),
            ("head", lambda: fnn.Dense(2)))


def test_lazy_modules_in_lanes_match_the_jax_vmap_trainer():
    """examples/titanic_ablation.py's layers: the input layer lazy in the
    port, so VmapTrainer.init needs example_inputs, as Trainer.init does."""
    from maggy_tpu_torch.examples.titanic_ablation import model_layers

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    y = (x[:, 1] > 0).astype(np.int32)
    lrs = [1e-3, 1e-2, 3e-2]
    jax_clear_warm()
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jvt = JaxVmapTrainer(jax_surgery.ablatable_model_generator(flax_titanic_layers()), optax.adam,
                         [{"learning_rate": lr} for lr in lrs],
                         lambda logits, b: jax_xent(logits, b["labels"]), mesh)
    jvt.init(jax.random.key(0), (jnp.asarray(x[:1]),))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a[0]), jvt.variables["params"])
    jbatch = {"inputs": (jnp.asarray(x),), "labels": jnp.asarray(y)}
    jlosses = np.stack([np.asarray(jvt.step(jbatch)) for _ in range(STEPS)])
    jax_clear_warm()

    tbatch = {"inputs": (torch.from_numpy(x),), "labels": torch.from_numpy(y).long()}
    model = surgery.ablatable_model_generator(model_layers())
    state = surgery.flax_to_state_dict(params, model)

    def lanes():
        return VmapTrainer(surgery.ablatable_model_generator(model_layers()), adam,
                           [{"learning_rate": lr} for lr in lrs],
                           lambda logits, b: cross_entropy_loss(logits, b["labels"]),
                           device="cpu")

    with pytest.raises(ValueError, match="example_inputs"):
        lanes().init(state_dict=state)
    vt = lanes().init(state_dict=state, example_inputs=tbatch["inputs"])
    assert vt._unit.stacked["layers.input_dense.weight"].shape == (3, 32, 5)
    losses = np.stack([vt.step(tbatch).detach().numpy() for _ in range(STEPS)])
    np.testing.assert_allclose(losses, jlosses, rtol=REL, atol=ABS)


# ------------------------------------------------------ through lagom


def train_lora_lanes(lr, lanes=None, reporter=None):
    """A tiny LoRA Llama trial (remat, the chunked loss): a block's lanes
    as one VmapTrainer, the scalar branch as a Trainer of the same
    family."""
    _, tcfg = configs()
    steps = 3
    if lanes is None:
        trainer = Trainer(Llama(tcfg, device="meta"), swept_transform(lora_adamw, learning_rate=lr),
                          loss_fn, device="cpu", train_kwargs={"return_hidden": True}).init(seed=0)
        for t in range(steps):
            loss = trainer.step(batch(t))
            reporter.broadcast(-loss, step=t)
        return -float(loss)
    vt = VmapTrainer(Llama(tcfg, device="meta"), lora_adamw,
                     [{"learning_rate": h["lr"]} for h in lanes.hparams], loss_fn, device="cpu",
                     train_kwargs={"return_hidden": True}).init(seed=0)
    for t in range(steps):
        losses = vt.step(batch(t))
        reporter.broadcast_lanes(-losses, step=t)
        for i in lanes.take_stopped():
            vt.mask_lane(i)
            lanes.retire(i, -float(losses[i]))
    return {tid: -float(losses[i]) for i, tid in enumerate(lanes.trial_ids)}


def test_lora_lane_sweep_through_lagom(tmp_path):
    config = OptimizationConfig(
        name="lora_lanes", num_trials=6, optimizer="randomsearch", direction="max",
        num_workers=1, hb_interval=0.05, seed=3, es_policy="none", vmap_lanes=3,
        searchspace=Searchspace(lr=("DOUBLE", [1e-4, 1e-2])), experiment_dir=str(tmp_path))
    result = experiment.lagom(train_lora_lanes, config)
    assert result["num_trials"] == 6
    (path,) = glob.glob(os.path.join(str(tmp_path), "*", "telemetry.jsonl"))
    events = read_events(path)
    assert events.torn_lines == 0
    trial_events = [e for e in events if e["ev"] == "trial"]
    finals = [e for e in trial_events if e["phase"] == "finalized"]
    assert len(finals) == len({e["trial"] for e in finals}) == 6
    for trial in {e["trial"] for e in finals}:
        phases = [e["phase"] for e in trial_events if e["trial"] == trial]
        order = [phases.index(p) for p in ("queued", "assigned", "running", "finalized")]
        assert order == sorted(order), phases
    lane_finals = [e for e in finals if e.get("lane") is not None]
    assert len(lane_finals) >= 3 and all(e.get("block") for e in lane_finals)
    lane_metrics = [e for e in trial_events
                    if e["phase"] == "first_metric" and e.get("lane") is not None]
    assert len(lane_metrics) >= 3
    ours, ref = compute_goodput(list(events)), jax_compute_goodput(list(events))
    assert ours["buckets"] == ref["buckets"]
    assert abs(sum(ours["buckets"].values()) - ours["held_chip_s"]) < 1e-6
    exp_dir = os.path.dirname(path)
    for e in finals:
        with open(os.path.join(exp_dir, e["trial"], "trial.json")) as f:
            trial = json.load(f)
        assert trial["status"] == "FINALIZED" and np.isfinite(trial["final_metric"])
