"""Mixture-of-experts parity: the port's routing, MoEMLP and MoE Llama
against maggy_tpu on the CPU. routing_tensors on seeded logits (top-k ties,
which keep more than k experts; capacity overflow, which drops tokens; a
single expert asked for top-2; top-1), the MoEMLP forward and its sowed
load-balancing loss, a tiny MoE Llama's logits, its objective with the
summed auxiliary losses and its gradients, three Trainer steps against the
JAX Trainer (whose objective adds every sowed loss), flax_to_state_dict,
initializer scales, the warm path's program key and the aux loss in the
eager step's objective. Everything computes in fp32 on both sides: the 0/1
dispatch tensors are held exactly, combine weights and the aux loss to
1e-6, outputs and gradients to 1e-5 (sums in another order), the losses of
three steps to 1e-5 relative."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maggy_tpu.models.llama import Llama as JaxLlama
from maggy_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from maggy_tpu.models.moe import MoEMLP as JaxMoEMLP
from maggy_tpu.models.moe import routing_tensors as jax_routing
from maggy_tpu.parallel import make_mesh
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train.trainer import next_token_loss as jax_next_token_loss

from maggy_tpu_torch.models import Llama, LlamaConfig, MoEMLP
from maggy_tpu_torch.models.llama import flax_to_state_dict
from maggy_tpu_torch.models.moe import _top_k_mask, routing_tensors
from maggy_tpu_torch.models.variables import sowing_losses
from maggy_tpu_torch.ops import next_token_loss
from maggy_tpu_torch.train import Trainer, adamw, clear_warm, only_lora, swept_transform

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]

EXACT_TOL = 1e-6
OUT_TOL = 1e-5
LOSS_RTOL = 1e-5
B, S, VOCAB = 2, 32, 128


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs six files
    at once on the machine's cores, beside timing-bound tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _maxdiff(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


# (name, B, S, E, capacity, top_k, logits): "ties" draws integer logits, so
# equal probabilities tie at the k-th largest; "overflow" routes 32 tokens
# into two slots per expert.
def _logits(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 3, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


ROUTING_CASES = [("plain", 2, 16, 4, 16, 2), ("ties", 2, 16, 4, 16, 2),
                 ("overflow", 2, 32, 4, 2, 2), ("one_expert", 2, 8, 1, 8, 1),
                 ("top1", 3, 12, 4, 12, 1)]


@pytest.mark.parametrize("kind, b, s, e, capacity, top_k", ROUTING_CASES)
def test_routing_tensors_match_jax(kind, b, s, e, capacity, top_k):
    logits = _logits(kind, (b, s, e), seed=len(kind) + s)
    ref = jax_routing(jnp.asarray(logits), e, capacity, top_k)
    ours = routing_tensors(torch.from_numpy(logits), e, capacity, top_k)
    assert ours[0].shape == (b, s, e, capacity)
    assert torch.equal(ours[0], torch.from_numpy(np.asarray(ref[0])))
    assert _maxdiff(ours[1], ref[1]) < EXACT_TOL
    assert abs(float(ours[2]) - float(ref[2])) < EXACT_TOL
    mask = _top_k_mask(torch.softmax(torch.from_numpy(logits), -1), top_k)
    routed, kept = float(mask.sum()), float(ours[0].sum())
    if kind == "ties":  # some token keeps more than k experts
        assert float(mask.sum(-1).max()) > top_k
    if kind == "overflow":  # tokens past an expert's two slots are dropped
        assert kept < routed and kept == b * e * capacity
    else:
        assert kept == routed


def _moe_pair(top_k=2, capacity_factor=2.0, num_experts=4, seed=0):
    kw = dict(hidden_dim=16, intermediate_dim=24, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    jax_mod = JaxMoEMLP(dtype=jnp.float32, **kw)
    x = np.random.default_rng(seed).normal(size=(B, 16, 16)).astype(np.float32)
    params = nn.meta.unbox(jax.jit(jax_mod.init)(jax.random.key(seed), jnp.asarray(x)))["params"]
    mod = MoEMLP(dtype=torch.float32, device="cpu", **kw)
    mod.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    return jax_mod, params, mod, x


def test_cuda_default_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MoEMLP(hidden_dim=16, intermediate_dim=24, num_experts=4)


@pytest.mark.parametrize("top_k, capacity_factor, num_experts",
                         [(2, 2.0, 4), (1, 1.0, 4), (2, 0.5, 4), (2, 2.0, 1)])
def test_moe_mlp_forward_and_sowed_loss_match_jax(top_k, capacity_factor, num_experts):
    jax_mod, params, mod, x = _moe_pair(top_k, capacity_factor, num_experts)
    ref, state = jax_mod.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    (ref_aux,) = jax.tree_util.tree_leaves(state["losses"])
    with torch.no_grad(), sowing_losses() as sown:
        out = mod(torch.from_numpy(x))
    assert out.shape == x.shape and _maxdiff(out, ref) < OUT_TOL
    assert len(sown) == 1 and abs(float(sown[0]) - float(ref_aux)) < EXACT_TOL
    with torch.no_grad():  # outside a sowing block the loss goes nowhere
        mod(torch.from_numpy(x))


def _llama_configs(**overrides):
    """LlamaConfig.tiny() of both packages with 4 experts (capacity factor 1,
    so some tokens drop), computing in fp32."""
    fields = dict(num_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
    fields.update(overrides)
    return (dataclasses.replace(JaxLlamaConfig.tiny(VOCAB), dtype=jnp.float32, **fields),
            dataclasses.replace(LlamaConfig.tiny(VOCAB), dtype=torch.float32, **fields))


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(B, S)).astype(np.int32)


def _llama_pair(**overrides):
    jcfg, tcfg = _llama_configs(**overrides)
    variables = jax.jit(JaxLlama(jcfg).init)(jax.random.key(0), jnp.ones((1, S), jnp.int32))
    params = nn.meta.unbox(variables)["params"]
    model = Llama(tcfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    return jcfg, params, model


def test_moe_llama_logits_objective_and_gradients_match_jax():
    """A two-layer MoE Llama: logits, the objective next_token_loss + the
    two layers' sowed losses, and the gradient of every parameter (router
    and experts included)."""
    jcfg, params, model = _llama_pair()
    tokens = _tokens(1)

    def objective(p):
        logits, state = JaxLlama(jcfg).apply({"params": p}, jnp.asarray(tokens),
                                             mutable=["losses"])
        aux = sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(state["losses"]))
        return jax_next_token_loss(logits, jnp.asarray(tokens)) + aux, (logits, aux)

    (ref_loss, (ref_logits, ref_aux)), ref_grads = jax.jit(
        jax.value_and_grad(objective, has_aux=True))(params)
    t = torch.as_tensor(tokens, dtype=torch.long)
    with sowing_losses() as sown:
        logits = model(t)
    assert len(sown) == jcfg.num_layers
    aux = sown[0] + sown[1]
    loss = next_token_loss(logits, t) + aux
    loss.backward()
    assert _maxdiff(logits, ref_logits) < OUT_TOL
    assert abs(float(aux) - float(ref_aux)) < EXACT_TOL and float(aux) > 0
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    grads = flax_to_state_dict(ref_grads)
    moe = [n for n in grads if ".moe_mlp." in n]
    assert len(moe) == 4 * jcfg.num_layers
    for name, p in model.named_parameters():
        assert _maxdiff(p.grad, grads[name]) < OUT_TOL, name


def test_three_trainer_steps_with_aux_losses_match_jax():
    """AdamW over every parameter for three steps through both Trainers:
    the JAX objective adds the sowed losses, the port's adds its summed
    aux losses; the port's aux_loss is the objective less the task loss."""
    lr, steps = 3e-3, 3
    jcfg, params, model = _llama_pair()
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(JaxLlama(jcfg), optax.adamw(lr),
                          lambda logits, b: jax_next_token_loss(logits, b["tokens"]), mesh,
                          warm_start=False)
    jtrainer.init(jax.random.key(0), (jnp.ones((1, S), jnp.int32),))
    jtrainer.variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    trainer = Trainer(model, adamw(lr), lambda logits, b: next_token_loss(logits, b["tokens"]),
                      device="cpu").init(state_dict=flax_to_state_dict(params))
    for step in range(steps):
        tokens = _tokens(10 + step)
        jloss = float(jtrainer.step(jtrainer.place_batch(
            {"inputs": (jnp.asarray(tokens),), "tokens": jnp.asarray(tokens)})))
        t = torch.as_tensor(tokens, dtype=torch.long)
        with torch.no_grad():
            task = float(next_token_loss(trainer.model(t), t))
        loss = float(trainer.step({"inputs": (t,), "tokens": t}))
        assert loss == pytest.approx(jloss, rel=LOSS_RTOL), step
        assert float(trainer.aux_loss) == pytest.approx(loss - task, abs=1e-5), step
    after = flax_to_state_dict(jtrainer.variables["params"])
    for name, p in trainer.model.named_parameters():
        assert _maxdiff(p, after[name]) < 1e-4, name


def test_flax_to_state_dict_round_trips_the_moe_llama():
    jcfg, params, model = _llama_pair()
    state = model.state_dict()
    converted = flax_to_state_dict(params)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in converted.items()}
    assert {n.split(".", 2)[2] for n in state if ".moe_mlp." in n} == {
        "moe_mlp.router", "moe_mlp.gate_proj", "moe_mlp.up_proj", "moe_mlp.down_proj"}
    assert not any(".mlp." in n for n in state)
    assert all(torch.equal(state[k], v) for k, v in converted.items())


def test_init_draws_flax_scales_for_router_and_experts():
    """lecun_normal over [D, E] and stacked [E, D, F] / [E, F, D]: Flax's
    fan-in counts every axis but the last, the expert axis included."""
    jcfg, tcfg = _llama_configs(hidden_dim=64, intermediate_dim=96, num_experts=8)
    params = nn.meta.unbox(jax.jit(JaxLlama(jcfg).init)(
        jax.random.key(0), jnp.ones((1, S), jnp.int32)))["params"]
    model = Llama(tcfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    ref = flax_to_state_dict(params)
    for name, p in model.named_parameters():
        if ".moe_mlp." in name:
            expected = float(np.asarray(ref[name]).std())
            assert abs(float(p.std()) / expected - 1.0) < 0.1, name
            assert abs(float(p.std()) * np.sqrt(p.numel() // p.shape[-1]) - 1.0) < 0.1, name


def test_only_lora_freezes_experts_and_keeps_the_router_in_fp32():
    _, tcfg = _llama_configs(lora_rank=4)
    model = Llama(dataclasses.replace(tcfg, dtype=torch.bfloat16), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    optimizer, _ = only_lora(adamw(1e-3))(model)
    trained = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        if ".moe_mlp." in name:
            assert not p.requires_grad and id(p) not in trained, name
            assert p.dtype == (torch.float32 if name.endswith("router") else torch.bfloat16)


def test_program_key_takes_the_moe_config_and_aux_collections():
    """The MoE fields are part of the model's identity, and
    has_aux_collections joins the key: each difference is another slot."""
    clear_warm()
    try:
        _, tcfg = _llama_configs()

        def trainer(cfg, aux=False):
            return Trainer(Llama(cfg, device="meta"), swept_transform(adamw, learning_rate=1e-3),
                           next_token_loss, device="cpu", has_aux_collections=aux)

        slots = [trainer(tcfg)._slot, trainer(tcfg)._slot,
                 trainer(dataclasses.replace(tcfg, num_experts=2))._slot,
                 trainer(dataclasses.replace(tcfg, moe_top_k=1))._slot,
                 trainer(dataclasses.replace(tcfg, moe_capacity_factor=2.0))._slot,
                 trainer(tcfg, aux=True)._slot]
        assert slots[0] is slots[1]
        assert len({id(s) for s in slots}) == len({s.key for s in slots}) == 5
    finally:
        clear_warm()


def test_eager_step_objective_includes_the_aux_loss():
    """On the CPU the step is eager: its loss is the task loss plus the
    summed aux losses of that forward, and the gradient of the router
    comes from both."""
    _, _, model = _llama_pair()
    t = torch.as_tensor(_tokens(3), dtype=torch.long)
    with torch.no_grad(), sowing_losses() as sown:
        expected = next_token_loss(model(t), t) + sown[0] + sown[1]
    trainer = Trainer(model, adamw(0.0), lambda logits, b: next_token_loss(logits, b["tokens"]),
                      device="cpu").init(state_dict=model.state_dict())
    loss = trainer.step({"inputs": (t,), "tokens": t})
    assert float(loss) == pytest.approx(float(expected), abs=1e-6)
    assert float(trainer.aux_loss) == pytest.approx(float(sown[0] + sown[1]), abs=1e-7)
