"""Llama parity: Flax params converted into the port, logits and hidden
states, RoPE, the chunked loss, and five LoRA training steps against the
JAX package, on a D=64 config (vocab 512, hidden 256, 4/2 heads, FFN 512,
two layers, LoRA rank 4, S=128) computing in fp32. Inputs come from numpy
seeds and go to both sides. Tolerances: 1e-4 on logits and hidden states
(fp32, sums in another order), 1e-5 on the loss and its gradients, loss
rel 1e-4 over five steps, as tests/test_torch_bert.py."""

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
from maggy_tpu.models.llama import rope as jax_rope
from maggy_tpu.ops.losses import chunked_next_token_loss as jax_chunked_loss
from maggy_tpu.ops.losses import chunked_softmax_xent as jax_xent
from maggy_tpu.parallel import make_mesh
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train.lora import lora_adapter_count as jax_lora_count
from maggy_tpu.train.lora import lora_mask, only_lora as jax_only_lora
from maggy_tpu_torch.models import Llama, LlamaConfig, LoRADense, rope
from maggy_tpu_torch.models.llama import flax_to_state_dict
from maggy_tpu_torch.ops import chunked_next_token_loss, chunked_softmax_xent, next_token_loss
from maggy_tpu_torch.train import Trainer, adamw, is_lora_param, lora_adapter_count, only_lora

# Each test bounded (a test that hangs fails alone instead of cutting the
# whole run); the tests that set their own, longer bound keep it.
pytestmark = [pytest.mark.torch, pytest.mark.timeout(150)]

B, S = 2, 128
VOCAB = 512
CHUNK = 200  # 512 = 200 + 200 + 112: the last chunk slides back and masks
OUT_TOL = 1e-4
LOSS_TOL = 1e-5
LOSS_RTOL = 1e-4


def _configs(**overrides):
    fields = dict(vocab_size=VOCAB, hidden_dim=256, intermediate_dim=512, num_layers=2,
                  num_heads=4, num_kv_heads=2, head_dim=64, max_seq_len=S, lora_rank=4)
    fields.update(overrides)
    return (JaxLlamaConfig(dtype=jnp.float32, **fields),
            LlamaConfig(dtype=torch.float32, **fields))


def _tokens(seed, n=B):
    return np.random.default_rng(seed).integers(0, VOCAB, size=(n, S)).astype(np.int32)


def _with_lora_b(params, seed=7):
    """``params`` with every ``lora_b`` drawn from numpy (Flax inits them to
    zero, which would leave the adapters out of the function)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "lora_b":
            return rng.normal(0.0, 0.05, size=x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _flax_params(jcfg):
    variables = jax.jit(JaxLlama(jcfg).init)(jax.random.key(0), jnp.ones((1, S), jnp.int32))
    return _with_lora_b(nn.meta.unbox(variables)["params"])


def _port_model(tcfg, params):
    model = Llama(tcfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    return model


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _maxdiff(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def test_converted_logits_and_hidden_match_flax():
    jcfg, tcfg = _configs()
    params = _flax_params(jcfg)
    tokens = _tokens(1)
    apply = jax.jit(JaxLlama(jcfg).apply, static_argnames="return_hidden")
    ref = apply({"params": params}, jnp.asarray(tokens))
    ref_h, ref_head = apply({"params": params}, jnp.asarray(tokens), return_hidden=True)
    model = _port_model(tcfg, params)
    t = torch.as_tensor(tokens, dtype=torch.long)
    with torch.no_grad():
        logits = model(t)
        hidden, head = model(t, return_hidden=True)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, VOCAB)
    assert _maxdiff(logits, ref) < OUT_TOL
    assert hidden.shape == ref_h.shape and _maxdiff(hidden, ref_h) < OUT_TOL
    assert head.shape == ref_head.shape and _maxdiff(head, ref_head) == 0.0


def test_rope_matches_jax_at_random_positions():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, 4, 64)).astype(np.float32)
    positions = rng.integers(0, 2048, size=(B, S))
    ref = jax_rope(jnp.asarray(x), jnp.asarray(positions), 500000.0)
    out = rope(torch.as_tensor(x), torch.as_tensor(positions), 500000.0)
    assert out.dtype == torch.float32
    assert _maxdiff(out, ref) < OUT_TOL
    # Split-half, not interleaved: position 0 is the identity, and the two
    # halves of D form the rotated pairs.
    zero = rope(torch.as_tensor(x), torch.zeros(B, S, dtype=torch.long), 500000.0)
    assert torch.equal(zero, torch.as_tensor(x))


@pytest.mark.parametrize("chunk", [128, 100, 4096])
def test_chunked_loss_matches_jax_value_and_grads(chunk):
    """Ragged (128: the last chunk slides), exact (100) and single-chunk
    vocabularies of 500, against the JAX scan in value and in gradient with
    respect to h and the head."""
    rng = np.random.default_rng(3)
    h = rng.normal(size=(300, 64)).astype(np.float32)
    kernel = rng.normal(0.0, 0.3, size=(64, 500)).astype(np.float32)
    targets = rng.integers(0, 500, size=300).astype(np.int32)
    ref, (ref_dh, ref_dk) = jax.value_and_grad(
        lambda h_, k_: jax_xent(h_, k_, jnp.asarray(targets), chunk), (0, 1))(
        jnp.asarray(h), jnp.asarray(kernel))
    ht, kt = (torch.tensor(x, requires_grad=True) for x in (h, kernel))
    loss = chunked_softmax_xent(ht, kt, torch.as_tensor(targets), chunk)
    dh, dk = torch.autograd.grad(loss, (ht, kt))
    assert abs(loss.item() - float(ref)) < LOSS_TOL
    assert _maxdiff(dh, ref_dh) < LOSS_TOL and _maxdiff(dk, ref_dk) < LOSS_TOL


def test_chunked_next_token_loss_matches_dense_and_jax():
    rng = np.random.default_rng(4)
    hidden = rng.normal(size=(B, S, 64)).astype(np.float32)
    kernel = rng.normal(0.0, 0.3, size=(64, VOCAB)).astype(np.float32)
    tokens = _tokens(5)
    ref = jax_chunked_loss(jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(tokens), CHUNK)
    ht, kt = (torch.tensor(x, requires_grad=True) for x in (hidden, kernel))
    tt = torch.as_tensor(tokens)
    loss = chunked_next_token_loss(ht, kt, tt, CHUNK)
    grads = torch.autograd.grad(loss, (ht, kt))
    dense = next_token_loss(ht @ kt, tt)
    dense_grads = torch.autograd.grad(dense, (ht, kt))
    assert abs(loss.item() - float(ref)) < LOSS_TOL
    assert abs(loss.item() - dense.item()) < LOSS_TOL
    for g, dg in zip(grads, dense_grads):
        assert _maxdiff(g, dg) < LOSS_TOL


def _jax_lora_tx(lr):
    """The JAX package's ``only_lora(optax.adamw(lr))`` with its masked-out
    (frozen) leaves' updates set to zero: ``optax.masked`` passes those
    updates through unchanged, so on its own it adds the raw gradient to the
    frozen base (see test_jax_only_lora_moves_frozen_leaves)."""
    frozen = lambda params: jax.tree_util.tree_map(lambda m: not m, lora_mask(params))  # noqa: E731
    return optax.chain(jax_only_lora(optax.adamw(lr)), optax.masked(optax.set_to_zero(), frozen))


def _loss_fns():
    return (lambda out, b: jax_chunked_loss(out[0], out[1], b["tokens"], CHUNK),
            lambda out, b: chunked_next_token_loss(out[0], out[1], b["tokens"], CHUNK))


def test_five_lora_trainer_steps_match_jax_trainer():
    jcfg, tcfg = _configs()
    lr, steps = 3e-3, 5
    jloss_fn, loss_fn = _loss_fns()
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jtrainer = JaxTrainer(JaxLlama(jcfg), _jax_lora_tx(lr), jloss_fn, mesh,
                          train_kwargs={"return_hidden": True}, warm_start=False)
    jtrainer.init(jax.random.key(0), (jnp.ones((1, S), jnp.int32),))
    jtrainer.variables = {"params": jax.tree_util.tree_map(
        jnp.asarray, _with_lora_b(jtrainer.variables["params"]))}
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jtrainer.variables["params"]))

    trainer = Trainer(Llama(tcfg, device="cpu"), only_lora(adamw(lr)), loss_fn, device="cpu",
                      train_kwargs={"return_hidden": True}).init(state_dict=state)
    for step in range(steps):
        tokens = _tokens(10 + step)
        jloss = float(jtrainer.step(jtrainer.place_batch(
            {"inputs": (tokens,), "tokens": tokens})))
        t = torch.as_tensor(tokens, dtype=torch.long)
        loss = float(trainer.step({"inputs": (t,), "tokens": t}))
        assert loss == pytest.approx(jloss, rel=LOSS_RTOL), step

    after = trainer.model.state_dict()
    moved = {name for name in state if not torch.equal(after[name], state[name])}
    assert moved and all(is_lora_param(name) for name in moved)
    assert {name for name in state if is_lora_param(name)} == moved
    jafter = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jtrainer.variables["params"]))
    for name in moved:
        assert _maxdiff(after[name], jafter[name]) < OUT_TOL, name


def test_jax_only_lora_moves_frozen_leaves():
    """Why the JAX side above masks its frozen updates to zero: the JAX
    package's ``only_lora`` (``optax.masked``) hands a frozen leaf its
    gradient as the update, so ``apply_updates`` moves the base by +grad."""
    params = {"kernel": jnp.ones((2, 2)), "lora_a": jnp.ones((2, 1))}
    grads = {"kernel": jnp.full((2, 2), 5.0), "lora_a": jnp.full((2, 1), 5.0)}
    tx = jax_only_lora(optax.adamw(0.1))
    updates, _ = tx.update(grads, tx.init(params), params)
    assert float(jnp.abs(updates["kernel"] - grads["kernel"]).max()) == 0.0
    fixed, _ = _jax_lora_tx(0.1).update(grads, _jax_lora_tx(0.1).init(params), params)
    assert float(jnp.abs(fixed["kernel"]).max()) == 0.0
    assert float(jnp.abs(fixed["lora_a"] - updates["lora_a"]).max()) == 0.0


def _loss_and_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    hidden, head = model(tokens, return_hidden=True)
    loss = chunked_next_token_loss(hidden, head, tokens, CHUNK)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_matches_no_remat():
    jcfg, tcfg = _configs()
    params = _flax_params(jcfg)
    tokens = torch.as_tensor(_tokens(6), dtype=torch.long)
    remat = _port_model(tcfg, params)
    plain = _port_model(dataclasses.replace(tcfg, remat=False), params)
    loss, grads = _loss_and_grads(remat, tokens)
    p_loss, p_grads = _loss_and_grads(plain, tokens)
    assert torch.equal(loss, p_loss)
    assert grads.keys() == p_grads.keys()
    for name in grads:
        assert torch.equal(grads[name], p_grads[name]), name


def test_remat_reruns_the_attention_forward_in_the_backward(monkeypatch):
    """With remat, a training step calls the flash forward twice per layer
    (forward, and again when the backward rematerializes the layer) and each
    backward kernel once: the launch counts chip_smoke.py expects on the
    card. The CPU wrappers run their plain versions, so calls are counted
    here by wrapping them."""
    from maggy_tpu_torch.models import llama as llama_module
    from maggy_tpu_torch.ops import attention as A

    calls = {}
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        def counted(*args, _f=getattr(A, name), _n=name, **kwargs):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*args, **kwargs)
        monkeypatch.setattr(A, name, counted)
    monkeypatch.setattr(llama_module, "multi_head_attention",
                        lambda q, k, v, causal, mask: A.multi_head_attention(
                            q, k, v, causal=causal, mask=mask, force="flash"))
    jcfg, tcfg = _configs()
    params = _flax_params(jcfg)
    tokens = torch.as_tensor(_tokens(9), dtype=torch.long)
    for remat, fwd in ((True, 2), (False, 1)):
        calls.clear()
        _loss_and_grads(_port_model(dataclasses.replace(tcfg, remat=remat), params), tokens)
        layers = tcfg.num_layers
        assert calls == {"flash_fwd": fwd * layers, "flash_bwd_dkdv": layers,
                         "flash_bwd_dq": layers}, remat


def test_only_lora_freezes_and_casts_the_base_in_place():
    """In bf16 the cast is exact for the function: every base parameter is
    read after a cast to the compute dtype, so outputs are bitwise equal
    before and after; only the adapters stay fp32 and trainable."""
    jcfg, tcfg = _configs()
    model = _port_model(dataclasses.replace(tcfg, dtype=torch.bfloat16), _flax_params(jcfg))
    tokens = torch.as_tensor(_tokens(8), dtype=torch.long)
    with torch.no_grad():
        before = model(tokens)
    optimizer, _ = only_lora(adamw(1e-3))(model)
    with torch.no_grad():
        after = model(tokens)
    assert torch.equal(before, after)
    trained = {id(p) for group in optimizer.param_groups for p in group["params"]}
    for name, p in model.named_parameters():
        lora = is_lora_param(name)
        assert p.requires_grad == lora and (id(p) in trained) == lora, name
        assert p.dtype == (torch.float32 if lora else torch.bfloat16), name
    assert lora_adapter_count(model) == sum(
        p.numel() for group in optimizer.param_groups for p in group["params"])


def test_llama3_8b_counts_match_jax_eval_shape():
    """The full model built on the meta device: parameter and adapter
    counts equal those of the JAX model's abstract init."""
    model = Llama(LlamaConfig.llama3_8b(lora_rank=16), device="meta")
    jcfg = JaxLlamaConfig.llama3_8b(lora_rank=16)
    abstract = jax.eval_shape(JaxLlama(jcfg).init, jax.random.key(0),
                              jax.ShapeDtypeStruct((1, 128), jnp.int32))
    params = nn.meta.unbox(abstract)["params"]
    n_jax = sum(leaf.size for leaf in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert 8.0e9 < n_jax < 8.1e9
    assert lora_adapter_count(model) == jax_lora_count(params)


def test_unported_options_raise():
    # The ring path is ported (tests/test_torch_llama_sp.py); as in the JAX
    # package it needs a mesh with a "seq" axis.
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="requires cfg.seq_mesh"):
        Llama(dataclasses.replace(tcfg, attention_impl="ring"), device="cpu")


def test_cuda_default_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Llama(_configs()[1])


def test_lora_dense_cuda_default_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tcfg = _configs()[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        LoRADense(8, 8, tcfg, 2)
    layer = LoRADense(8, 8, tcfg, 2, device="cpu")
    assert layer.weight.device.type == "cpu" and layer.lora_a.device.type == "cpu"
