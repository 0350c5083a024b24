"""The port's flash attention (plain versions, CPU) against the JAX package's
``attention_reference`` and its Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and fed to both sides. Tolerances as
tests/test_models.py: fp32, 1e-4 forward and 1e-3 gradients. The head dims
follow the JAX rule (D >= 64, D % 8 == 0): 72 and 120 leave a half k16 step
(D % 16 == 8), 80 is H2O-Danube-1.8B's, 256 the largest per-width build's;
264 (a slice of 8 columns), 320 (a D chunk of 0 mod 64 != D) and 512 run on
the card's split-D kernels, whose arithmetic the plain versions repeat. The
CUDA kernels themselves run only on the card (chip_smoke.py, and the
card-only test at the end, which skips here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maggy_tpu.ops import attention as jax_attn
from maggy_tpu_torch.ops import attention as A
from maggy_tpu_torch.ops import build
from maggy_tpu_torch.parallel.ring_attention import resolve_seq_parallel_impl

# Each test bounded (a test that hangs fails alone instead of cutting the
# whole run); the tests that set their own, longer bound keep it.
pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

FWD_TOL = 1e-4
GRAD_TOL = 1e-3

# (B, Sq, Sk, H, Hkv, D, causal, mask): "pad" gives every row its own true
# length and the last batch row no key at all.
CASES = {
    "pad_all_masked_row": (2, 128, 128, 2, 2, 64, False, "pad"),
    "causal_gqa_d128": (1, 128, 128, 4, 2, 128, True, None),
    # The Llama path's mode (causal, unpadded, GQA, D=128) across three
    # 128-key skip tiles.
    "causal_gqa_d128_s384": (1, 384, 384, 4, 2, 128, True, None),
    "causal_sq_ne_sk": (1, 128, 256, 2, 2, 64, True, None),
    "gqa_pad_s256": (2, 256, 256, 4, 2, 64, False, "pad"),
    # Every head dim the kernels take, by the rule: causal GQA across two
    # skip tiles, and key padding with a fully masked row.
    **{"causal_gqa_d{}_s256".format(D): (1, 256, 256, 4, 2, D, True, None)
       for D in (72, 80, 120, 256, 264, 320, 512)},
    **{"pad_all_masked_row_d{}".format(D): (2, 128, 128, 2, 2, D, False, "pad")
       for D in (72, 80, 120, 256, 264, 320, 512)},
    "causal_sq_ne_sk_d120": (1, 128, 384, 4, 2, 120, True, None),
}


def _inputs(B, Sq, Sk, H, Hkv, D, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    keep = None
    if mask_kind == "pad":
        lens = rng.integers(16, Sk + 1, size=B)
        lens[-1] = 0
        keep = np.arange(Sk)[None, :] < lens[:, None]
    return q, k, v, keep


def _jax_grads(fn, q, k, v):
    out = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = jax.grad(lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) ** 2), (0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(q, k, v, keep, causal):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    mask = None if keep is None else torch.tensor(keep)
    out = A.flash_attention(qt, kt, vt, mask, causal)
    grads = torch.autograd.grad((out ** 2).sum(), (qt, kt, vt))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _maxdiff(a, b, rows=None):
    d = np.abs(a - b)
    return float(d[rows].max() if rows is not None else d.max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_jax_reference(case):
    B, Sq, Sk, H, Hkv, D, causal, mask_kind = CASES[case]
    q, k, v, keep = _inputs(B, Sq, Sk, H, Hkv, D, mask_kind)
    jmask = None if keep is None else jnp.asarray(keep)[:, None, None, :]
    ref_out, ref_grads = _jax_grads(
        lambda q_, k_, v_: jax_attn.attention_reference(q_, k_, v_, causal=causal, mask=jmask),
        q, k, v)
    out, grads = _port_grads(q, k, v, keep, causal)
    assert out.shape == ref_out.shape and np.isfinite(out).all()
    assert _maxdiff(out, ref_out) < FWD_TOL
    for g, rg in zip(grads, ref_grads):
        assert g.shape == rg.shape
        assert _maxdiff(g, rg) < GRAD_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_pallas_interpret(case):
    """Against the Pallas kernels run in interpret mode. On batch rows whose
    keys are ALL masked the Pallas backward differs from its own reference
    (it recomputes p = exp(s - lse) = 1 per key instead of 1/Sk, and gives
    masked logits a gradient), so gradients of those rows are compared with
    ``attention_reference`` by the test above and left out here."""
    B, Sq, Sk, H, Hkv, D, causal, mask_kind = CASES[case]
    q, k, v, keep = _inputs(B, Sq, Sk, H, Hkv, D, mask_kind)
    jkeep = None if keep is None else jnp.asarray(keep)
    pl_out, pl_grads = _jax_grads(
        lambda q_, k_, v_: jax_attn.flash_attention(q_, k_, v_, jkeep, causal, 128, 128, True),
        q, k, v)
    out, grads = _port_grads(q, k, v, keep, causal)
    assert _maxdiff(out, pl_out) < FWD_TOL
    rows = None if keep is None else np.flatnonzero(keep.any(axis=1))
    for g, pg in zip(grads, pl_grads):
        assert _maxdiff(g, pg, rows) < GRAD_TOL


@pytest.mark.parametrize("case", ["causal_pad_s256", "causal_pad_sq_ne_sk"])
def test_causal_padded_all_masked_row_matches_pallas(case):
    """Causal attention over a batch row whose keys are all padding. The
    Pallas kernels (128 x 128 tiles, as the JAX package's
    multi_head_attention calls them) average V over the keys of the
    unskipped 128-key tiles; the port must give the same forward on every
    row. This case cannot join test_plain_flash_matches_jax_reference:
    attention_reference averages a fully masked row over all Sk keys.
    Gradients of live rows are held against the Pallas backward; those of
    the fully masked row against autograd through the port's plain forward,
    since the Pallas backward is wrong on such rows."""
    B, Sq, Sk, H, Hkv, D = {"causal_pad_s256": (2, 256, 256, 2, 2, 64),
                            "causal_pad_sq_ne_sk": (2, 128, 384, 4, 2, 64)}[case]
    q, k, v, keep = _inputs(B, Sq, Sk, H, Hkv, D, "pad", seed=5)
    jkeep = jnp.asarray(keep)
    pl_out, pl_grads = _jax_grads(
        lambda q_, k_, v_: jax_attn.flash_attention(q_, k_, v_, jkeep, True, 128, 128, True),
        q, k, v)
    out, grads = _port_grads(q, k, v, keep, True)
    assert np.isfinite(out).all()
    assert _maxdiff(out, pl_out) < FWD_TOL
    for g, pg in zip(grads, pl_grads):
        assert _maxdiff(g, pg, slice(0, B - 1)) < GRAD_TOL

    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    plain_out, _ = A._plain_fwd(qt, kt, vt, torch.tensor(keep.astype(np.int32)), True)
    plain_grads = torch.autograd.grad((plain_out ** 2).sum(), (qt, kt, vt))
    for g, pg in zip(grads, plain_grads):
        assert _maxdiff(g, pg.numpy(), B - 1) < GRAD_TOL


@pytest.mark.parametrize("D", [56, 80, 84, 120, 256, 264])
def test_mha_unbuilt_head_dim_goes_to_reference(D):
    """The head-dim rule of both packages' dispatch. D=56 and 84 are outside
    it (D < 64, D % 8 != 0): forcing the kernels raises in both, and the
    dispatch sends them to the reference. 80, 120, 256 and 264 are inside:
    ``force="flash"`` runs the port's plain versions (the card's kernels'
    arithmetic; 264 that of the split-D kernels, on the card the
    card-only test below) and matches JAX's Pallas kernels in interpret
    mode."""
    q, k, v, keep = _inputs(2, 128, 128, 2, 2, D, "pad")
    m4 = keep[:, None, None, :]
    args = [torch.tensor(x) for x in (q, k, v)]
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    ref = jax_attn.attention_reference(*jargs, causal=True, mask=jnp.asarray(m4))
    if not A.flash_head_dim_ok(D):
        with pytest.raises(ValueError, match=r"^force='flash'.*D>=64 with D%8==0"):
            A.multi_head_attention(*args, causal=True, mask=torch.tensor(m4), force="flash")
        with pytest.raises(ValueError, match=r"^force='flash'"):
            jax_attn.multi_head_attention(*jargs, causal=True, mask=jnp.asarray(m4),
                                          force="flash")
        out = A.multi_head_attention(*args, causal=True, mask=torch.tensor(m4))
        j_out = jax_attn.multi_head_attention(*jargs, causal=True, mask=jnp.asarray(m4))
        assert _maxdiff(np.asarray(j_out), np.asarray(ref)) < FWD_TOL
    else:
        out = A.multi_head_attention(*args, causal=True, mask=torch.tensor(m4), force="flash")
        j_out = jax_attn.multi_head_attention(*jargs, causal=True, mask=jnp.asarray(m4),
                                              force="flash")
        assert out.shape == (2, 128, 2, D)
        assert _maxdiff(out.numpy(), np.asarray(j_out)) < FWD_TOL
    # At Sk = 128 (one skip tile) the kernels' fully masked row averages V
    # over every key, as the reference does.
    assert _maxdiff(out.numpy(), np.asarray(ref)) < FWD_TOL


@pytest.mark.parametrize("D", [56, 64, 72, 80, 84, 96, 120, 128, 248, 256, 264])
def test_seq_parallel_dispatch_matches_jax(D):
    """The ring's and Ulysses' flash/plain choice against JAX's
    ``resolve_seq_parallel_impl`` over a grid of lengths: a CUDA tensor
    in the port stands where the Pallas kernels run in JAX (interpret mode
    here), a CPU tensor where they do not; "plain" is JAX's "xla"."""
    names = {"xla": "plain", "flash": "flash"}
    for seq_len in (64, 128, 200, 256, 384, 4096):
        for impl in ("auto", "flash", "plain"):
            for on_cuda in (True, False):
                try:
                    want = names[jax_attn.resolve_seq_parallel_impl(
                        seq_len, D, "xla" if impl == "plain" else impl, on_cuda, "S")]
                except ValueError as e:
                    assert str(e).startswith("impl='flash' needs S divisible by 128")
                    with pytest.raises(ValueError, match="impl='flash' needs S divisible"):
                        resolve_seq_parallel_impl(seq_len, D, impl, on_cuda, "S")
                    continue
                assert resolve_seq_parallel_impl(seq_len, D, impl, on_cuda, "S") == want, (
                    seq_len, impl, on_cuda)


def test_kernel_widths_cover_the_rule_and_each_has_a_build():
    """Every D of the rule up to 1024 maps to a build: up to
    MAX_WIDTH_HEAD_DIM the least multiple of 16 >= D, above it the split-D
    build; every such build exists and no other, and a D outside the rule
    raises."""
    dims = [D for D in range(8, 1025, 8) if A.flash_head_dim_ok(D)]
    assert dims[0] == 64
    used = set()
    for D in dims:
        name = A.kernel_build(D)
        if D <= A.MAX_WIDTH_HEAD_DIM:
            w = int(name[1:])
            assert name == "w{}".format(w) and w >= D and w - 16 < D and w % 16 == 0
        else:
            assert name == "split"
        used.add(name)
    assert sorted(used) == sorted(v for _, v in build.builds())
    assert build.builds()[-1] == ("flash_attn.cu", "split")
    assert all(s == "flash_attn.cu" for s, _ in build.builds())
    for D in (56, 84, 260):
        with pytest.raises(ValueError, match=r"head_dim >= 64 with head_dim % 8 == 0"):
            A.kernel_build(D)
    with pytest.raises(ValueError, match="builds as"):
        build.compile_source("flash_attn.cu")


def _block_building_blocks_match_pallas(D, H, Hkv):
    q, k, v, _ = _inputs(1, 128, 256, H, Hkv, D, None, seed=3)
    do = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    j_out, j_lse = jax_attn.flash_block_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=True, interpret=True)
    out, lse = A.flash_block_fwd(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True)
    assert _maxdiff(out.numpy(), np.asarray(j_out)) < FWD_TOL
    assert _maxdiff(lse.numpy(), np.asarray(j_lse)) < FWD_TOL
    delta = (do * out.numpy()).sum(-1).transpose(0, 2, 1)
    j_grads = jax_attn.flash_block_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do), j_lse,
        jnp.asarray(delta), causal=True, interpret=True)
    grads = A.flash_block_bwd(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              torch.tensor(do), lse, torch.tensor(delta), causal=True)
    for g, jg in zip(grads, j_grads):
        assert g.dtype == torch.float32
        assert _maxdiff(g.numpy(), np.asarray(jg)) < GRAD_TOL


def test_block_building_blocks_match_pallas():
    """flash_block_fwd/bwd (external lse/delta, fp32 gradients) against the
    JAX package's, both in their CPU forms."""
    _block_building_blocks_match_pallas(64, 4, 2)


def test_block_building_blocks_match_pallas_split_d():
    """The same at D = 320, a head dim of the split-D kernels (three column
    slices, the last of 64 columns) on the card."""
    _block_building_blocks_match_pallas(320, 2, 1)


FUSED_CASES = dict(CASES, causal_pad_s256=(2, 256, 256, 2, 2, 64, True, "pad"))


def _bwd_inputs(case, seed=6):
    """CPU tensors for one backward call: q, k, v, dO, the int32 mask, the
    causal flag, and the forward's out and lse."""
    B, Sq, Sk, H, Hkv, D, causal, mask_kind = FUSED_CASES[case]
    q, k, v, keep = _inputs(B, Sq, Sk, H, Hkv, D, mask_kind, seed)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)
    mask = None if keep is None else torch.tensor(keep.astype(np.int32))
    qt, kt, vt, dot = (torch.tensor(x) for x in (q, k, v, do))
    out, lse = A.flash_fwd(qt, kt, vt, mask, causal)
    return qt, kt, vt, dot, mask, causal, out, lse


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_dq_fused_delta_matches_delta_in(case):
    """Given the forward's output, flash_bwd_dq returns delta = rowsum(dO*O)
    beside dq: the same dq as given that delta, the same delta as
    ``_row_delta``."""
    q, k, v, do, mask, causal, out, lse = _bwd_inputs(case)
    dq_f, delta_f = A.flash_bwd_dq(q, k, v, do, lse, None, mask, causal, out=out)
    delta = A._row_delta(do, out)
    dq = A.flash_bwd_dq(q, k, v, do, lse, delta, mask, causal)
    B, Sq, H, _ = q.shape
    assert delta_f.shape == (B, H, Sq) and delta_f.dtype == torch.float32
    assert _maxdiff(delta_f.numpy(), delta.numpy()) <= 1e-6
    assert dq_f.shape == q.shape and _maxdiff(dq_f.numpy(), dq.numpy()) <= 1e-6


@pytest.mark.parametrize("case", ["causal_gqa_d128", "causal_sq_ne_sk"])
def test_dq_fused_delta_matches_jax_block_bwd(case):
    """The fused delta against the JAX package's sum(dO * O), and dq against
    its flash_block_bwd (Pallas, interpret mode) given that delta."""
    q, k, v, do, mask, causal, out, lse = _bwd_inputs(case)
    assert mask is None  # the block building block takes no mask
    dq_f, delta_f = A.flash_bwd_dq(q, k, v, do, lse, None, mask, causal, out=out)
    j_delta = jnp.sum(jnp.asarray(do.numpy()) * jnp.asarray(out.numpy()), -1).transpose(0, 2, 1)
    assert _maxdiff(delta_f.numpy(), np.asarray(j_delta)) < GRAD_TOL
    j_dq, _, _ = jax_attn.flash_block_bwd(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, do, lse)), j_delta, causal=causal,
        interpret=True)
    assert _maxdiff(dq_f.numpy(), np.asarray(j_dq)) < GRAD_TOL


@pytest.mark.parametrize("given", ["both", "neither"])
def test_dq_takes_exactly_one_of_delta_and_out(given):
    q, k, v, do, mask, causal, out, lse = _bwd_inputs("pad_all_masked_row")
    both = given == "both"
    with pytest.raises(ValueError, match="exactly one of delta and out"):
        A.flash_bwd_dq(q, k, v, do, lse, A._row_delta(do, out) if both else None, mask,
                       causal, out=out if both else None)


def test_backward_runs_fused_dq_then_dkdv(monkeypatch):
    """The autograd backward asks dQ for delta and hands that delta to
    dK/dV: no separate delta pass."""
    calls = []
    fused_dq, dkdv = A.flash_bwd_dq, A.flash_bwd_dkdv

    def record_dq(*args, **kwargs):
        calls.append(("dq", args[5] is None and kwargs.get("out") is not None))
        result = fused_dq(*args, **kwargs)
        calls.append(("delta", result[1]))
        return result

    def record_dkdv(*args, **kwargs):
        calls.append(("dkdv", args[5]))
        return dkdv(*args, **kwargs)

    monkeypatch.setattr(A, "flash_bwd_dq", record_dq)
    monkeypatch.setattr(A, "flash_bwd_dkdv", record_dkdv)
    q, k, v, _, mask, causal, _, _ = _bwd_inputs("pad_all_masked_row")
    q.requires_grad_()
    A.flash_attention(q, k, v, mask, causal).sum().backward()
    assert [c[0] for c in calls] == ["dq", "delta", "dkdv"]
    assert calls[0][1] and calls[2][1] is calls[1][1]


def test_mha_on_cpu_never_launches_a_kernel():
    q, k, v, keep = _inputs(2, 128, 128, 2, 2, 64, "pad")
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    m4 = torch.tensor(keep)[:, None, None, :]
    A.reset_launch_counts()
    ref = A.multi_head_attention(qt, kt, vt, causal=False, mask=m4)
    flash = A.multi_head_attention(qt, kt, vt, causal=False, mask=m4, force="flash")
    assert A.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    assert _maxdiff(ref.numpy(), flash.numpy()) < FWD_TOL


def test_mha_force_flash_rejects_per_query_mask():
    q, k, v, _ = _inputs(1, 128, 128, 2, 2, 64, None)
    per_query = torch.ones(128, 128, dtype=torch.bool).tril()
    with pytest.raises(ValueError, match="force='flash'"):
        A.multi_head_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                               mask=per_query, force="flash")
    # Without force it falls back to the reference, which broadcasts it.
    out = A.multi_head_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 causal=False, mask=per_query)
    ref = jax_attn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=False, mask=jnp.asarray(per_query.numpy()))
    assert _maxdiff(out.numpy(), np.asarray(ref)) < FWD_TOL


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card never takes the
    plain path silently."""
    q = torch.empty(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_fwd(q, q, q, None, True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("D", [64, 72, 80, 120, 128, 200, 256, 264, 512])
def test_kernels_match_plain_versions_on_card(cuda_device, D):
    """fp32 kernels against the plain versions; 264 and 512 on the split-D
    kernels."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(2, 128, 4, D, device=cuda_device, generator=g)
                   for _ in range(4))
    mask = torch.ones(2, 128, dtype=torch.int32, device=cuda_device)
    mask[1, 100:] = 0
    A.reset_launch_counts()
    out, lse = A.flash_fwd(q, k, v, mask, False)
    p_out, p_lse = A._plain_fwd(q, k, v, mask, False)
    p_out = p_out.contiguous()
    delta = A._row_delta(do, p_out)
    dk, dv = A.flash_bwd_dkdv(q, k, v, do, p_lse, delta, mask, False)
    p_dk, p_dv = A._plain_bwd_dkdv(q, k, v, do, p_lse, delta, mask, False)
    dq = A.flash_bwd_dq(q, k, v, do, p_lse, delta, mask, False)
    p_dq = A._plain_bwd_dq(q, k, v, do, p_lse, delta, mask, False)
    dq_f, delta_f = A.flash_bwd_dq(q, k, v, do, p_lse, None, mask, False, out=p_out)
    torch.cuda.synchronize()
    assert A.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 2}
    for a, b in ((out, p_out), (lse, p_lse), (dk, p_dk), (dv, p_dv), (dq, p_dq),
                 (dq_f, p_dq), (delta_f, delta)):
        assert float((a - b).abs().max()) < FWD_TOL

