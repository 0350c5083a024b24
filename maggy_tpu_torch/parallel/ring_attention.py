"""Ring attention: sequence/context parallelism over a "seq" mesh axis.

Counterpart of ``maggy_tpu/parallel/ring_attention.py`` (blockwise ring
attention, Liu et al. 2023). Q/K/V are sharded along the sequence across the
ranks of the "seq" axis; each rank keeps its Q shard and, over n ring steps,
receives the successive K/V shards of its neighbours
(``collectives.ring_shift``), merging partial attention with a stable
online softmax. Peak memory is O(S/n) a rank.

The JAX function takes the global arrays and ``shard_map`` hands each
device its shard; here every rank calls ``ring_attention`` with its own
shard [B, S/n, H, D] (``mesh.split_sequence`` takes it from a global
sequence, with the JAX error when S does not divide over n) and gets its
shard of the output.

Two inner-block implementations, as in the JAX package:

- **flash**: the port's flash kernels (``ops/attention.py``
  ``flash_block_fwd`` / ``flash_block_bwd``, CUDA C++ for Hopper; on a CPU
  tensor their plain versions) per (Q shard, K/V shard) pair, inside one
  ``torch.autograd.Function`` whose forward and backward are rings of their
  own (JAX ``:144-235``). The diagonal step is peeled out of the ring, so
  every kernel call has a static causal flag; off-diagonal visible shards
  run non-causal; a shard strictly in a rank's future launches nothing.
  Partial outputs merge by their log-sum-exps. The backward takes the
  global lse and delta = rowsum(dO * O); each block's gradient is then
  independent and additive, so dK/dV partials ride the ring with their
  shard and are home after n hops.
- **plain** (JAX "xla"): einsum blocks merged by running max and sum,
  differentiated by autograd (JAX ``_ring_xla_shard``, ``:80``). Every rank
  runs every block, a future one fully masked (its weight in the merge is
  exactly 0), and both K and V cross each hop in one autograd node, so the
  backward's hops run in one order on every rank.

``impl="auto"`` is flash for a CUDA tensor whose shard tiles the kernels
(S/n % 128 == 0, D in ``KERNEL_HEAD_DIMS``), plain otherwise; ``"flash"``
on a shape the kernels do not build raises.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from maggy_tpu_torch.ops.attention import (KERNEL_HEAD_DIMS, NEG_INF, _row_delta,
                                           flash_block_bwd, flash_block_fwd)
from maggy_tpu_torch.parallel import collectives


def resolve_seq_parallel_impl(seq_len: int, head_dim: int, impl: str, on_cuda: bool,
                              what: str) -> str:
    """Shared flash/plain dispatch of the ring's blocks and Ulysses' gathered
    sequence (JAX ``resolve_seq_parallel_impl``): ``seq_len`` is the length
    the kernel sees."""
    flash_ok = seq_len % 128 == 0 and head_dim in KERNEL_HEAD_DIMS
    if impl == "auto":
        return "flash" if flash_ok and on_cuda else "plain"
    if impl == "flash" and not flash_ok:
        raise ValueError("impl='flash' needs {} divisible by 128 and D in {}; got {}, D={}".format(
            what, KERNEL_HEAD_DIMS, seq_len, head_dim))
    if impl not in ("flash", "plain"):
        raise ValueError("impl must be 'auto', 'flash' or 'plain', got {!r}".format(impl))
    return impl


def _group_rank(group):
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


# ---------------------------------------------------------------- plain path


def _block_attend(q, k, v, q_offset, k_offset, causal, sm_scale):
    """Online-softmax partial attention of one (Q shard, K/V shard) pair:
    (acc [B,Sq,H,D], m [B,Sq,H], l [B,Sq,H]), all fp32."""
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return acc, m.transpose(1, 2), p.sum(-1).transpose(1, 2)


def _merge(acc1, m1, l1, acc2, m2, l2):
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return acc1 * a1[..., None] + acc2 * a2[..., None], m, l1 * a1 + l2 * a2


class _Shift(torch.autograd.Function):
    """One hop of K and V together; its backward is the reverse hop of their
    gradients (JAX differentiates ``ppermute`` the same way)."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        ctx.like = [(t.shape, t.dtype, t.device) for t in (k, v)]
        return tuple(t.clone() for t in collectives.ring_shift([k, v], group))

    @staticmethod
    def backward(ctx, dk, dv):
        grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None else g.contiguous()
                 for g, (shape, dtype, device) in zip((dk, dv), ctx.like)]
        back = collectives.ring_shift(grads, ctx.group, direction=-1)
        return back[0].clone(), back[1].clone(), None


def _ring_plain_shard(q, k, v, group, causal):
    idx, n = _group_rank(group)
    B, shard, H, D = q.shape
    sm_scale = 1.0 / math.sqrt(D)
    q_off = idx * shard
    acc = torch.zeros(B, shard, H, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, shard, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, shard, H, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        # k_cur started at `idx` and moved back `step` times.
        origin = (idx + step) % n
        a2, m2, l2 = _block_attend(q, k_cur, v_cur, q_off, origin * shard, causal, sm_scale)
        acc, m, l = _merge(acc, m, l, a2, m2, l2)
        if step < n - 1:
            k_cur, v_cur = _Shift.apply(k_cur, v_cur, group)
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


# ---------------------------------------------------------------- flash path


def _merge_lse(o1, lse1, o2, lse2):
    """Merge two NORMALIZED partial outputs by their log-sum-exps.
    o: [B,S,H,D] fp32; lse: [B,H,S] fp32."""
    m = torch.maximum(lse1, lse2)
    w1, w2 = torch.exp(lse1 - m), torch.exp(lse2 - m)
    denom = w1 + w2

    def wt(w):
        return (w / denom).transpose(1, 2)[..., None]

    return o1 * wt(w1) + o2 * wt(w2), m + torch.log(denom)


class _RingFlash(torch.autograd.Function):
    """The flash ring's forward and backward (JAX ``_ring_flash_shard``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        idx, n = _group_rank(group)
        # Step 0 is peeled: the resident K/V shard is the diagonal block,
        # the only one that needs the triangular mask.
        o, lse = flash_block_fwd(q, k, v, causal=causal)
        o = o.float()
        k_cur, v_cur = k, v
        for step in range(1, n):
            k_cur, v_cur = collectives.ring_shift([k_cur, v_cur], group)
            origin = (idx + step) % n
            # Visible iff the shard is strictly in the past (causal) or
            # always (full attention).
            if not causal or origin < idx:
                o2, lse2 = flash_block_fwd(q, k_cur, v_cur, causal=False)
                o, lse = _merge_lse(o, lse, o2.float(), lse2)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        idx, n = _group_rank(group)
        do = do.contiguous()
        delta = _row_delta(do, out)
        dq, dk, dv = flash_block_bwd(q, k, v, do, lse, delta, causal=causal)
        k_cur, v_cur = k, v
        for step in range(1, n):
            # The partials ride with their shard: after this hop the rank
            # holds shard idx + step and the sum of its earlier partials.
            k_cur, v_cur, dk, dv = collectives.ring_shift([k_cur, v_cur, dk, dv], group)
            origin = (idx + step) % n
            if not causal or origin < idx:
                dq2, dk2, dv2 = flash_block_bwd(q, k_cur, v_cur, do, lse, delta, causal=False)
                dq += dq2
                dk += dk2
                dv += dv2
        if n > 1:
            # The n-th hop brings each shard's gradient home.
            dk, dv = collectives.ring_shift([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


# ------------------------------------------------------------------- public


def ring_attention(q, k, v, group=None, causal: bool = True, impl: str = "auto"):
    """Sequence-parallel attention of this rank's shards: q [B, S/n, H, D],
    k/v [B, S/n, Hkv, D] (GQA: Hkv divides H), the shards of global
    sequences split over ``group`` (the "seq" axis' process group; None
    is a ring of one) in group-rank order. Returns this rank's shard of
    the output, [B, S/n, H, D] in q's dtype.

    ``impl``: "flash" (the flash kernels and the ring backward), "plain"
    (einsum blocks, autograd) or "auto" (flash for a CUDA tensor whose shard
    tiles, plain otherwise)."""
    B, shard, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError("H={} not divisible by Hkv={}".format(H, Hkv))
    if k.shape[:2] != (B, shard) or v.shape != k.shape:
        raise ValueError("k and v must be [B, S/n, Hkv, D] shards like q; got q {}, k {}, "
                         "v {}".format(tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    impl = resolve_seq_parallel_impl(shard, D, impl, q.is_cuda, "S/n")
    if impl == "flash":
        return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(), group, causal)
    return _ring_plain_shard(q, k, v, group, causal)
