"""Ulysses-style sequence parallelism: all-to-all head/sequence swap.

Counterpart of ``maggy_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses,
arXiv:2309.14509). Inputs arrive sharded on the sequence; one all-to-all
re-shards them on heads, every rank runs full-sequence attention for its
head subset, and a second all-to-all swaps back. Two collectives a call
(against the ring's n - 1 hops), and the single-device flash kernels run
unmodified on the gathered sequence, causal handling included; the degree
is capped by the KV-head count. As with ``ring_attention``, each rank passes
its own shard [B, S/n, H, D] and gets its output shard.

The two swaps are ``collectives.all_to_all``. Each is one autograd node
(the inputs' swap carries q, k and v together), whose backward is the
inverse swap, so every rank runs the backward's collectives in one order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from maggy_tpu_torch.ops.attention import attention_reference, flash_attention
from maggy_tpu_torch.parallel import collectives
from maggy_tpu_torch.parallel.ring_attention import resolve_seq_parallel_impl


def _seq_to_heads(x, group, n):
    """[B, s, H, D] shards -> [B, n*s, H/n, D]: head chunk j of every rank
    goes to rank j, which concatenates the sequence in rank order."""
    B, s, H, D = x.shape
    send = x.reshape(B, s, n, H // n, D).permute(2, 0, 1, 3, 4)
    recv = collectives.all_to_all(send, group)  # [n (source = seq shard), B, s, H/n, D]
    return recv.permute(1, 0, 2, 3, 4).reshape(B, n * s, H // n, D)


def _heads_to_seq(x, group, n):
    """The inverse: [B, n*s, H/n, D] -> [B, s, H, D]."""
    B, S, h, D = x.shape
    send = x.reshape(B, n, S // n, h, D).permute(1, 0, 2, 3, 4)
    recv = collectives.all_to_all(send, group)  # [n (source = head chunk), B, s, h, D]
    return recv.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * h, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n):
        ctx.group, ctx.n = group, n
        return tuple(_seq_to_heads(x, group, n) for x in (q, k, v))

    @staticmethod
    def backward(ctx, dq, dk, dv):
        return tuple(_heads_to_seq(g.contiguous(), ctx.group, ctx.n)
                     for g in (dq, dk, dv)) + (None, None)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _heads_to_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group, ctx.n), None, None


def ulysses_attention(q, k, v, group=None, causal: bool = True, impl: str = "auto"):
    """Sequence-parallel attention via head/sequence all-to-all.

    q: [B, S/n, H, D], k/v: [B, S/n, Hkv, D] (GQA: Hkv divides H): this
    rank's shards of global sequences split over ``group`` (None: one
    rank). The degree n must divide Hkv (each rank needs whole KV heads
    after the swap). ``impl``: "flash" (the port's flash kernels on the
    gathered sequence), "plain" (``attention_reference``) or "auto" (flash
    for a CUDA tensor whose global S tiles)."""
    B, s, H, D = q.shape
    Hkv = k.shape[2]
    n = 1 if group is None else dist.get_world_size(group)
    if H % Hkv:
        raise ValueError("H={} not divisible by Hkv={}".format(H, Hkv))
    if Hkv % n:
        raise ValueError(
            "Ulysses needs the KV-head count ({}) divisible by the 'seq' degree ({}); use "
            "ring_attention for more shards than heads.".format(Hkv, n))
    impl = resolve_seq_parallel_impl(s * n, D, impl, q.is_cuda, "S")
    if n > 1:
        q, k, v = _SeqToHeads.apply(q, k, v, group, n)
    if impl == "flash":
        out = flash_attention(q, k, v, None, causal)
    else:
        out = attention_reference(q, k, v, causal=causal)
    out = out.to(q.dtype)
    return _HeadsToSeq.apply(out, group, n) if n > 1 else out
