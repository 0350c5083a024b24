"""Memory-efficient losses: vocab-chunked softmax cross-entropy.

Counterpart of ``maggy_tpu/ops/losses.py``. At Llama-3's 128256-token
vocabulary the fp32 logits of one [2, 2048] batch take 2.1 GB, and the
dense loss keeps them (and their softmax) for the backward.
``chunked_softmax_xent`` computes the same loss while only ever
materializing [N, vocab_chunk] logits: the forward keeps running
log-sum-exp statistics over vocabulary chunks, and the backward computes
each chunk's logits again instead of keeping them (the JAX package's
``jax.checkpoint`` on its scan body). Plain PyTorch: the JAX package
computes this outside any Pallas kernel. It runs under ``torch.func``
transforms as the JAX scan runs under ``jax.vmap``: in the vectorized
lanes (``train/vmap.py``) the batching rules fold the lanes into rows, so
K lanes over one frozen head take one pass of K x N rows.

``next_token_labels`` and ``sharded_next_token_loss`` are the loss of a
sequence split over the ranks of a "seq" axis (the JAX package leaves the
shift across shards to GSPMD). Under tensor parallelism the Llama hands
these losses its vocab-cut head as it is (``models/llama.py``), and
``chunked_softmax_xent`` runs vocab-parallel: each "model" rank computes
its columns' chunks, the max and the sums of exponentials are combined over
"model" (two all-reduces of [N] vectors), and the hidden states' gradient
is summed over it.

Numerics as in the JAX package: each chunk's logits are fp32 products of
operands in ``h``'s dtype (the head is cast to it). On a CUDA card a bf16
product runs as ``torch.mm(..., out_dtype=torch.float32)`` (tensor cores,
fp32 output); elsewhere as an fp32 product of the same rounded operands,
which is the same function summed in another order. The gradients' products
run in fp32, as JAX's transpose of a mixed-precision dot does, and are
summed over the chunks in fp32 (JAX's scan sums h's gradient in h's dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The flash Functions' batching-rule helpers: lanes folded into the leading
# (here: row) axis, an unbatched argument repeated, and unfolded after.
from maggy_tpu_torch.ops.attention import _fold, _unfold


def next_token_loss(logits, tokens):
    """Causal LM loss from dense logits [B, S, V]: predict tokens[t+1] from
    logits[t], mean softmax cross entropy in fp32."""
    V = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, V),
                           tokens[:, 1:].reshape(-1).long())


def _chunks(V: int, chunk: int):
    """(c0, cs) per chunk: the chunk owns columns [c0, c0+chunk) of [0, V);
    the ragged last chunk slides its start back to cs = V - chunk instead of
    padding the head, and masks the columns it does not own."""
    return [(c0, min(c0, V - chunk)) for c0 in range(0, V, chunk)]


def _chunk_logits(h, kernel, c0: int, cs: int, chunk: int):
    """fp32 logits of ``h`` against columns [cs, cs+chunk) of ``kernel``,
    both operands in ``h``'s dtype; columns below c0 (another chunk's) are
    -inf."""
    w = kernel[:, cs:cs + chunk].to(h.dtype)
    if h.is_cuda and h.dtype != torch.float32:
        logits = torch.mm(h, w, out_dtype=torch.float32)
    else:
        logits = h.float() @ w.float()
    if cs < c0:
        logits[:, :c0 - cs] = float("-inf")
    return logits


def _check_targets(targets, V: int) -> None:
    """Refuse a target outside [0, V), as ``F.cross_entropy`` does: a head
    whose vocab cut was lost on the way (a cast drops the note that
    ``parallel/sharded.py`` leaves on it) would otherwise give a wrong loss
    without a word. On the card a device-side assert, which needs no sync
    and so runs inside a captured step."""
    ok = (targets >= 0) & (targets < V)
    if targets.is_cuda:
        torch._assert_async(ok.all())
    elif not bool(ok.all()):
        raise ValueError("a target lies outside the head's {} classes; a head cut over "
                         "'model' must reach the loss as the model returned it".format(V))


def _lane(x, dim, i):
    """Lane ``i`` of a batching rule's argument (``x`` itself if unbatched)."""
    return x if dim is None else x.select(dim, i)


def _stack_lanes(fn, in_dims, args, lanes):
    """A batching rule's fallback: ``fn`` lane by lane, outputs stacked on
    dim 0."""
    outs = [fn(*(_lane(x, d, i) for x, d in zip(args, in_dims))) for i in range(lanes)]
    stacked = tuple(torch.stack(parts) for parts in zip(*outs))
    return stacked, (0,) * len(stacked)


class _ChunkedSoftmaxXent(torch.autograd.Function):
    """Each row's loss, log-sum-exp minus the target's logit, and the
    log-sum-exp itself (not differentiable): ``(rows [N], lse [N])``. With
    ``group``, ``kernel`` is this rank's vocab columns [v0, v0 + V_local)
    of a head cut over the group: the chunks' running statistics are
    combined over the group (the max, then the rescaled sums of
    exponentials and the target logits), and the backward sums the
    hidden states' gradient over it.

    New-style (``setup_context``), so that it runs under ``torch.func``
    transforms. Its ``vmap`` rule folds the lanes into rows: a kernel that
    is the same for every lane (a frozen head, unbatched) takes all K x N
    rows in one pass; a batched kernel runs lane by lane. The backward is
    ``_ChunkedSoftmaxXentBwd``, whose batching rule folds the same way."""

    @staticmethod
    def forward(h, kernel, targets, vocab_chunk, group=None, v0=0):
        N, V = h.shape[0], kernel.shape[1]
        chunk = min(vocab_chunk, V)
        tgt = targets.long() - v0
        if group is None:
            _check_targets(targets, V)
        else:
            import torch.distributed as dist

            _check_targets(targets, V * dist.get_world_size(group))
        m = torch.full((N,), float("-inf"), device=h.device)
        s = torch.zeros(N, device=h.device)
        t = torch.zeros(N, device=h.device)
        for c0, cs in _chunks(V, chunk):
            logits = _chunk_logits(h, kernel, c0, cs, chunk)
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            in_chunk = (tgt >= c0) & (tgt < min(c0 + chunk, V))
            picked = logits.gather(1, (tgt - cs).clamp(0, chunk - 1)[:, None])[:, 0]
            t = torch.where(in_chunk, picked, t)
            m = m_new
        if group is not None:
            from maggy_tpu_torch.parallel import collectives

            m_all = collectives.all_reduce_(m.clone(), group, dist.ReduceOp.MAX,
                                            kind="tp_loss_all_reduce")
            st = collectives.all_reduce_(torch.stack([s * torch.exp(m - m_all), t]), group,
                                         kind="tp_loss_all_reduce")
            m, s, t = m_all, st[0], st[1]
        lse = m + torch.log(s)
        return lse - t, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, kernel, targets, vocab_chunk, group, v0 = inputs
        ctx.save_for_backward(h, kernel, targets, output[1])
        ctx.chunk, ctx.group, ctx.v0 = min(vocab_chunk, kernel.shape[1]), group, v0
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, dlse):
        del dlse  # lse is not differentiable
        h, kernel, targets, lse = ctx.saved_tensors
        want_h, want_k = ctx.needs_input_grad[:2]
        grads = _ChunkedSoftmaxXentBwd.apply(h, kernel, targets, lse, g, ctx.chunk, ctx.group,
                                             ctx.v0, want_k)
        return (grads[0] if want_h else None, grads[1] if want_k else None,
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, h, kernel, targets, vocab_chunk, group, v0):
        K = info.batch_size
        if in_dims[1] is None:
            rows, lse = _ChunkedSoftmaxXent.apply(
                _fold(h, in_dims[0], K), kernel, _fold(targets, in_dims[2], K), vocab_chunk,
                group, v0)
            return (_unfold(rows, K), _unfold(lse, K)), (0, 0)
        return _stack_lanes(lambda h_, k_, t_: _ChunkedSoftmaxXent.apply(
            h_, k_, t_, vocab_chunk, group, v0), in_dims[:3], (h, kernel, targets), K)


class _ChunkedSoftmaxXentBwd(torch.autograd.Function):
    """The gradients of ``_ChunkedSoftmaxXent``'s rows given their
    cotangent ``g`` [N]: (dh,) or, with ``want_k``, (dh, dkernel). Each
    chunk's logits are computed again instead of kept. No backward: no
    path takes a second derivative."""

    @staticmethod
    def forward(h, kernel, targets, lse, g, chunk, group, v0, want_k):
        N, V = h.shape[0], kernel.shape[1]
        tgt = targets.long() - v0
        dh = torch.zeros(N, h.shape[1], device=h.device)
        dk = torch.zeros(kernel.shape, device=h.device) if want_k else None
        h32 = h.float() if want_k else None
        for c0, cs in _chunks(V, chunk):
            logits = _chunk_logits(h, kernel, c0, cs, chunk)
            # d row / d logits = softmax - onehot(target), times the row's g.
            p = torch.exp(logits - lse[:, None])
            # -1 at each target this chunk owns, with no data-dependent
            # index (a step captured as a CUDA graph cannot sync): the other
            # rows add -0.0, which leaves p as it is.
            in_chunk = (tgt >= c0) & (tgt < min(c0 + chunk, V))
            p.scatter_add_(1, (tgt - cs).clamp(0, chunk - 1)[:, None],
                           -in_chunk.to(p.dtype)[:, None])
            p *= g[:, None]
            dh.addmm_(p, kernel[:, cs:cs + chunk].to(h.dtype).float().T)
            if want_k:
                dk[:, cs:cs + chunk].addmm_(h32.T, p)
        if group is not None:
            from maggy_tpu_torch.parallel import collectives

            # Each rank's vocab columns give a partial sum of h's gradient.
            collectives.all_reduce_(dh, group, kind="tp_loss_grad_all_reduce")
        dh = dh.to(h.dtype)
        return (dh, dk.to(kernel.dtype)) if want_k else (dh,)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, h, kernel, targets, lse, g, chunk, group, v0, want_k):
        K = info.batch_size
        if in_dims[1] is None and not want_k:
            (dh,) = _ChunkedSoftmaxXentBwd.apply(
                _fold(h, in_dims[0], K), kernel, *(_fold(x, d, K) for x, d in
                                                   zip((targets, lse, g), in_dims[2:5])),
                chunk, group, v0, False)
            return (_unfold(dh, K),), (0,)
        return _stack_lanes(lambda *args: _ChunkedSoftmaxXentBwd.apply(
            *args, chunk, group, v0, want_k), in_dims[:5], (h, kernel, targets, lse, g), K)


def chunked_softmax_xent(h, kernel, targets, vocab_chunk: int = 16384):
    """Mean softmax cross-entropy of ``h @ kernel`` against ``targets``,
    without materializing the full [N, V] logits.

    h: [N, H] activations; kernel: [H, V] classifier weights; targets: [N]
    int class ids in [0, V). Equivalent to
    ``-mean(log_softmax(fp32(h @ kernel))[i, targets[i]])``. A kernel whose
    vocab dim is cut over "model" (a tensor-parallel Llama's head,
    ``parallel/sharded.py``) holds this rank's columns: the softmax is
    computed over the whole vocabulary across the "model" ranks
    (vocab-parallel), and the loss is the same on each."""
    from maggy_tpu_torch.parallel import sharded

    group = sharded.group_of(kernel, 1, "model")
    v0 = sharded.local_range(kernel, 1)[0] if group is not None else 0
    rows, _ = _ChunkedSoftmaxXent.apply(h, kernel, targets, int(vocab_chunk), group, v0)
    return rows.mean()


def chunked_next_token_loss(hidden, kernel, tokens, vocab_chunk: int = 16384):
    """Causal-LM next-token loss from pre-head activations: hidden [B, S, H]
    (``Llama(..., return_hidden=True)`` gives it with the head kernel
    [H, V]), tokens [B, S]. Matches ``next_token_loss(hidden @ kernel,
    tokens)`` with O(B*S*vocab_chunk) peak logits memory::

        trainer = Trainer(model, only_lora(adamw(lr)),
                          lambda out, batch: chunked_next_token_loss(
                              out[0], out[1], batch["tokens"]),
                          train_kwargs={"return_hidden": True})
    """
    H = hidden.shape[-1]
    h = hidden[:, :-1, :].reshape(-1, H)
    return chunked_softmax_xent(h, kernel, tokens[:, 1:].reshape(-1), vocab_chunk)


#: The label of a position with no next token (``F.cross_entropy``'s
#: default ignore index).
IGNORE_LABEL = -100


def next_token_labels(tokens):
    """labels[:, t] = tokens[:, t + 1], the last position IGNORE_LABEL. Shift
    the GLOBAL sequence, then shard it: a shard's last position takes its
    label from the next shard's first token."""
    tokens = torch.as_tensor(tokens)
    labels = torch.full(tokens.shape, IGNORE_LABEL, dtype=torch.long)
    labels[:, :-1] = tokens[:, 1:]
    return labels


def sharded_next_token_loss(hidden, kernel, labels, seq_shards: int = 1,
                            vocab_chunk: int = 16384):
    """Next-token loss of one rank's shard of a sequence split ``seq_shards``
    ways: hidden [B, s, H] and the head kernel [H, V] (``Llama(...,
    return_hidden=True)``), labels [B, s] from ``next_token_labels`` of the
    global tokens. Scaled so that its mean over the seq ranks (and any
    data ranks, whose batches are equal) is the global mean over the
    B * (S - 1) labelled positions (``next_token_loss`` of the whole
    sequence), which is what the mesh Trainer's average makes of it."""
    B, s, H = hidden.shape
    flat = labels.reshape(-1)
    keep = flat != IGNORE_LABEL
    mean = chunked_softmax_xent(hidden.reshape(-1, H)[keep], kernel, flat[keep], vocab_chunk)
    return mean * keep.sum() * seq_shards / (B * (s * seq_shards - 1))
