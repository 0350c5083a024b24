"""Memory-efficient losses: vocab-chunked softmax cross-entropy.

Counterpart of ``maggy_tpu/ops/losses.py``. At Llama-3's 128256-token
vocabulary the fp32 logits of one [2, 2048] batch take 2.1 GB, and the
dense loss keeps them (and their softmax) for the backward.
``chunked_softmax_xent`` computes the same loss while only ever
materializing [N, vocab_chunk] logits: the forward keeps running
log-sum-exp statistics over vocabulary chunks, and the backward computes
each chunk's logits again instead of keeping them (the JAX package's
``jax.checkpoint`` on its scan body). Plain PyTorch: the JAX package
computes this outside any Pallas kernel.

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


class _ChunkedSoftmaxXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, kernel, targets, vocab_chunk):
        N, V = h.shape[0], kernel.shape[1]
        chunk = min(vocab_chunk, V)
        tgt = targets.long()
        m = torch.full((N,), float("-inf"), device=h.device)
        s = torch.zeros(N, device=h.device)
        t = torch.zeros(N, device=h.device)
        for c0, cs in _chunks(V, chunk):
            logits = _chunk_logits(h, kernel, c0, cs, chunk)
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            in_chunk = (tgt >= c0) & (tgt < c0 + chunk)
            picked = logits.gather(1, (tgt - cs).clamp(0, chunk - 1)[:, None])[:, 0]
            t = torch.where(in_chunk, picked, t)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(h, kernel, tgt, lse)
        ctx.chunk = chunk
        return (lse - t).mean()

    @staticmethod
    def backward(ctx, g):
        h, kernel, tgt, lse = ctx.saved_tensors
        chunk = ctx.chunk
        N, V = h.shape[0], kernel.shape[1]
        rows = torch.arange(N, device=h.device)
        want_h, want_k = ctx.needs_input_grad[:2]
        dh = torch.zeros(N, h.shape[1], device=h.device) if want_h else None
        dk = torch.zeros(kernel.shape, device=h.device) if want_k else None
        h32 = h.float() if want_k else None
        for c0, cs in _chunks(V, chunk):
            logits = _chunk_logits(h, kernel, c0, cs, chunk)
            # d loss / d logits = (softmax - onehot(target)) * g / N.
            p = torch.exp(logits - lse[:, None])
            in_chunk = (tgt >= c0) & (tgt < c0 + chunk)
            p[rows[in_chunk], (tgt - cs)[in_chunk]] -= 1.0
            p *= g / N
            if want_h:
                dh.addmm_(p, kernel[:, cs:cs + chunk].to(h.dtype).float().T)
            if want_k:
                dk[:, cs:cs + chunk].addmm_(h32.T, p)
        return (dh.to(h.dtype) if want_h else None,
                dk.to(kernel.dtype) if want_k else None, None, None)


def chunked_softmax_xent(h, kernel, targets, vocab_chunk: int = 16384):
    """Mean softmax cross-entropy of ``h @ kernel`` against ``targets``,
    without materializing the full [N, V] logits.

    h: [N, H] activations; kernel: [H, V] classifier weights; targets: [N]
    int class ids in [0, V). Equivalent to
    ``-mean(log_softmax(fp32(h @ kernel))[i, targets[i]])``."""
    return _ChunkedSoftmaxXent.apply(h, kernel, targets, int(vocab_chunk))


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
