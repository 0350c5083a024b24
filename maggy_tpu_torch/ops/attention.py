"""Attention: hand-written Hopper flash kernels with plain PyTorch versions.

Counterpart of ``maggy_tpu/ops/attention.py``. Same public functions, same
layouts (q [B,Sq,H,D], k/v [B,Sk,Hkv,D], GQA when Hkv < H, a [B,Sk]
key-padding keep-mask, bottom-right causal alignment when Sq != Sk):

- ``attention_reference``: direct fp32 softmax attention.
- ``flash_attention``: a ``torch.autograd.Function`` over three kernels,
  ``flash_fwd``, ``flash_bwd_dkdv`` and ``flash_bwd_dq`` (CUDA C++ in
  ``csrc/flash_attn.cu``), replacing the Pallas ``_flash_fwd_kernel``,
  ``_flash_bwd_dkdv_kernel`` and ``_flash_bwd_dq_kernel``. Each wrapper
  launches its kernel for a CUDA tensor and runs its plain version, which
  repeats the kernel's arithmetic directly, only for a CPU tensor. Each
  wrapper counts its launches in a plain ``launches`` attribute.

  All three are bound by bytes on an H100 at the BERT-base shape (B=32,
  S=128, H=12, D=64, bf16): about 7.6, 11.4 and 9.5 us at 3.35 TB/s. For
  bf16 all three run on tensor cores: bf16 tiles in shared memory loaded
  with double-buffered ``cp.async``, every product an ``mma.sync``
  m16n8k16 with fp32 accumulation fed by ``ldmatrix``, and P and dS kept
  in registers as the A operand of the next product. fp32 inputs run on
  simple CUDA-core kernels with fp32 tiles; tensor cores would break the
  fp32 tolerance. The autograd backward runs dQ first: given the forward's
  output, the dQ kernel computes delta = rowsum(dO * O) for its rows and
  hands it to dK/dV.

  The causal tile skip runs at CAUSAL_SKIP_BLOCK = 128, the JAX package's
  tile size, whatever tile a kernel computes in: a fully masked causal row
  averages V over the keys of the unskipped tiles, so the skip granularity
  is part of the result.
- ``flash_block_fwd`` / ``flash_block_bwd``: the ring-attention building
  blocks (external lse/delta in, fp32 gradients out).
- ``multi_head_attention``: the public entry. A CUDA tensor whose shapes
  tile goes to the kernels; everything else to ``attention_reference``.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Dict, Optional

import torch

NEG_INF = -1e30
#: A row whose log-sum-exp is below this saw only masked keys.
ALL_MASKED_LSE = -1e29
#: Granularity of the causal tile skip (csrc/flash_attn.cu SKIP): the JAX
#: package's flash kernels run at 128 x 128 tiles and skip a key tile lying
#: wholly above the diagonal, so a fully masked causal row averages V over
#: the keys of the unskipped 128-key tiles. The CUDA kernels compute in
#: smaller tiles but apply the skip at this granularity, as do the plain
#: versions.
CAUSAL_SKIP_BLOCK = 128
#: Tile sizes of the CUDA kernels (csrc/flash_attn.cu BQ/BK): Sq and Sk
#: must be multiples of them. Both divide CAUSAL_SKIP_BLOCK.
BLOCK_Q = 64
BLOCK_K = 64
#: Head dims the kernels are instantiated for.
KERNEL_HEAD_DIMS = (64, 96, 128)
_SOURCE = "flash_attn.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ----------------------------------------------------------------- reference


def attention_reference(q, k, v, causal: bool = True, mask=None):
    """[B,Sq,H,D] x [B,Sk,Hkv,D] softmax attention with an fp32 softmax.

    ``mask`` broadcasts against [B,H,Sq,Sk] logits (True = attend). When
    ``causal`` and Sq != Sk the mask is bottom-right aligned."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        cm = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        logits = logits.masked_fill(~cm, NEG_INF)
    if mask is not None:
        logits = torch.where(torch.as_tensor(mask, device=q.device).bool(),
                             logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


# ------------------------------------------------------------ plain versions


def _masks(B, Sq, Sk, causal, mask, device):
    """(masked [B,1,Sq,Sk], live [Sq,Sk]): ``masked`` marks the entries the
    kernels set to NEG_INF; ``live`` the entries of k-tiles the kernels do not
    skip (the Pallas causal skip test at CAUSAL_SKIP_BLOCK tiles)."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    offset = Sk - Sq
    masked = torch.zeros(B, 1, Sq, Sk, dtype=torch.bool, device=device)
    live = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        g = CAUSAL_SKIP_BLOCK
        masked = masked | (kpos > qpos + offset)
        live = (kpos // g) * g < (qpos // g + 1) * g + offset
    if mask is not None:
        masked = masked | (mask == 0)[:, None, None, :]
    return masked, live


def _heads(x, H):
    """[B,S,Hx,D] -> [B,H,S,D] fp32, kv heads repeated over their group."""
    if x.shape[2] != H:
        x = x.repeat_interleave(H // x.shape[2], dim=2)
    return x.float().transpose(1, 2)


def _plain_fwd(q, k, v, mask, causal):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    masked, live = _masks(B, Sq, Sk, causal, mask, q.device)
    s = (_heads(q, H) / math.sqrt(D)) @ _heads(k, H).transpose(-1, -2)
    s = s.masked_fill(masked, NEG_INF).masked_fill(~live, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.full_like(m, NEG_INF), m)
    e = torch.exp(s - m)
    l_safe = e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (e / l_safe) @ _heads(v, H)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.transpose(1, 2).to(q.dtype), lse.contiguous()


def _plain_p_ds(q, k, v, do, lse, delta, mask, causal):
    """Probabilities and softmax-transposed gradients [B,H,Sq,Sk] from the
    saved lse: masked entries are constants (ds = 0) and a fully masked row
    spreads p = 1/n over the n keys of its unskipped tiles."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    masked, live = _masks(B, Sq, Sk, causal, mask, q.device)
    kh, vh = _heads(k, H), _heads(v, H)
    s = _heads(q, H) @ kh.transpose(-1, -2) * scale
    p = torch.exp(s - lse[..., None])
    n = live.sum(-1, keepdim=True).clamp_min(1)
    uniform = torch.where(live, 1.0 / n, torch.zeros_like(n, dtype=torch.float32))
    all_masked = (lse < ALL_MASKED_LSE)[..., None]
    p = torch.where(masked, torch.where(all_masked, uniform, 0.0), p)
    dp = _heads(do, H) @ vh.transpose(-1, -2)
    ds = torch.where(masked, 0.0, p * (dp - delta[..., None]) * scale)
    return p, ds, kh


def _group_sum(x, Hkv):
    """[B,H,S,D] -> [B,S,Hkv,D]: sum each kv head's group of query heads."""
    B, H, S, D = x.shape
    return x.reshape(B, Hkv, H // Hkv, S, D).sum(2).transpose(1, 2)


def _plain_bwd_dkdv(q, k, v, do, lse, delta, mask, causal):
    p, ds, _ = _plain_p_ds(q, k, v, do, lse, delta, mask, causal)
    Hkv = k.shape[2]
    dv = _group_sum(p.transpose(-1, -2) @ _heads(do, q.shape[2]), Hkv)
    dk = _group_sum(ds.transpose(-1, -2) @ _heads(q, q.shape[2]), Hkv)
    return dk, dv


def _plain_bwd_dq(q, k, v, do, lse, delta, mask, causal):
    _, ds, kh = _plain_p_ds(q, k, v, do, lse, delta, mask, causal)
    return (ds @ kh).transpose(1, 2)


# ------------------------------------------------------------- the kernels


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(q, k, v, mask, *more):
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError("flash kernels take float32 or bfloat16, got {}".format(q.dtype))
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError("flash kernels are built for head_dim in {}, got {}".format(
            KERNEL_HEAD_DIMS, D))
    if Sq % BLOCK_Q or Sk % BLOCK_K or H % Hkv:
        raise ValueError("flash kernels need Sq % {} == Sk % {} == 0 and H % Hkv == 0; "
                         "got Sq={}, Sk={}, H={}, Hkv={}".format(
                             BLOCK_Q, BLOCK_K, Sq, Sk, H, Hkv))
    for t in (q, k, v) + more:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors on one device")
    for t in (k, v) + more[:1]:
        if t.dtype != q.dtype:
            raise TypeError("q, k, v and dO must share one dtype")
    if mask is not None and (mask.shape != (B, Sk) or mask.dtype != torch.int32
                             or not mask.is_contiguous() or mask.device != q.device):
        raise ValueError("mask must be a contiguous int32 [B, Sk] tensor on q's device")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, mask) + more if t is not None):
        raise ValueError("the bf16 kernels copy 16-byte chunks: every tensor must "
                         "start on a 16-byte boundary")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError("flash attention runs on CUDA (kernels) or the CPU "
                         "(plain versions), got {}".format(t.device))
    return t.device.type


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError("{} kernel launch failed with cudaError {}".format(what, err))


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


_LAUNCH_LOCK = threading.Lock()
#: Capture stream handle -> the launches recorded into that stream's graph.
_recording: Dict[int, Dict[str, int]] = {}


def _launched(kernel) -> None:
    """Count one launch of ``kernel``'s CUDA kernel, or, when it went into a
    graph under capture, record it for that graph. Keyed by stream, not by
    thread: the backward's kernels launch from autograd's device thread,
    on the forward's (capturing) stream."""
    if _recording:
        recorded = _recording.get(torch.cuda.current_stream().cuda_stream)
        if recorded is not None:
            recorded[kernel.__name__] = recorded.get(kernel.__name__, 0) + 1
            return
    with _LAUNCH_LOCK:
        kernel.launches += 1


@contextlib.contextmanager
def recording_launches(stream):
    """Within the block, launches onto ``stream`` (a CUDA graph's capture
    stream: the capture records kernels without running them) go into the
    yielded dict by wrapper name instead of the counts."""
    recorded: Dict[str, int] = {}
    _recording[stream.cuda_stream] = recorded
    try:
        yield recorded
    finally:
        _recording.pop(stream.cuda_stream, None)


def add_launches(counts: Dict[str, int]) -> None:
    """Add a replayed graph's recorded launches to the counts."""
    with _LAUNCH_LOCK:
        for kernel in KERNELS:
            kernel.launches += counts.get(kernel.__name__, 0)


def flash_fwd(q, k, v, mask, causal: bool):
    """Forward: (out [B,Sq,H,D] in q's dtype, lse [B,H,Sq] fp32)."""
    if _device_kind(q) == "cpu":
        return _plain_fwd(q, k, v, mask, causal)
    from maggy_tpu_torch.ops import build

    _check(q, k, v, mask)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    lib = build.library(_SOURCE)
    _launched(flash_fwd)
    _raise_on(lib.flash_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out),
                            _ptr(lse), B, Sq, Sk, H, Hkv, D, int(causal),
                            _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(D), _stream()),
              "flash_fwd")
    return out, lse


def flash_bwd_dkdv(q, k, v, do, lse, delta, mask, causal: bool,
                   grad_fp32: bool = False):
    """dK/dV [B,Sk,Hkv,D] (k's dtype, or fp32 with ``grad_fp32``)."""
    if _device_kind(q) == "cpu":
        dk, dv = _plain_bwd_dkdv(q, k, v, do, lse, delta, mask, causal)
        dt = torch.float32 if grad_fp32 else k.dtype
        return dk.to(dt), dv.to(dt)
    from maggy_tpu_torch.ops import build

    _check(q, k, v, mask, do, lse, delta)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dt = torch.float32 if grad_fp32 else k.dtype
    dk = torch.empty(k.shape, dtype=dt, device=k.device)
    dv = torch.empty(v.shape, dtype=dt, device=v.device)
    lib = build.library(_SOURCE)
    _launched(flash_bwd_dkdv)
    _raise_on(lib.flash_bwd_dkdv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(mask),
        _ptr(dk), _ptr(dv), B, Sq, Sk, H, Hkv, D, int(causal),
        _DTYPE_CODE[q.dtype], int(grad_fp32), 1.0 / math.sqrt(D), _stream()),
        "flash_bwd_dkdv")
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, mask, causal: bool,
                 grad_fp32: bool = False, out=None):
    """dQ [B,Sq,H,D] (q's dtype, or fp32 with ``grad_fp32``).

    Takes exactly one of ``delta`` (rowsum(dO * O), [B,H,Sq] fp32) and
    ``out`` (the forward's output). Given ``out``, the kernel computes
    delta for its rows itself and the call returns (dq, delta), delta for
    the dK/dV kernel. bf16 runs on tensor cores, fp32 on CUDA cores."""
    if (delta is None) == (out is None):
        raise ValueError("flash_bwd_dq takes exactly one of delta and out")
    dt = torch.float32 if grad_fp32 else q.dtype
    if _device_kind(q) == "cpu":
        if out is not None:
            delta = _row_delta(do, out)
        dq = _plain_bwd_dq(q, k, v, do, lse, delta, mask, causal).to(dt)
        return dq if out is None else (dq, delta)
    from maggy_tpu_torch.ops import build

    _check(q, k, v, mask, do, lse, delta if out is None else out)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    delta_out = None
    if out is not None:
        if out.shape != q.shape or out.dtype != q.dtype:
            raise ValueError("out must have q's shape and dtype")
        delta_out = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=dt, device=q.device)
    lib = build.library(_SOURCE)
    _launched(flash_bwd_dq)
    _raise_on(lib.flash_bwd_dq(
        _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(out),
        _ptr(delta_out), _ptr(mask), _ptr(dq), B, Sq, Sk, H, Hkv, D, int(causal),
        _DTYPE_CODE[q.dtype], int(grad_fp32), 1.0 / math.sqrt(D), _stream()),
        "flash_bwd_dq")
    return dq if out is None else (dq, delta_out)


#: The three kernel wrappers, each with its launch count.
KERNELS = (flash_fwd, flash_bwd_dkdv, flash_bwd_dq)
for _kernel in KERNELS:
    _kernel.launches = 0


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for kernel in KERNELS:
            kernel.launches = 0


def launch_counts():
    return {kernel.__name__: kernel.launches for kernel in KERNELS}


def kernel_resources(name: str, D: int, dtype: torch.dtype, grad_fp32: bool = False):
    """What the CUDA kernel that wrapper ``name`` launches for (D, dtype,
    grad_fp32) takes on the card: registers and local (spill and stack)
    bytes per thread, static and dynamic shared bytes and threads per
    block, and the blocks that fit on one SM. Needs the card."""
    from maggy_tpu_torch.ops import build

    info = (ctypes.c_int * 6)()
    index = [kernel.__name__ for kernel in KERNELS].index(name)
    _raise_on(build.library(_SOURCE).flash_kernel_info(
        index, D, _DTYPE_CODE[dtype], int(grad_fp32), info), name)
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem", "threads",
            "blocks_per_sm")
    return dict(zip(keys, info))


# ------------------------------------------------------------ autograd seam


def _canon_mask(mask, B, Sk):
    """Any keep-mask broadcastable to [B, Sk] -> contiguous int32 [B, Sk]."""
    if mask is None:
        return None
    m = torch.as_tensor(mask)
    if m.ndim == 3:
        m = m[:, 0, :]
    return m.broadcast_to(B, Sk).to(torch.int32).contiguous()


def _row_delta(do, out):
    """delta = rowsum(dO * O) as [B,H,Sq] fp32 (an XLA op in the JAX
    package): the plain version of the delta the dQ kernel computes when
    given ``out``."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = flash_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, do, lse, None, mask, ctx.causal, out=out)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, mask, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask=None, causal: bool = True):
    """Flash attention on q [B,Sq,H,D], k/v [B,Sk,Hkv,D] (Hkv divides H).
    ``mask``: optional [B, Sk] (or [B,1,Sk]) keep-mask over keys. A query row
    whose keys are all masked returns the mean of V over the keys of its
    unskipped tiles (all Sk keys when not causal); such rows are padding and
    must be excluded from the loss."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _FlashAttention.apply(q, k, v, _canon_mask(mask, q.shape[0], k.shape[1]),
                                 causal)


# ------------------------------------------------- ring-attention building blocks


def flash_block_fwd(q, k, v, causal: bool = True):
    """One (Q shard, K/V shard) forward returning (out [B,Sq,H,D], lse
    [B,H,Sq] fp32), the partial-softmax state ring attention merges. Not
    differentiable on its own."""
    return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), None, causal)


def flash_block_bwd(q, k, v, do, lse, delta, causal: bool = True):
    """One block of the ring-attention backward from the GLOBAL per-row lse
    and delta ([B,H,Sq] fp32). Returns (dq, dk, dv) in fp32."""
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, None, causal, grad_fp32=True)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, None, causal, grad_fp32=True)
    return dq, dk, dv


# ----------------------------------------------------------------- dispatch


def _key_padding_mask(mask, B, Sk):
    """Reduce an attention mask to a [B, Sk] keep-mask, or (None, False)
    when it cannot be proven key-padding-only. Only [B,1,1,Sk] and [Sk] are
    accepted: a 2-d [B, Sk] and a per-query [Sq, Sk] mask are
    indistinguishable by shape when B == Sq. Returns (mask2d, ok)."""
    if mask is None:
        return None, True
    m = torch.as_tensor(mask)
    if m.ndim == 4 and m.shape[1] == 1 and m.shape[2] == 1 \
            and m.shape[3] == Sk and m.shape[0] in (1, B):
        return m[:, 0, 0, :].broadcast_to(B, Sk), True
    if m.ndim == 1 and m.shape[0] == Sk:
        return m[None, :].broadcast_to(B, Sk), True
    return None, False


def multi_head_attention(q, k, v, causal: bool = True, mask=None,
                         force: Optional[str] = None):
    """Public attention entry. q: [B,Sq,H,D], k/v: [B,Sk,Hkv,D].

    A CUDA tensor with a key-padding (or no) mask, a head dim the kernels
    are built for (KERNEL_HEAD_DIMS) and 128-tiling Sq/Sk goes through the
    flash kernels; anything else, and every CPU tensor, through
    ``attention_reference``. ``force`` in {"flash", "reference"} overrides
    the choice; "flash" on a CPU tensor runs the kernels' plain versions."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv != 0:
        raise ValueError("H={} not divisible by Hkv={}".format(H, Hkv))
    pad_mask, mask_ok = _key_padding_mask(mask, B, Sk)
    tiles_ok = mask_ok and D in KERNEL_HEAD_DIMS and Sq % 128 == 0 and Sk % 128 == 0
    if force == "flash":
        if not tiles_ok:
            raise ValueError(
                "force='flash' requires a key-padding (or no) mask, head_dim in "
                "{}, and 128-tiling Sq/Sk; got D={}, Sq={}, Sk={}, mask "
                "shape={}".format(KERNEL_HEAD_DIMS, D, Sq, Sk, None if mask is None
                                  else tuple(torch.as_tensor(mask).shape)))
        use_flash = True
    else:
        use_flash = force is None and q.is_cuda and tiles_ok
    if not use_flash:
        return attention_reference(q, k, v, causal=causal, mask=mask)
    return flash_attention(q, k, v, pad_mask, causal)
