"""Every exchange between ranks, written in one place.

The TPU moves these over ICI inside the compiled program (``ppermute``,
``all_to_all`` and the all-reduces GSPMD inserts); here each is a
``torch.distributed`` call on a process group:

- ``ring_shift``: the ring's hop. Each rank sends its tensors to the previous
  rank of the group and receives the next rank's (JAX's permutation
  ``[(i, (i - 1) % n)]``), or the other way round with ``direction=-1``.
  Both directions are posted together (``dist.batch_isend_irecv``): a
  blocking send-then-receive on every rank can deadlock on large buffers.
  The tensors of a hop travel as one byte buffer.
- ``all_to_all``: Ulysses' swaps (chunk ``j`` of dim 0 goes to rank ``j``).
- ``all_reduce_`` and ``all_gather``: the trainer's gradient and loss
  averages (counted apart, as "grad_all_reduce" and "loss_all_reduce")
  and the ZeRO update's gather.

Each runs on the group's own backend, tensors as they are, except the
ring's hop: a gloo group cannot send or receive device memory, so a hop of
CUDA tensors over gloo crosses through pinned host memory ("gloo+host").
The choice is made from the group's backend, never by trying. On an H100
with PyTorch 2.11 (``python3 -m maggy_tpu_torch.parallel.gloo_cuda_probe``),
gloo's all-reduce, broadcast, all-gather and all-to-all took CUDA tensors
and gave the right values, while a send and receive of device memory
failed (``writev``: bad address). ``traffic()`` counts, per kind of
exchange, the calls, the bytes this rank sent and the host milliseconds
spent (staging included), and names the transport that ran.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

_LOCK = threading.Lock()
_TRAFFIC: Dict[str, Dict[str, float]] = {}  # guarded-by: _LOCK
_TRANSPORTS: Dict[str, str] = {}  # guarded-by: _LOCK


def _count(kind: str, how: str, nbytes: int, t0: float) -> None:
    with _LOCK:
        rec = _TRAFFIC.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0})
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["ms"] += (time.perf_counter() - t0) * 1e3
        _TRANSPORTS[kind] = how


def traffic() -> Dict[str, Dict[str, object]]:
    """{kind: {"calls", "bytes", "ms", "transport"}} since the last reset."""
    with _LOCK:
        return {k: {**v, "transport": _TRANSPORTS.get(k)} for k, v in _TRAFFIC.items()}


def reset_traffic() -> None:
    with _LOCK:
        _TRAFFIC.clear()
        _TRANSPORTS.clear()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA ``t``, complete when this returns."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, pos = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[pos:pos + n].view(t.dtype).reshape(t.shape))
        pos += n
    return out


def ring_shift(tensors: Sequence[torch.Tensor], group, direction: int = 1) -> List[torch.Tensor]:
    """One hop of the ring over ``group``: returns the tensors of the next
    rank (``direction=1``: sent to the previous rank) or of the previous one
    (``direction=-1``), same shapes and dtypes, on the tensors' device."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    send_to = dist.get_global_rank(group, (me - direction) % n)
    recv_from = dist.get_global_rank(group, (me + direction) % n)
    device = tensors[0].device
    how = str(dist.get_backend(group))
    staged = how == "gloo" and device.type == "cuda"
    if staged:
        how = "gloo+host"
    t0 = time.perf_counter()
    buf = _pack(tensors)
    if staged:
        buf = _to_host(buf)
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, send_to, group),
           dist.P2POp(dist.irecv, recv, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        recv = recv.to(device, non_blocking=True)
    out = _unpack(recv, tensors)
    _count("ring_hop", how, buf.numel(), t0)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``out[j] = x[me]`` of rank ``j``: chunk ``j`` of ``x``'s dim 0 (of
    size n, the group's) goes to rank ``j``."""
    t0 = time.perf_counter()
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _count("all_to_all", str(dist.get_backend(group)), x.numel() * x.element_size(), t0)
    return out


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM,
                kind: str = "all_reduce") -> torch.Tensor:
    """In-place all-reduce of contiguous ``t`` over ``group``, counted in
    ``traffic()`` under ``kind``."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    _count(kind, str(dist.get_backend(group)), t.numel() * t.element_size(), t0)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape everywhere), in group-rank order."""
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    _count("all_gather", str(dist.get_backend(group)), t.numel() * t.element_size(), t0)
    return parts
