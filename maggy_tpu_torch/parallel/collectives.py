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
- The sharded tensors' exchanges, each an autograd Function whose backward
  is the JAX transpose of its forward: fsdp's all-gather of a parameter
  block (``gather_shards``; backward: its gradient's reduce-scatter), a
  gather into a use every rank repeats (``gather_replicated``; backward:
  this rank's slice), tp's and ep's identity into a sharded region
  (``copy_to_region``; backward: the sum of the partial gradients) and sum
  out of it (``reduce_from_region``; backward: identity), BatchNorm's
  and the MoE's global batch statistics (``sum_both_ways``: a psum both
  ways), and the pipeline's stage hop (``ppermute``; backward: the
  reversed hop). Each is counted under its caller's kind ("fsdp_all_gather",
  "tp_all_reduce", "ep_grad_all_reduce", "pipe_hop", "bn_all_reduce", ...).

Each runs on the group's own backend, tensors as they are, except the
ring's hop: a gloo group cannot send or receive device memory, so a hop of
CUDA tensors over gloo crosses through pinned host memory ("gloo+host").
The choice is made from the group's backend and the probe's answer
(``GLOO_CUDA``), never by trying. On an H100 with PyTorch 2.11
(``python3 -m maggy_tpu_torch.parallel.gloo_cuda_probe``), gloo's all-reduce, broadcast, all-gather, all-to-all,
all-gather-into-tensor, reduce-scatter-tensor and list reduce-scatter took
CUDA tensors and gave the right values, in fp32 and (all-reduce and the
two tensor forms) bf16, while a send and receive of device memory failed
(``writev``: bad address). So fsdp's gather and reduce-scatter always
take the tensor forms; a gloo group given a CUDA tensor of an (exchange,
dtype) the probe did not run raises rather than guess. ``traffic()`` counts,
per kind of exchange, the calls, the bytes this rank sent and the host
milliseconds spent (staging included), and names the transport that ran.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

#: What a gloo group runs on CUDA tensors, by (exchange, dtype), from
#: ``python3 -m maggy_tpu_torch.parallel.gloo_cuda_probe`` on the card
#: (module docstring); a pair the probe did not run raises.
GLOO_CUDA = {
    ("all_gather_into_tensor", torch.float32): True,
    ("all_gather_into_tensor", torch.bfloat16): True,
    ("reduce_scatter_tensor", torch.float32): True,
    ("reduce_scatter_tensor", torch.bfloat16): True,
}

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


def ring_shift(tensors: Sequence[torch.Tensor], group, direction: int = 1,
               kind: str = "ring_hop") -> List[torch.Tensor]:
    """One hop of the ring over ``group``: returns the tensors of the next
    rank (``direction=1``: sent to the previous rank) or of the previous one
    (``direction=-1``), same shapes and dtypes, on the tensors' device;
    counted under ``kind``."""
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
    _count(kind, how, buf.numel(), t0)
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


# ------------------------------------------------ sharded tensors' exchanges
#
# The exchanges of fsdp, tp, ep, the pipeline and BatchNorm over a mesh
# axis. Each one a gradient passes through is an autograd Function whose
# backward is the JAX transpose of its forward, and each is counted under
# its own kind.


def transport_of(op: str, backend: str, device_type: str, dtype: torch.dtype) -> str:
    """The transport of ``op`` on a ``device_type`` tensor of ``dtype`` over
    a ``backend`` group: the backend itself. A gloo group and a CUDA tensor
    of a pair the probe did not run (``GLOO_CUDA``) raise."""
    if backend == "gloo" and device_type == "cuda" and not GLOO_CUDA.get((op, dtype), False):
        raise RuntimeError("gloo's {} on CUDA {} tensors was not probed on the card "
                           "(collectives.GLOO_CUDA)".format(op, dtype))
    return backend


def _gather_dim(x: torch.Tensor, group, dim: int, kind: str) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    lead = x.movedim(dim, 0).contiguous()
    how = transport_of("all_gather_into_tensor", str(dist.get_backend(group)),
                       lead.device.type, lead.dtype)
    out = torch.empty((n * lead.shape[0],) + tuple(lead.shape[1:]), dtype=lead.dtype,
                      device=lead.device)
    dist.all_gather_into_tensor(out, lead, group=group)
    _count(kind, how, lead.numel() * lead.element_size(), t0)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, group, dim: int, kind: str) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``."""
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    lead = x.movedim(dim, 0).contiguous()
    how = transport_of("reduce_scatter_tensor", str(dist.get_backend(group)),
                       lead.device.type, lead.dtype)
    out = torch.empty((lead.shape[0] // n,) + tuple(lead.shape[1:]), dtype=lead.dtype,
                      device=lead.device)
    dist.reduce_scatter_tensor(out, lead, group=group)
    _count(kind, how, lead.numel() * lead.element_size(), t0)
    return out.movedim(0, dim)


def _sum(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The sum of every rank's ``x``, a new tensor."""
    out = x.contiguous().clone()
    return all_reduce_(out, group, kind=kind)


class _GatherShards(torch.autograd.Function):
    """All-gather along ``dim`` <-> reduce-scatter along ``dim``: fsdp's
    parameter gather, whose users differ by rank (each rank's own batch),
    so their gradients are partial sums."""

    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return _gather_dim(x, group, dim, kind + "_all_gather")

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.group, ctx.dim, ctx.kind + "_reduce_scatter"), \
            None, None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` into a use every rank repeats: the
    cotangent is the same on every rank, so the transpose (reduce-scatter
    of n equal cotangents, over n) is this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.dim, ctx.rows = dim, x.shape[dim]
        ctx.start = dist.get_rank(group) * x.shape[dim]
        return _gather_dim(x, group, dim, kind + "_all_gather")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.rows), None, None, None


class _CopyToRegion(torch.autograd.Function):
    """Identity into a sharded region <-> the sum of the ranks' partial
    gradients."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, ctx.kind + "_grad_all_reduce"), None, None


class _ReduceFromRegion(torch.autograd.Function):
    """A psum whose result every rank uses alike <-> identity."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return _sum(x, group, kind + "_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBothWays(torch.autograd.Function):
    """A psum whose result each rank uses on its own data <-> a psum of
    the cotangents (BatchNorm's batch statistics)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return _sum(x, group, kind + "_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, ctx.kind + "_grad_all_reduce"), None, None


class _Hop(torch.autograd.Function):
    """``ppermute`` one step around the ring <-> the reversed ppermute."""

    @staticmethod
    def forward(ctx, x, group, direction, kind):
        ctx.group, ctx.direction, ctx.kind = group, direction, kind
        return ring_shift([x], group, direction, kind=kind + "_hop")[0]

    @staticmethod
    def backward(ctx, g):
        return ring_shift([g], ctx.group, -ctx.direction, kind=ctx.kind + "_hop_reverse")[0], \
            None, None, None


def gather_shards(x: torch.Tensor, group, dim: int, kind: str = "fsdp") -> torch.Tensor:
    """fsdp: the whole parameter from every rank's shard along ``dim``;
    the backward reduce-scatters its gradient (counted as ``<kind>_all_gather``
    and ``<kind>_reduce_scatter``)."""
    return _GatherShards.apply(x, group, dim, kind)


def gather_replicated(x: torch.Tensor, group, dim: int, kind: str) -> torch.Tensor:
    """The whole tensor from every rank's shard along ``dim``, for a use
    every rank of ``group`` repeats (a vocab-sharded head, a sharded
    router); the backward keeps this rank's slice (``<kind>_all_gather``)."""
    return _GatherReplicated.apply(x, group, dim, kind)


def copy_to_region(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """A replicated value entering a region sharded over ``group``: the
    backward sums the ranks' gradients (``<kind>_grad_all_reduce``)."""
    return _CopyToRegion.apply(x, group, kind)


def reduce_from_region(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The sum over ``group`` of partial results (a row-parallel product, a
    vocab-parallel lookup, the experts' combine), used alike by every rank
    (``<kind>_all_reduce``; the backward passes the gradient through)."""
    return _ReduceFromRegion.apply(x, group, kind)


def sum_both_ways(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The sum over ``group`` of per-rank values that each rank then uses on
    its own data: the backward sums the gradients too."""
    return _SumBothWays.apply(x, group, kind)


def ppermute(x: torch.Tensor, group, shift: int = 1, kind: str = "pipe") -> torch.Tensor:
    """JAX's ``ppermute`` with the permutation ``[(i, (i + shift) % n)]``
    for ``shift`` in (1, -1): group rank i's ``x`` goes to rank i + shift.
    The backward sends the gradient back the other way (``<kind>_hop``,
    ``<kind>_hop_reverse``)."""
    if shift not in (1, -1):
        raise ValueError("ppermute shifts by one rank, got {}".format(shift))
    return _Hop.apply(x, group, -shift, kind)
