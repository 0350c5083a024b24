"""Parameters held as shards on a mesh, and how a model reads them.

GSPMD partitions the JAX Trainer's program from the parameters' specs; the
port's mesh Trainer does the partitioning by hand, in two parts:

- ``shard_module`` replaces each parameter that its spec shards over an
  axis of more than one rank by this rank's block (the whole values first
  drawn or loaded on every rank, as the one-rank Trainer does, then cut and
  freed), and notes on the new parameter where it was cut
  (``_mesh_shards``: {dim: (axis, process group, axis size, coordinate)}).
  The optimizer built after it holds the blocks, so its moments are sharded
  as the parameters are (ZeRO-3 under fsdp).
- The zoo models read every declared parameter through ``gathered``: a dim
  cut over "fsdp" is all-gathered before use (its gradient reduce-scattered
  in the backward, ``collectives.gather_shards``), while a dim cut over
  "model" (tensor parallelism) or "expert" (expert parallelism) stays cut,
  and the module computes on its block: ``group_of`` names the group of
  such a dim, ``local_range`` the block's place in the whole.

A parameter that is not cut reads as it is, so a model outside a mesh, or
on a world of one, runs its usual code.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from maggy_tpu_torch.parallel import collectives
from maggy_tpu_torch.parallel.sharding import shard_of

#: Mesh axes whose blocks are gathered before use; the other axes' blocks
#: are computed on in place.
GATHERED_AXES = ("fsdp",)


def _shards(p: torch.Tensor) -> Dict[int, Tuple[str, object, int, int]]:
    return getattr(p, "_mesh_shards", None) or {}


def shard_module(model: nn.Module, env, specs) -> Dict[str, Tuple[int, ...]]:
    """Replace every parameter of ``model`` that ``specs`` ({name: spec},
    ``sharding.logical_placements``) cuts over an axis of ``env``'s mesh
    with more than one rank by this rank's block; returns {name: block
    shape} of the parameters cut."""
    cut = {}
    for name, p in list(model.named_parameters()):
        spec = specs.get(name, ())
        dims = {d: a for d, a in enumerate(spec) if a is not None and env.axis_size(a) > 1}
        if not dims:
            continue
        try:
            block = shard_of(p.detach(), spec, env)
        except ValueError as e:
            raise ValueError("parameter {}: {}".format(name, e)) from None
        new = nn.Parameter(block.clone(), requires_grad=p.requires_grad)
        new._mesh_shards = {d: (a, env.group(a), env.axis_size(a), env.axis_index(a))
                            for d, a in dims.items()}
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, leaf, new)
        cut[name] = tuple(new.shape)
    return cut


def gathered(p: torch.Tensor) -> torch.Tensor:
    """``p`` with its fsdp-cut dims gathered (a differentiable all-gather
    whose backward reduce-scatters); ``p`` itself when nothing is cut. The
    dims still cut (over "model" or "expert") are noted on the result as
    on ``p``."""
    info = _shards(p)
    out = p
    for dim, (axis, group, _, _) in sorted(info.items()):
        if axis in GATHERED_AXES:
            out = collectives.gather_shards(out, group, dim, kind=axis)
    rest = {d: i for d, i in info.items() if i[0] not in GATHERED_AXES}
    if out is not p and rest:
        out._mesh_shards = rest
    return out


def group_of(p: torch.Tensor, dim: int, axis: str):
    """The process group over which ``p``'s ``dim`` is cut along ``axis``,
    or None when it is not."""
    info = _shards(p).get(dim)
    return info[1] if info is not None and info[0] == axis else None


def axis_size_of(p: torch.Tensor, dim: int) -> int:
    """How many blocks ``p``'s ``dim`` is cut into (1: whole)."""
    info = _shards(p).get(dim)
    return 1 if info is None else info[2]


def local_range(p: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(start, size) of this rank's block of ``p`` along ``dim`` in the
    whole tensor."""
    info = _shards(p).get(dim)
    size = p.shape[dim]
    return (0, size) if info is None else (info[3] * size, size)


def column_parallel(x: torch.Tensor, weight: torch.Tensor, kind: str = "tp") -> torch.Tensor:
    """``x`` as the input of a product with ``weight`` [out, in]: entering
    the region when the output dim is cut over "model" (the ranks'
    gradients summed in the backward), unchanged otherwise."""
    group = group_of(weight, 0, "model")
    return x if group is None else collectives.copy_to_region(x, group, kind)


def row_parallel(y: torch.Tensor, weight: torch.Tensor, kind: str = "tp") -> torch.Tensor:
    """The output of a product with ``weight`` [out, in], summed over
    "model" when the input dim is cut over it (each rank's product is a
    partial sum), unchanged otherwise."""
    group = group_of(weight, 1, "model")
    return y if group is None else collectives.reduce_from_region(y, group, kind)


def vocab_parallel_embedding(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    """``F.embedding(tokens, table)`` in ``dtype`` for a table [vocab, dim]
    whose fsdp-cut dims are gathered; a vocab dim cut over "model" looks up
    the rows this rank holds (zero elsewhere), summed over "model"."""
    import torch.nn.functional as F

    group = group_of(table, 0, "model")
    full = gathered(table).to(dtype)
    if group is None:
        return F.embedding(tokens, full)
    start, rows = local_range(table, 0)
    local = tokens - start
    inside = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), full) * inside[..., None].to(dtype)
    return collectives.reduce_from_region(x, group, "tp")


def whole(p: torch.Tensor, dim: int, axis: str = "model", kind: str = "tp") -> torch.Tensor:
    """``gathered(p)`` with its ``dim`` cut over ``axis`` gathered too, for
    a use every rank repeats (the backward keeps this rank's slice)."""
    group = group_of(p, dim, axis)
    x = gathered(p)
    return x if group is None else collectives.gather_replicated(x, group, dim, kind)


def check_heads(heads: int, kv_heads: int, weight: torch.Tensor) -> None:
    """Refuse a head count that does not divide the "model" axis that cuts
    ``weight``'s output dim: GSPMD would pad the heads, the port does not."""
    n = axis_size_of(weight, 0)
    if heads % n or kv_heads % n:
        raise ValueError("{} heads and {} kv heads do not divide over {} 'model' ranks".format(
            heads, kv_heads, n))


def shard_groups(p: torch.Tensor) -> Dict[str, Optional[object]]:
    """{axis: group} of the axes that cut ``p``."""
    return {axis: group for axis, group, _, _ in _shards(p).values()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole values of ``model``'s state dict on every rank: each cut
    dim of a parameter all-gathered over its group (a collective: every
    rank of the mesh calls it)."""
    params = dict(model.named_parameters())
    out = {}
    for name, t in model.state_dict().items():
        x = t.detach()
        p = params.get(name)
        if p is not None:
            for dim, (_, group, _, _) in sorted(_shards(p).items()):
                x = collectives._gather_dim(x, group, dim, "state_all_gather")
        out[name] = x
    return out
