"""Device meshes and the ShardingEnv handed to distributed train functions.

Counterpart of ``maggy_tpu/parallel/mesh.py``. JAX runs SPMD under one
controller: one process drives every local chip of a ``jax.sharding.Mesh``.
PyTorch runs SPMD as one process per rank, so the port maps it this way:

- one worker process is one rank, and each rank is on one device;
- a ``ShardingEnv``'s mesh is a ``torch.distributed.device_mesh.DeviceMesh``
  over the world: the product of ``mesh_shape`` is the world size, a single
  ``-1`` axis is inferred (``make_mesh``, JAX ``mesh.py:26``), and a mesh
  larger than the world is refused;
- a world of one rank without a process group (a thread worker of
  ``DistributedConfig(backend="thread")``, where every thread shares one
  process and so cannot hold a default group of its own) gets a mesh of
  size 1 that names the axes and holds no process group: every collective
  over it is skipped.

Mesh axis conventions (as in the JAX package): "data" (data parallelism),
"fsdp" (parameters sharded over a data-like axis), "model" (tensor
parallelism), "seq" (sequence parallelism: ring or Ulysses attention),
"pipe" and "expert". ``slice_mesh`` is a gang's mesh: the gang's world
is exactly its chips' ranks, in chip order (``gang.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from maggy_tpu_torch.parallel.sharding import DATA_AXES, batch_sharding


def resolve_mesh_shape(mesh_shape: Optional[Dict[str, int]], world_size: int) -> Dict[str, int]:
    """{"axis": size} with a single -1 inferred; the sizes must multiply to
    the world size (one rank a device). An empty shape is {"data": world}."""
    shape = dict(mesh_shape) if mesh_shape else {"data": world_size}
    sizes = list(shape.values())
    if sizes.count(-1) > 1:
        raise ValueError("At most one mesh axis may be -1.")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if world_size % known:
            raise ValueError("Device count {} not divisible by fixed axes {}".format(
                world_size, known))
        sizes[sizes.index(-1)] = world_size // known
    if int(np.prod(sizes)) != world_size:
        raise ValueError("Mesh {} needs {} devices, have {} (one rank a device).".format(
            shape, int(np.prod(sizes)), world_size))
    return dict(zip(shape, sizes))


def make_mesh(mesh_shape: Optional[Dict[str, int]] = None, device_type: str = "cuda"):
    """A named ``DeviceMesh`` over the world from {"axis": size}. With a
    process group the mesh spans its ranks (``init_device_mesh``, which
    builds one subgroup an axis); without one the world is this rank alone."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = resolve_mesh_shape(mesh_shape, world)
    names, sizes = tuple(shape), tuple(shape.values())
    if dist.is_initialized():
        return init_device_mesh(device_type, sizes, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.zeros(sizes, dtype=torch.int64),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


def slice_mesh(chip_ids, mesh_shape: Dict[str, int], device_type: str = "cuda"):
    """Named mesh over a gang's chips (JAX ``mesh.py:67-77``). JAX builds
    it over devices [chip_ids] of one process's inventory; here the gang's
    world holds one rank per chip in chip order, so the mesh spans the
    world and its size must equal ``len(chip_ids)``."""
    shape = dict(mesh_shape) if mesh_shape else {"data": len(chip_ids)}
    if int(np.prod(list(shape.values()))) != len(chip_ids):
        raise ValueError("gang mesh {} needs {} chips, the gang has {}".format(
            shape, int(np.prod(list(shape.values()))), len(chip_ids)))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != len(chip_ids):
        raise ValueError("gang of {} chips in a world of {} ranks: a gang's world is its "
                         "chips".format(len(chip_ids), world))
    return make_mesh(shape, device_type=device_type)


def _has_groups(mesh) -> bool:
    return dist.is_initialized() and mesh.size() > 1


def axis_size(mesh, name: str) -> int:
    """Size of ``mesh``'s axis ``name``; 1 for an axis it does not have."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.size(names.index(name))) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on ``mesh``'s axis ``name`` (0 off the mesh)."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.get_coordinate()[names.index(name)]) if name in names else 0


def axis_group(mesh, name: str):
    """The process group of ``mesh``'s axis ``name``, or None when the axis
    holds one rank (no collective is needed)."""
    if axis_size(mesh, name) == 1 or not _has_groups(mesh):
        return None
    return mesh.get_group(name)


@dataclass
class ShardingEnv:
    """What a distributed train function gets instead of a DDP wrapper.

    ``process_index``/``process_count`` mirror the reference's
    RANK/WORLD_SIZE; ``current_shard``/``shard_count`` the per-rank input
    sharding contract (JAX ``mesh.py:81-133``). ``device`` is this rank's
    device (default: the mesh's device type, the current CUDA device)."""

    mesh: Any
    process_index: int = 0
    process_count: int = 1
    device: Optional[torch.device] = None
    _groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.device is None:
            self.device = torch.device("cuda", torch.cuda.current_device()) \
                if self.mesh.device_type == "cuda" else torch.device("cpu")
        self.device = torch.device(self.device)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    @property
    def num_devices(self) -> int:
        return int(self.mesh.size())

    @property
    def current_shard(self) -> int:
        return self.process_index

    @property
    def shard_count(self) -> int:
        return self.process_count

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.axis_names)

    def axis_size(self, name: str) -> int:
        return axis_size(self.mesh, name)

    def axis_index(self, name: str) -> int:
        return axis_index(self.mesh, name)

    def group(self, *axes: str):
        """The process group of the ranks that differ only along ``axes``
        (one axis: the mesh's own subgroup; several: a group built once,
        collectively, on first use), or None when those axes hold one rank
        (no collective is needed)."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) == 1:
            return axis_group(self.mesh, axes[0])
        if math.prod(self.axis_size(a) for a in axes) == 1 or not _has_groups(self.mesh):
            return None
        if axes not in self._groups:
            self._groups[axes] = self._new_group(axes)
        return self._groups[axes]

    def _new_group(self, axes: Tuple[str, ...]):
        """``dist.new_group`` for every row of ranks along ``axes`` (every
        rank creates every row's group, in one order, as new_group needs);
        returns this rank's. The whole mesh is the default group."""
        if set(axes) == set(self.axis_names):
            return dist.group.WORLD
        ranks = self.mesh.mesh.cpu().numpy()
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        red = [i for i, a in enumerate(self.axis_names) if a in axes]
        rows = ranks.transpose(keep + red).reshape(-1, math.prod(ranks.shape[i] for i in red))
        me, mine = dist.get_rank(), None
        for row in rows:
            g = dist.new_group([int(r) for r in row])
            if me in row:
                mine = g
        return mine

    @property
    def data_group(self):
        """The data-like axes' process group (gradients and the loss are
        averaged over it); None when they hold one rank."""
        return self.group(*self.data_axes)

    @property
    def reduce_axes(self) -> Tuple[str, ...]:
        """Axes whose ranks see different tokens of one step: the data-like
        axes and "seq". GSPMD reduces gradients over them in JAX; here the
        Trainer averages them explicitly."""
        return self.data_axes + (("seq",) if "seq" in self.axis_names else ())

    def _coordinate(self, axes: Tuple[str, ...]) -> Tuple[int, int]:
        """(this rank's index, count) over ``axes``, row-major."""
        index, count = 0, 1
        for a in axes:
            index, count = index * self.axis_size(a) + self.axis_index(a), count * self.axis_size(a)
        return index, count

    def shard_batch(self, batch):
        """This rank's slice of a host batch, on this rank's device, as
        ``sharding.batch_sharding`` lays each leaf out: dim 0 over the
        data-like axes, and dim 1 (the sequence of [B, S, ...] leaves) over
        "seq" when the mesh has it and it divides. Leaves are numpy arrays
        or tensors, nested in dicts, tuples and lists."""

        def place(x):
            if isinstance(x, dict):
                return {k: place(v) for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(place(v) for v in x)
            t = torch.as_tensor(x)
            if t.ndim == 0:
                return t.to(self.device)
            for dim, axes in enumerate(batch_sharding(self.mesh, shape=tuple(t.shape))):
                if axes is None:
                    continue
                index, count = self._coordinate((axes,) if isinstance(axes, str) else axes)
                if t.shape[dim] % count:
                    raise ValueError("batch dim {} does not divide over {} shards of {}".format(
                        t.shape[dim], count, axes))
                n = t.shape[dim] // count
                t = t.narrow(dim, index * n, n)
            return t.contiguous().to(self.device)

        return place(batch)


def split_sequence(x: torch.Tensor, n: int, index: int, axis_name: str = "seq",
                   dim: int = 1) -> torch.Tensor:
    """Shard ``index`` of ``n`` along ``dim`` of a global sequence tensor,
    raising as the JAX sequence-parallel entries do when it does not divide."""
    S = x.shape[dim]
    if S % n:
        raise ValueError("Sequence length {} must divide over {} '{}' shards".format(
            S, n, axis_name))
    return x.narrow(dim, index * (S // n), S // n)

