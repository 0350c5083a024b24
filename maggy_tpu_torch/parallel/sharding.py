"""Parameter and batch sharding rules: dp / fsdp / tp / sp / ep / zero in one place.

Counterpart of ``maggy_tpu/parallel/sharding.py:34-218``. The rules are the
JAX package's, computed on shapes alone, so they hold with or without a
world: ``param_sharding`` gives a leaf's spec as the entries of a JAX
``PartitionSpec`` (a mesh axis name or None for each dim), and
``param_placements`` the same rule as DTensor placements, one a mesh axis
(``Shard(dim)`` or ``Replicate()``). A mesh is a ``DeviceMesh`` or a plain
ordered {"axis": size} dict.

The mesh Trainer places a model's parameters as the JAX Trainer does
(``maggy_tpu/train/trainer.py:33-55``): by the logical axes each zoo model
declares for its parameters (``logical_axes``: every module's
``param_axes()``, the counterpart of the Flax ``nn.with_logical_partitioning``
annotations, in the port's dim order), mapped through
``logical_axis_rules(strategy)`` with the axes the mesh lacks dropped
(``logical_placements``); a parameter without a declaration is replicated,
as an unannotated Flax leaf is. ``param_sharding`` / ``shard_params``, the
shape-only heuristic, are the raw-pytree helpers of JAX's ``ShardingEnv``
and place no model parameter. ``shard_state_dict`` cuts a rank's shards out
of a whole state dict (a converted Flax tree, ``flax_to_state_dict``).

Layouts: the rules read a leaf in the Flax layout, so that the port shards
the dimension the JAX package shards. A 2-d dense ``weight`` of the port is
the transpose of a Flax ``kernel`` [in, out] (``flax_layout``);
``shard_params`` takes parameter names for that reason.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

#: Strategy parts ``logical_axis_rules`` accepts.
STRATEGY_PARTS = ("dp", "fsdp", "tp", "sp", "ep", "zero")
#: Mesh axes that split the batch (gradients are averaged over them).
DATA_AXES = ("data", "fsdp")


def mesh_axes(mesh) -> Dict[str, int]:
    """{"axis": size} of a DeviceMesh or of an {"axis": size} dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)}


def _best_axis(shape, axis_size: int, prefer_last: bool = True) -> Optional[int]:
    """Largest dimension divisible by axis_size (ties -> last/first)."""
    candidates = [(d, i) for i, d in enumerate(shape) if d % axis_size == 0 and d >= axis_size]
    if not candidates:
        return None
    best_d = max(d for d, _ in candidates)
    idxs = [i for d, i in candidates if d == best_d]
    return idxs[-1] if prefer_last else idxs[0]


def param_sharding(mesh, shape: Sequence[int], strategy: str = "dp") -> Tuple[Optional[str], ...]:
    """The spec of ONE parameter of Flax-layout ``shape`` under
    ``strategy``: one entry a dim, a mesh axis name or None; () when
    replicated (JAX ``param_sharding``)."""
    axes = mesh_axes(mesh)
    shape = tuple(shape)
    if strategy == "dp" or not shape:
        return ()
    spec = [None] * len(shape)
    if strategy in ("fsdp", "tp"):
        axis = "fsdp" if strategy == "fsdp" else "model"
        if axis not in axes:
            return ()
        ax = _best_axis(shape, axes[axis])
        if ax is None:
            return ()
        spec[ax] = axis
        return tuple(spec)
    if strategy in ("fsdp_tp", "dp_tp"):
        # model axis on the last divisible dim, fsdp on another if present
        if "model" in axes:
            ax = _best_axis(shape, axes["model"])
            if ax is not None:
                spec[ax] = "model"
        if strategy == "fsdp_tp" and "fsdp" in axes:
            free = [i for i, s in enumerate(spec) if s is None]
            cands = [i for i in free if shape[i] % axes["fsdp"] == 0]
            if cands:
                spec[max(cands, key=lambda i: shape[i])] = "fsdp"
        return tuple(spec)
    return ()


def flax_layout(name: str, shape: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(the Flax-layout shape of the port's parameter ``name``, the port dim
    of each Flax dim): a 2-d dense ``weight`` [out, in] is a Flax kernel
    [in, out]; every other leaf is laid out as in Flax."""
    shape = tuple(shape)
    if name.rsplit(".", 1)[-1] == "weight" and len(shape) == 2:
        return shape[::-1], (1, 0)
    return shape, tuple(range(len(shape)))


def spec_to_placements(mesh, spec: Sequence[Optional[str]]):
    """A JAX spec (one axis name or None a dim) -> DTensor placements, one a
    mesh axis in mesh order: ``Shard(dim)`` where the axis shards a dim,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {axis: dim for dim, axis in enumerate(spec) if axis is not None}
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate() for a in mesh_axes(mesh))


def _port_spec(spec, dims, ndim: int):
    """A spec on the Flax layout -> the same spec on the port's dims."""
    port = [None] * ndim
    for flax_dim, axis in enumerate(spec):
        port[dims[flax_dim]] = axis
    return tuple(port) if spec else ()


def param_placements(mesh, name: str, shape: Sequence[int], strategy: str = "dp"):
    """DTensor placements of the port's parameter ``name`` of ``shape``:
    the JAX rule on its Flax layout, mapped back to the port's dims."""
    flax_shape, dims = flax_layout(name, shape)
    spec = param_sharding(mesh, flax_shape, strategy)
    return spec_to_placements(mesh, _port_spec(spec, dims, len(shape)))


def shard_params(mesh, named_shapes, strategy: str = "dp"):
    """{name: placements} for (name, parameter or shape) pairs, e.g. a
    module's ``named_parameters()``."""
    return {name: param_placements(mesh, name, getattr(p, "shape", p), strategy)
            for name, p in named_shapes}


def logical_axis_rules(strategy: str = "dp"):
    """Logical-axis -> mesh-axis rules (JAX ``logical_axis_rules``):
    ``strategy`` is underscore-composable from {"dp", "fsdp", "tp", "sp",
    "ep", "zero"} — e.g. "dp", "fsdp_tp", "dp_sp", "dp_zero"."""
    rules = {"embed": None, "mlp": None, "heads": None, "kv": None,
             "vocab": None, "expert": None}
    parts = set(strategy.split("_"))
    unknown = parts - set(STRATEGY_PARTS)
    if unknown:
        raise ValueError("Unknown strategy {!r} (bad parts: {})".format(strategy, sorted(unknown)))
    if "fsdp" in parts:
        rules["embed"] = "fsdp"
    if "tp" in parts:
        rules.update(mlp="model", heads="model", kv="model", vocab="model")
    if "ep" in parts:
        rules["expert"] = "expert"
    # "dp" and "sp" add no param sharding (sp shards activations' sequence
    # dim: batch_sharding and ring attention), nor does "zero" (it shards
    # the optimizer state: zero_opt_sharding).
    return list(rules.items())


def logical_spec(axes: Sequence[Optional[str]], rules, mesh) -> Tuple[Optional[str], ...]:
    """One parameter's spec (a mesh axis or None for each of its dims) from
    its logical axes (one name or None a dim): each name through ``rules``
    (``logical_axis_rules``), a mesh axis ``mesh`` lacks dropped."""
    names, rules = mesh_axes(mesh), dict(rules)
    spec = (rules.get(name) if name else None for name in axes)
    return tuple(axis if axis in names else None for axis in spec)


def logical_axes(model) -> Dict[str, Tuple[Optional[str], ...]]:
    """{parameter name: logical axes in the port's dim order} of every
    parameter that ``model``'s modules declare (each module's
    ``param_axes()``, keyed by the parameter's name in the module)."""
    out = {}
    for prefix, module in model.named_modules():
        declare = getattr(module, "param_axes", None)
        if declare is None:
            continue
        for leaf, axes in declare().items():
            out[prefix + "." + leaf if prefix else leaf] = tuple(axes)
    return out


def logical_placements(model, mesh, strategy: str = "dp") -> Dict[str, Tuple[Optional[str], ...]]:
    """{name: spec} of every parameter of ``model`` under ``strategy`` on
    ``mesh``: its declared logical axes through the strategy's rules, () for
    a parameter without a declaration (replicated)."""
    rules = logical_axis_rules(strategy)
    declared = logical_axes(model)
    out = {}
    for name, p in model.named_parameters():
        axes = declared.get(name)
        if axes is not None and len(axes) != p.ndim:
            raise ValueError("{} declares {} logical axes for a {}-d parameter".format(
                name, len(axes), p.ndim))
        out[name] = () if axes is None else logical_spec(axes, rules, mesh)
    return out


def shard_of(t, spec: Sequence[Optional[str]], env):
    """This rank's block of the whole tensor ``t`` under ``spec``: each
    sharded dim cut into the axis's size and the rank's coordinate kept;
    a dim that does not divide raises."""
    for dim, axis in enumerate(spec):
        n = env.axis_size(axis) if axis is not None else 1
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError("dim {} of size {} does not divide over {} ranks of {!r}".format(
                dim, t.shape[dim], n, axis))
        rows = t.shape[dim] // n
        t = t.narrow(dim, env.axis_index(axis) * rows, rows)
    return t


def shard_state_dict(state, specs, env):
    """A rank's state dict: each tensor of the whole ``state`` (every rank
    drew or loaded the same values) cut to its shard under ``specs``
    ({name: spec}, ``logical_placements``; a missing name is replicated),
    copied so that the whole tensors can be freed."""
    return {name: shard_of(t, specs.get(name, ()), env).clone() for name, t in state.items()}


def batch_sharding(mesh, ndim: int = 2, shape=None) -> Tuple[Optional[object], ...]:
    """Spec of a batch leaf: dim 0 over every data-like axis (a tuple of
    names, or None without one), dim 1 over "seq" when the mesh has it and
    (given ``shape``) it divides; the rest replicated."""
    axes = mesh_axes(mesh)
    if shape is not None:
        ndim = len(shape)
    data_axes = tuple(a for a in DATA_AXES if a in axes)
    rest = [None] * (ndim - 1)
    if ndim >= 2 and "seq" in axes and (shape is None or shape[1] % axes["seq"] == 0):
        rest[0] = "seq"
    return (data_axes if data_axes else None, *rest)


@functools.lru_cache(maxsize=1024)
def _cached_batch_sharding(axes: Tuple[Tuple[str, int], ...], shape):
    return batch_sharding(dict(axes), shape=shape)


def cached_batch_sharding(mesh, shape):
    """``batch_sharding`` memoized by (mesh axes, leaf shape), bounded."""
    return _cached_batch_sharding(tuple(mesh_axes(mesh).items()), tuple(shape))


def validate_zero_strategy(mesh, strategy: str) -> bool:
    """True iff the "zero" part is active; raises where it would silently
    do the wrong thing."""
    parts = set(strategy.split("_"))
    if "zero" not in parts:
        return False
    overlapping = parts & {"fsdp", "tp", "ep"}
    if overlapping:
        raise ValueError(
            "strategy part 'zero' composes with dp/sp only (got {!r}): "
            "fsdp already de-duplicates moments (ZeRO-3), and forcing the "
            "data-axis layout would clobber tp/ep moment sharding.".format(strategy))
    axes = mesh_axes(mesh)
    if "data" not in axes:
        raise ValueError(
            "strategy part 'zero' needs a 'data' mesh axis to shard the "
            "optimizer state over; mesh has {}".format(tuple(axes)))
    return True


def zero_opt_sharding(mesh, strategy: str, shape) -> Optional[Tuple[Optional[str], ...]]:
    """Spec of ONE optimizer-state leaf under the "zero" part (ZeRO-1,
    arXiv:2004.13336): the leading dim over "data" when it divides,
    replicated otherwise; None without a "zero" part."""
    if not validate_zero_strategy(mesh, strategy):
        return None
    n = mesh_axes(mesh)["data"]
    shape = tuple(shape)
    if len(shape) >= 1 and shape[0] > 0 and shape[0] % n == 0:
        return ("data",) + (None,) * (len(shape) - 1)
    return ()


def zero_placements(mesh, name: str, shape, strategy: str):
    """DTensor placements of the optimizer state of the port's parameter
    ``name`` under "zero": ``zero_opt_sharding`` on its Flax layout (the
    leading dim of a Flax kernel is a dense weight's dim 1 here), mapped
    back to the port's dims; None without a "zero" part."""
    flax_shape, dims = flax_layout(name, shape)
    spec = zero_opt_sharding(mesh, strategy, flax_shape)
    if spec is None:
        return None
    return spec_to_placements(mesh, _port_spec(spec, dims, len(tuple(shape))))


def apply_zero_sharding(tree, mesh, strategy: str, placer):
    """Map every optimizer-state leaf (a dict tree of tensors) through
    ``placer(leaf, spec)`` under the "zero" layout; a no-op without it."""
    if not validate_zero_strategy(mesh, strategy):
        return tree

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(place(v) for v in x)
        return placer(x, zero_opt_sharding(mesh, strategy, getattr(x, "shape", ())))

    return place(tree)
