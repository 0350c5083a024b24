"""Model surgery for LOCO ablation.

Counterpart of ``maggy_tpu/models/surgery.py``. The reference rebuilds Keras
models from json with a layer removed (``loco.py:82-136``), never touching
the first (input) or last (output) layer. Here a model is a declarative
list of named layer factories: ``AblatableSequential`` builds only the
layers whose names survive ``filter_layers`` (exact names, or prefixes for
prefix groups; first and last kept), so its parameters are the kept
layers' own, as in Flax, where an ablated layer's ``make()`` never runs.

Where the JAX package's ``nn.Dense`` infers its input width, a factory here
may return a lazy module (``nn.LazyLinear``): ablating an input feature
changes that width from trial to trial. A lazy module has no width, so it
has no ``identity`` and takes a private warm slot, and ``Trainer.init``
materializes it from ``example_inputs`` before the optimizer and the
captured step see it. ``flax_to_state_dict`` loads a Flax
``AblatableSequential``'s params into the kept layers in order.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, FrozenSet, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import is_lazy

from maggy_tpu_torch.models.llama import TRUNC_NORMAL_STD
from maggy_tpu_torch.models.params import init_targets


def filter_layers(names: Sequence[str], ablated: FrozenSet[str]) -> List[str]:
    """Names surviving ablation. A spec entry matches a layer by exact name
    or as a prefix; first and last layers are always kept (reference
    ``loco.py:99-134``)."""
    if not ablated:
        return list(names)
    kept = []
    for i, name in enumerate(names):
        protected = i == 0 or i == len(names) - 1
        hit = any(name == a or name.startswith(a) for a in ablated)
        if protected or not hit:
            kept.append(name)
    return kept


class AblatableSequential(nn.Module):
    """A sequential module over ``(name, make_layer)`` pairs, built without
    the layers ``ablated_layers`` names (by name or prefix). ``make_layer()``
    returns an ``nn.Module`` and runs with ``device`` as the default device
    (``"meta"``, the default, describes the model without storage, as the
    port's other models do; a lazy layer stays lazy there until it sees
    data)."""

    def __init__(self, layers: Sequence[Tuple[str, Callable[[], nn.Module]]],
                 ablated_layers: FrozenSet[str] = frozenset(), device="meta"):
        super().__init__()
        self.spec = tuple(layers)
        self.ablated_layers = frozenset(ablated_layers)
        self.kept = tuple(filter_layers([n for n, _ in self.spec], self.ablated_layers))
        kept = set(self.kept)
        with torch.device(device):
            self.layers = nn.ModuleDict(
                (name, make()) for name, make in self.spec if name in kept)

    @property
    def identity(self):
        """The warm cache's model identity (``models/params.py``): the kept
        names and the layer factories; None (a private slot) while a lazy
        layer's width is unknown, since trials that ablate input features
        build the same layers at other widths."""
        if any(is_lazy(p) for p in self.parameters()):
            return None
        return type(self), self.kept, tuple(make for name, make in self.spec
                                            if name in self.kept)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Each kept layer's own ``init_weights`` where it has one, else
        Flax's defaults drawn from ``generator``: lecun_normal kernels (fan-in
        over all but the output axis) and zero biases."""
        for layer in self.layers.values():
            if hasattr(layer, "init_weights"):
                layer.init_weights(generator)
                continue
            for name, p in init_targets(layer, torch.float32):
                if p.ndim >= 2:
                    std = math.sqrt(1.0 / p[0].numel()) / TRUNC_NORMAL_STD
                    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
                else:
                    p.zero_()

    def forward(self, x, *args, **kwargs):
        for layer in self.layers.values():
            x = layer(x)
        return x


def ablatable_model_generator(layers: Sequence[Tuple[str, Callable]],
                              ablated_layers: FrozenSet[str] = frozenset(), device="meta"):
    """A ``base_model_generator`` for ``AblationStudy``: the
    ``AblatableSequential`` minus the ablated components."""
    return AblatableSequential(tuple(layers), frozenset(ablated_layers), device=device)


def flax_to_state_dict(params: Dict[str, Any], model: AblatableSequential) -> Dict[str, torch.Tensor]:
    """A Flax ``AblatableSequential``'s params -> ``model``'s ``state_dict``.
    Flax names the kept layers' modules in the order they were made
    (``Dense_0``, ``Sequential_0``, ...), so the i-th top-level entry is the
    i-th kept layer; within it, dense kernels [in, out] in order become its
    ``nn.Linear`` weights [out, in]."""
    def dense_leaves(tree):
        if "kernel" in tree:
            yield tree
            return
        for key in tree:
            yield from dense_leaves(tree[key])

    entries = list(params.values())
    if len(entries) != len(model.layers):
        raise ValueError("{} Flax layers for {} kept layers {}".format(
            len(entries), len(model.layers), list(model.kept)))
    out: Dict[str, torch.Tensor] = {}
    for (name, layer), tree in zip(model.layers.items(), entries):
        linears = [(n, m) for n, m in layer.named_modules() if isinstance(m, nn.Linear)]
        leaves = list(dense_leaves(tree))
        if len(leaves) != len(linears):
            raise ValueError("layer {}: {} Flax kernels for {} linear modules".format(
                name, len(leaves), len(linears)))
        for (sub, _), leaf in zip(linears, leaves):
            prefix = "layers.{}.{}".format(name, sub + "." if sub else "")
            out[prefix + "weight"] = torch.from_numpy(
                np.array(leaf["kernel"], dtype=np.float32)).T.contiguous()
            out[prefix + "bias"] = torch.from_numpy(np.array(leaf["bias"], dtype=np.float32))
    return out
