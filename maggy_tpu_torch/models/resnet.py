"""ResNet for CIFAR-10 (BASELINE.md config 3: "ResNet-50/CIFAR-10 ASHA sweep").

PyTorch counterpart of ``maggy_tpu/models/resnet.py``: basic and
bottleneck blocks, an NHWC input (permuted to NCHW inside), convolutions
in ``dtype`` and batch-norm statistics in fp32. Two things follow Flax
rather than PyTorch's defaults, and the output shapes do not show either:

- **SAME padding** pads ``(total // 2, total - total // 2)`` with
  ``total = max((ceil(n / s) - 1) * s + k - n, 0)``: a stride-2 3x3
  convolution on an even side pads (0, 1), where ``padding=1`` pads (1, 1).
  Every convolution pads explicitly (``F.pad``) and then runs unpadded;
  the stem's max-pool pads with -inf.
- **BatchNorm** is Flax's (``batch_norm``): momentum 0.9 on the running
  statistics (PyTorch's convention would call it 0.1), eps 1e-5, batch
  statistics in fp32 with the variance as E[x^2] - E[x]^2, and the running
  variance updated with that biased batch variance (``nn.BatchNorm2d``
  uses the unbiased one). ``train`` chooses batch or running statistics;
  ``module.training`` plays no part.

Parameter and buffer names follow the Flax modules (``Conv_j`` ->
``convs.j``, ``BatchNorm_j`` -> ``norms.j``, each block ``blocks.i``), which
``flax_to_state_dict`` relies on. The running statistics are buffers, and
``init_weights`` writes them in place, so a retired unit's captured step
goes on reading and updating the same tensors (``train/warm.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.models.llama import TRUNC_NORMAL_STD
from maggy_tpu_torch.models.params import check_device, init_targets
from maggy_tpu_torch.models.variables import buffers_mutable

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def same_padding(n: int, k: int, s: int):
    """Flax's SAME padding (lo, hi) of a side ``n`` for window ``k``, stride ``s``."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """Pad an NCHW tensor as Flax's SAME does for a k x k window at stride s."""
    top, bottom = same_padding(x.shape[2], k, s)
    left, right = same_padding(x.shape[3], k, s)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def batch_norm(x, mean, var, scale, bias, train: bool):
    """Flax BatchNorm(momentum=0.9, dtype=float32) over the channels of an
    NCHW tensor. With ``train`` it normalizes with the batch's statistics
    and updates the ``mean`` and ``var`` buffers in place (which needs
    mutable buffers, ``models/variables.py``); else it normalizes with them."""
    x = x.float()
    if train:
        if not buffers_mutable():
            raise ValueError("BatchNorm(train=True) updates its running statistics, and the "
                             "buffers are immutable here: pass has_aux_collections=True to "
                             "the Trainer")
        batch_mean = x.mean((0, 2, 3))
        batch_var = (x.square().mean((0, 2, 3)) - batch_mean.square()).clamp_min(0.0)
        with torch.no_grad():
            mean.copy_(BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * batch_mean)
            var.copy_(BN_MOMENTUM * var + (1 - BN_MOMENTUM) * batch_var)
        mean, var = batch_mean, batch_var
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + BN_EPS) * scale
    return (x - mean.reshape(shape)) * mul.reshape(shape) + bias.reshape(shape)


class Conv(nn.Module):
    """Flax ``nn.Conv(features, (k, k), stride, use_bias=False)``: SAME
    padding, input and fp32 kernel cast to ``dtype``."""

    def __init__(self, in_ch: int, features: int, k: int, stride: int, dtype, device):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(features, in_ch, k, k, device=device))

    def forward(self, x):
        x = _pad_same(x.to(self.dtype), self.k, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)


class BatchNorm(nn.Module):
    """Flax BatchNorm's parameters (``scale``, ``bias``) and ``batch_stats``
    (the ``mean`` and ``var`` buffers); ``zero_scale`` for the last norm of
    a block, whose scale Flax initializes to zero."""

    def __init__(self, features: int, device, zero_scale: bool = False):
        super().__init__()
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))

    def forward(self, x, train: bool):
        return batch_norm(x, self.mean, self.var, self.scale, self.bias, train)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int, dtype, device):
        super().__init__()
        self.convs = nn.ModuleList([Conv(in_ch, features, 3, stride, dtype, device),
                                    Conv(features, features, 3, 1, dtype, device)])
        self.norms = nn.ModuleList([BatchNorm(features, device),
                                    BatchNorm(features, device, zero_scale=True)])
        self.project = in_ch != features or stride != 1
        if self.project:
            self.convs.append(Conv(in_ch, features, 1, stride, dtype, device))
            self.norms.append(BatchNorm(features, device))

    def forward(self, x, train: bool):
        y = F.relu(self.norms[0](self.convs[0](x), train))
        y = self.norms[1](self.convs[1](y), train)
        residual = self.norms[2](self.convs[2](x), train) if self.project else x
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int, dtype, device):
        super().__init__()
        out = features * 4
        self.convs = nn.ModuleList([Conv(in_ch, features, 1, 1, dtype, device),
                                    Conv(features, features, 3, stride, dtype, device),
                                    Conv(features, out, 1, 1, dtype, device)])
        self.norms = nn.ModuleList([BatchNorm(features, device), BatchNorm(features, device),
                                    BatchNorm(out, device, zero_scale=True)])
        self.project = in_ch != out or stride != 1
        if self.project:
            self.convs.append(Conv(in_ch, out, 1, stride, dtype, device))
            self.norms.append(BatchNorm(out, device))

    def forward(self, x, train: bool):
        y = F.relu(self.norms[0](self.convs[0](x), train))
        y = F.relu(self.norms[1](self.convs[1](y), train))
        y = self.norms[2](self.convs[2](y), train)
        residual = self.norms[3](self.convs[3](x), train) if self.project else x
        return F.relu(residual + y)


STAGE_SIZES = {
    18: ([2, 2, 2, 2], BasicBlock),
    34: ([3, 4, 6, 3], BasicBlock),
    50: ([3, 4, 6, 3], BottleneckBlock),
    101: ([3, 4, 23, 3], BottleneckBlock),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int
    num_classes: int
    width: int
    dtype: Any
    cifar_stem: bool
    channels: int


class ResNet(nn.Module):
    """images [B, H, W, channels] -> fp32 logits [B, num_classes]. The
    CIFAR stem is a 3x3 convolution; the other is a 7x7 stride-2
    convolution and a 3x3 stride-2 max-pool. Flax infers the input
    channels at init; here they are ``channels`` (3)."""

    def __init__(self, depth: int = 50, num_classes: int = 10, width: int = 64,
                 dtype=torch.float32, cifar_stem: bool = True, channels: int = 3,
                 device="cuda"):
        super().__init__()
        device = check_device(device)
        self.cfg = ResNetConfig(depth, num_classes, width, dtype, cifar_stem, channels)
        stages, block_cls = STAGE_SIZES[depth]
        self.stem = Conv(channels, width, 3 if cifar_stem else 7, 1 if cifar_stem else 2,
                         dtype, device)
        self.stem_norm = BatchNorm(width, device)
        blocks, in_ch = [], width
        for i, n_blocks in enumerate(stages):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(in_ch, width * 2 ** i, stride, dtype, device))
                in_ch = width * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(in_ch, num_classes, device=device)

    @property
    def identity(self):
        """The warm cache's model identity (``models/params.py``)."""
        return type(self), self.cfg

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The Flax initializers, drawn from ``generator``: lecun_normal
        convolution and dense kernels (fan-in over the window and input
        channels), zero dense bias, unit BatchNorm scales (zero for each
        block's last) and zero biases; the running statistics reset in
        place to mean 0 and variance 1."""
        for name, p in init_targets(self, torch.float32):
            module_name, leaf = name.rsplit(".", 1)
            if leaf == "weight":
                std = math.sqrt(1.0 / p[0].numel()) / TRUNC_NORMAL_STD
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
            elif leaf == "scale":
                p.fill_(0.0 if self.get_submodule(module_name).zero_scale else 1.0)
            else:
                p.zero_()
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.mean.zero_()
                module.var.fill_(1.0)

    def forward(self, x, train: bool = False):
        # NHWC -> contiguous NCHW: the permuted view is channels-last, on
        # which the CPU build's 1x1 stride-2 convolution backward was seen
        # to corrupt the heap (torch 2.13).
        x = x.permute(0, 3, 1, 2).contiguous()
        x = self.stem(x)
        if not self.cfg.cifar_stem:
            x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, stride=2)
        x = F.relu(self.stem_norm(x, train))
        for block in self.blocks:
            x = block(x, train)
        return self.head(x.mean((2, 3)).float())


def flax_to_state_dict(params: Dict[str, Any],
                       batch_stats: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """A Flax ``ResNet``'s ``params`` (and ``batch_stats``) trees -> this
    module's ``state_dict``: conv kernels HWIO -> OIHW, the dense kernel
    [in, out] -> [out, in], BatchNorm ``scale``/``bias`` as they are, and
    the running ``mean``/``var`` onto the buffers. Without ``batch_stats``
    the result holds the parameters alone."""
    out: Dict[str, torch.Tensor] = {}

    def name(key):
        kind, index = key.rsplit("_", 1)
        return {"Conv": "convs.", "BatchNorm": "norms."}[kind] + index

    def walk(tree, leaf_fn):
        for key, node in tree.items():
            if "Block_" in key:  # BasicBlock_i, BottleneckBlock_i
                prefix = "blocks.{}.".format(key.rsplit("_", 1)[1])
                for sub, leaves in node.items():
                    leaf_fn(prefix + name(sub), leaves)
            else:
                leaf_fn({"Conv_0": "stem", "BatchNorm_0": "stem_norm", "Dense_0": "head"}[key],
                        node)

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def param_leaves(module, leaves):
        if "kernel" in leaves:
            kernel = t(leaves["kernel"])
            out[module + ".weight"] = (kernel.permute(3, 2, 0, 1) if kernel.ndim == 4
                                       else kernel.T).contiguous()
            if "bias" in leaves:
                out[module + ".bias"] = t(leaves["bias"])
        else:
            out[module + ".scale"] = t(leaves["scale"])
            out[module + ".bias"] = t(leaves["bias"])

    def stat_leaves(module, leaves):
        out[module + ".mean"] = t(leaves["mean"])
        out[module + ".var"] = t(leaves["var"])

    walk(params, param_leaves)
    if batch_stats is not None:
        walk(batch_stats, stat_leaves)
    return out
