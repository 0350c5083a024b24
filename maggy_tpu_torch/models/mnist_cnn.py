"""MNIST CNN and MLP — the README random-search example's models.

Counterparts of ``maggy_tpu/models/mnist_cnn.py``. Both take the JAX
package's NHWC batch ([B, H, W, C]), so one batch feeds both. Flax infers a
Dense layer's input width when it is first called; these modules compute it
from ``image_size`` (28 in ``examples/mnist_hpo.py``, 16 in ``bench.py``).
Convolutions pad "same", max-pools are "valid" with stride = window, and the
CNN's activations are permuted back to NHWC before the flatten, so the first
Dense kernel transposes from Flax as it is (``flax_to_state_dict``).
Each module keeps its constructor's values as a frozen ``cfg``, which with
its type is its warm-cache identity (``models/params.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.models.llama import TRUNC_NORMAL_STD
from maggy_tpu_torch.models.params import check_device, init_targets


@torch.no_grad()
def _lecun_normal(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initializers: lecun_normal kernels (normal truncated
    at +-2 sigma, sigma = sqrt(1/fan_in) / TRUNC_NORMAL_STD, fan_in over the
    receptive field and input channels) and zero biases."""
    for name, p in init_targets(module, torch.float32):
        if name.endswith("weight"):
            std = math.sqrt(1.0 / (p[0].numel())) / TRUNC_NORMAL_STD
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
        else:
            p.zero_()


@dataclasses.dataclass(frozen=True)
class MnistCNNConfig:
    kernel_size: int
    pool_size: int
    dropout: float
    features: int
    num_classes: int
    image_size: int
    channels: int


@dataclasses.dataclass(frozen=True)
class MnistMLPConfig:
    features: int
    num_classes: int
    image_size: int
    channels: int


class MnistCNN(nn.Module):
    """Two (conv, ReLU, max-pool) blocks with ``features`` and
    2 x ``features`` channels, a 128-unit ReLU hidden layer (dropout when
    ``train`` and ``dropout`` > 0), and ``num_classes`` logits."""

    def __init__(self, kernel_size: int = 3, pool_size: int = 2, dropout: float = 0.0,
                 features: int = 32, num_classes: int = 10, image_size: int = 28,
                 channels: int = 1, device="cuda"):
        super().__init__()
        device = check_device(device)
        self.cfg = MnistCNNConfig(kernel_size, pool_size, dropout, features, num_classes,
                                  image_size, channels)
        self.pool_size = pool_size
        self.dropout = dropout
        self.conv0 = nn.Conv2d(channels, features, kernel_size, padding="same", device=device)
        self.conv1 = nn.Conv2d(features, 2 * features, kernel_size, padding="same",
                               device=device)
        side = image_size // pool_size // pool_size
        if side < 1:
            raise ValueError("image_size {} leaves nothing after two {}x{} pools".format(
                image_size, pool_size, pool_size))
        self.dense0 = nn.Linear(side * side * 2 * features, 128, device=device)
        self.dense1 = nn.Linear(128, num_classes, device=device)

    @property
    def identity(self):
        return type(self), self.cfg

    def init_weights(self, generator: torch.Generator) -> None:
        _lecun_normal(self, generator)

    def forward(self, x, train: bool = False):
        p = self.pool_size
        x = x.float().permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.conv0(x)), p, stride=p)
        x = F.max_pool2d(F.relu(self.conv1(x)), p, stride=p)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # the Flax NHWC flatten
        x = F.relu(self.dense0(x))
        if self.dropout > 0:
            x = F.dropout(x, self.dropout, training=train)
        return self.dense1(x)


class MnistMLP(nn.Module):
    """Dense-only classifier: flatten, ``features`` tanh units, logits."""

    def __init__(self, features: int = 8, num_classes: int = 10, image_size: int = 28,
                 channels: int = 1, device="cuda"):
        super().__init__()
        device = check_device(device)
        self.cfg = MnistMLPConfig(features, num_classes, image_size, channels)
        self.dense0 = nn.Linear(image_size * image_size * channels, features, device=device)
        self.dense1 = nn.Linear(features, num_classes, device=device)

    @property
    def identity(self):
        return type(self), self.cfg

    def init_weights(self, generator: torch.Generator) -> None:
        _lecun_normal(self, generator)

    def forward(self, x, train: bool = False):
        x = x.float().reshape(x.shape[0], -1)
        return self.dense1(torch.tanh(self.dense0(x)))


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax ``MnistCNN`` or ``MnistMLP`` param tree (``Conv_i``,
    ``Dense_i``) -> the port module's ``state_dict``: conv kernels HWIO ->
    OIHW, dense kernels [in, out] -> Linear weights [out, in]."""
    out: Dict[str, torch.Tensor] = {}
    for key, leaves in params.items():
        kind, index = key.split("_")
        kernel = torch.from_numpy(np.array(leaves["kernel"], dtype=np.float32))
        if kind == "Conv":
            weight = kernel.permute(3, 2, 0, 1)
        elif kind == "Dense":
            weight = kernel.T
        else:
            raise ValueError("not an MNIST model parameter: {}".format(key))
        name = "{}{}".format(kind.lower(), index)
        out[name + ".weight"] = weight.contiguous()
        out[name + ".bias"] = torch.from_numpy(np.array(leaves["bias"], dtype=np.float32))
    return out
