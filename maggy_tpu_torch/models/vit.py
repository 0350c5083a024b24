"""Vision Transformer (ViT) classifier.

PyTorch counterpart of ``maggy_tpu/models/vit.py``: a stride-p patch
convolution (unpadded: the image side is a multiple of p), a zero-init CLS
token, normal(0.02) position embeddings, the BERT ``EncoderLayer`` (pre-LN,
``models/bert.py``) with an all-ones mask, a final LayerNorm (eps 1e-6, fp32)
and a dense head on the CLS token in the compute dtype, returned in fp32.
Images are NHWC; the patch grid is flattened row by row as Flax flattens
its NHWC output.

Attention: a ViT's sequence is ``(n / p)^2 + 1`` tokens, never a multiple
of 128 (a square is 0, 1 or 4 mod 8), so ``multi_head_attention`` sends it
to its reference path, as the JAX package's gate does: a ViT launches no
flash kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.models import bert
from maggy_tpu_torch.models.bert import BertConfig, EncoderLayer, LN_EPS, _Dense, _layer_norm
from maggy_tpu_torch.models.params import check_device, init_targets
from maggy_tpu_torch.parallel import sharded


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    hidden_dim: int = 768
    intermediate_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_classes: int = 1000
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def encoder_cfg(self) -> BertConfig:
        """The BertConfig the shared EncoderLayer reads (its vocabulary and
        sequence fields are unused there)."""
        return BertConfig(hidden_dim=self.hidden_dim, intermediate_dim=self.intermediate_dim,
                          num_heads=self.num_heads, dropout=self.dropout, dtype=self.dtype,
                          param_dtype=self.param_dtype)

    @staticmethod
    def tiny(num_classes: int = 10) -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, channels=3, hidden_dim=32,
                         intermediate_dim=64, num_layers=2, num_heads=2,
                         num_classes=num_classes)

    @staticmethod
    def base(num_classes: int = 1000) -> "ViTConfig":
        """ViT-B/16 at 224 x 224 (Dosovitskiy et al. 2020)."""
        return ViTConfig(num_classes=num_classes)


class ViT(nn.Module):
    """images [B, H, W, C] -> fp32 logits [B, num_classes]."""

    def __init__(self, cfg: ViTConfig, device="cuda"):
        super().__init__()
        device = check_device(device)
        self.cfg = cfg
        p, D = cfg.patch_size, cfg.hidden_dim
        enc = cfg.encoder_cfg()
        self.patch_embed = nn.Conv2d(cfg.channels, D, p, stride=p, device=device,
                                     dtype=cfg.param_dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=device, dtype=cfg.param_dtype))
        self.pos_embedding = nn.Parameter(torch.empty(cfg.num_patches + 1, D, device=device,
                                                      dtype=cfg.param_dtype))
        self.layers = nn.ModuleList(EncoderLayer(enc, device) for _ in range(cfg.num_layers))
        self.ln_final = nn.LayerNorm(D, eps=LN_EPS, device=device)
        self.head = _Dense(D, cfg.num_classes, enc, device, (bert.EMBED, None))

    @property
    def identity(self):
        """The warm cache's model identity (``models/params.py``)."""
        return type(self), self.cfg

    def param_axes(self):
        """``maggy_tpu/models/vit.py:85-100``: the patch kernel (OIHW here,
        HWIO in Flax) and its bias, the CLS token and the position embedding
        along the embedding."""
        E = bert.EMBED
        return {"patch_embed.weight": (E, None, None, None), "patch_embed.bias": (E,),
                "cls_token": (None, None, E), "pos_embedding": (None, E)}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The Flax initializers, drawn from ``generator``: normal(0.02) patch
        kernel, position embedding and dense kernels, a zero CLS token and
        zero biases, unit LayerNorm scales."""
        for name, p in init_targets(self, self.cfg.param_dtype):
            if name == "pos_embedding" or (name.endswith("weight") and p.ndim in (2, 4)):
                p.normal_(0.0, 0.02, generator=generator)
            elif ".ln" in name or name.startswith("ln"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.zero_()

    def forward(self, images, train: bool = False):
        cfg = self.cfg
        B, H, W = images.shape[:3]
        if H != cfg.image_size or W != cfg.image_size:
            raise ValueError("Expected {0}x{0} images, got {1}x{2}".format(
                cfg.image_size, H, W))
        dt, D = cfg.dtype, cfg.hidden_dim
        w, b = (sharded.gathered(p).to(dt) for p in (self.patch_embed.weight,
                                                     self.patch_embed.bias))
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), w, b, stride=cfg.patch_size)
        x = x.permute(0, 2, 3, 1).reshape(B, cfg.num_patches, D)  # NHWC rows
        x = torch.cat([sharded.gathered(self.cls_token).to(dt).expand(B, 1, D), x], dim=1)
        x = x + sharded.gathered(self.pos_embedding)[None].to(dt)
        mask = torch.ones(B, cfg.num_patches + 1, dtype=torch.bool, device=x.device)
        for layer in self.layers:
            x = layer(x, mask, train=train)
        x = _layer_norm(self.ln_final, x)
        return self.head(x[:, 0].to(dt)).float()


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax ``ViT`` param tree -> this module's ``state_dict``: the patch
    kernel HWIO -> OIHW and the CLS token as it is; the encoder layers,
    position embedding, final LayerNorm and head as ``bert.flax_to_state_dict``
    converts them."""
    params = dict(params)
    patch, cls = params.pop("patch_embed"), params.pop("cls_token")
    out = bert.flax_to_state_dict(params)
    out["patch_embed.weight"] = torch.from_numpy(
        np.array(patch["kernel"], dtype=np.float32)).permute(3, 2, 0, 1).contiguous()
    out["patch_embed.bias"] = torch.from_numpy(np.array(patch["bias"], dtype=np.float32))
    out["cls_token"] = torch.from_numpy(np.array(cls, dtype=np.float32))
    return out
