"""Llama-style decoder-only transformer with optional LoRA adapters
(BASELINE.md config 5: "Llama-3-8B LoRA hyperparameter sweep").

PyTorch counterpart of ``maggy_tpu/models/llama.py`` with the same layout
and numerics: RMSNorm, split-half RoPE computed in fp32, SwiGLU, grouped-query
attention, fp32 parameters (``param_dtype``) read only after a cast to the
compute dtype (``dtype``), LoRA adapters on q/k/v/o, an untied lm head, and
per-layer rematerialization (``torch.utils.checkpoint``) when ``remat``.
Attention goes through ``multi_head_attention``, so a CUDA model whose
sequence length tiles runs the flash kernels (causal, GQA).

Parameter names follow the Flax module names (``layer_i`` -> ``layers.i``),
which is what ``flax_to_state_dict`` relies on. Layouts: dense kernels are
``nn.Linear``-style weights [out, in] (Flax: [in, out]); ``lora_a`` [in, r],
``lora_b`` [r, out], ``embedding`` [vocab, hidden] and ``lm_head``
[hidden, vocab] are kept as in Flax, and so are a ``moe_mlp``'s router and
stacked experts (``num_experts > 0``; ``models/moe.py``), whose
load-balancing losses the Trainer adds to the objective.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from maggy_tpu_torch.models.moe import MoEMLP
from maggy_tpu_torch.models.params import check_device, init_targets
from maggy_tpu_torch.ops.attention import multi_head_attention

#: flax's lecun_normal draws a standard normal truncated at +-2 and divides
#: the scale by the truncated distribution's standard deviation.
TRUNC_NORMAL_STD = 0.87962566103423978

#: The MoE MLP's parameters (Flax layout, copied as they are).
MOE_LEAVES = ("router", "gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_dim: int = 4096
    intermediate_dim: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # LoRA: rank 0 disables adapters.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    remat: bool = True
    # Ring attention (attention_impl="ring") is not ported yet: Llama
    # raises for it.
    attention_impl: str = "auto"
    # Mixture-of-experts: num_experts > 0 replaces the dense MLP with a
    # top-k routed MoEMLP (``models/moe.py``), every expert on the card.
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0

    @staticmethod
    def tiny(vocab_size: int = 256, lora_rank: int = 0) -> "LlamaConfig":
        """Test-size config: same code path, toy shapes."""
        return LlamaConfig(
            vocab_size=vocab_size, hidden_dim=64, intermediate_dim=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_seq_len=128, lora_rank=lora_rank, remat=False)

    @staticmethod
    def llama3_8b(lora_rank: int = 16) -> "LlamaConfig":
        """Llama-3-8B: 8.03B parameters with the 128256-token vocabulary."""
        return LlamaConfig(vocab_size=128256, lora_rank=lora_rank)


def _rms_norm(x, weight, eps):
    """bf16 ``x`` times the fp32 rsqrt promotes to fp32; the product is cast
    back to ``x``'s dtype before the scale (already in that dtype)."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, param_dtype, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim, dtype=param_dtype, device=device))

    def forward(self, x):
        return _rms_norm(x, self.scale.to(x.dtype), self.eps)


def rope(x, positions, theta: float):
    """Rotary position embedding over the last (head_dim) axis, split-half:
    the first and second halves of D are the two coordinates of each
    rotated pair. x: [B, S, H, D]; positions: [B, S]. Computed in fp32,
    returned in x's dtype."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class LoRADense(nn.Module):
    """Bias-free dense layer with an optional low-rank adapter:
    y = x W^T + (x A) B * alpha / r, every factor cast to the compute dtype
    first. ``train.lora.only_lora`` trains only ``lora_a``/``lora_b``.
    ``device`` defaults to the card and raises without one unless it is
    "cpu" (or "meta")."""

    def __init__(self, in_dim: int, features: int, cfg: LlamaConfig, lora_rank: int,
                 device="cuda"):
        super().__init__()
        device = check_device(device)
        self.compute_dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(features, in_dim, dtype=cfg.param_dtype,
                                               device=device))
        self.lora_rank = lora_rank
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.empty(in_dim, lora_rank, dtype=cfg.param_dtype,
                                                   device=device))
            self.lora_b = nn.Parameter(torch.empty(lora_rank, features, dtype=cfg.param_dtype,
                                                   device=device))
            self.lora_scale = cfg.lora_alpha / lora_rank

    def forward(self, x):
        dt = self.compute_dtype
        y = F.linear(x, self.weight.to(dt))
        if self.lora_rank > 0:
            y = y + (x @ self.lora_a.to(dt)) @ self.lora_b.to(dt) * self.lora_scale
        return y


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        H, r = cfg.hidden_dim, cfg.lora_rank
        q_dim, kv_dim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        self.q_proj = LoRADense(H, q_dim, cfg, r, device)
        self.k_proj = LoRADense(H, kv_dim, cfg, r, device)
        self.v_proj = LoRADense(H, kv_dim, cfg, r, device)
        self.o_proj = LoRADense(q_dim, H, cfg, r, device)

    def forward(self, x, positions, mask=None):
        cfg = self.cfg
        B, S, _ = x.shape
        q = self.q_proj(x).reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = multi_head_attention(q, k, v, causal=True, mask=mask)
        return self.o_proj(out.reshape(B, S, cfg.num_heads * cfg.head_dim))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        H, M = cfg.hidden_dim, cfg.intermediate_dim
        self.gate_proj = LoRADense(H, M, cfg, 0, device)
        self.up_proj = LoRADense(H, M, cfg, 0, device)
        self.down_proj = LoRADense(M, H, cfg, 0, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = RMSNorm(cfg.hidden_dim, cfg.norm_eps, cfg.param_dtype, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_dim, cfg.norm_eps, cfg.param_dtype, device)
        if cfg.num_experts > 0:
            self.moe_mlp = MoEMLP(cfg.hidden_dim, cfg.intermediate_dim, cfg.num_experts,
                                  top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                                  dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, positions, mask=None):
        h = x + self.attn(self.attn_norm(x), positions, mask)
        mlp = self.moe_mlp if self.cfg.num_experts > 0 else self.mlp
        return h + mlp(self.mlp_norm(h))


class Llama(nn.Module):
    """tokens [B,S] int -> fp32 logits [B,S,vocab] (rounded to the compute
    dtype first, as the product runs in it), or with ``return_hidden`` the
    final-norm activations [B,S,hidden] and the lm head [hidden,vocab] for
    ``ops.losses.chunked_next_token_loss``."""

    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Llama(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        if cfg.attention_impl == "ring":
            raise NotImplementedError("attention_impl='ring' is not ported yet "
                                      "(ROADMAP.md queue 1 item 8)")
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.hidden_dim, dtype=cfg.param_dtype, device=device))
        self.layers = nn.ModuleList(DecoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_dim, cfg.norm_eps, cfg.param_dtype, device)
        self.lm_head = nn.Parameter(torch.empty(
            cfg.hidden_dim, cfg.vocab_size, dtype=cfg.param_dtype, device=device))

    @property
    def identity(self):
        """The warm cache's model identity (``models/params.py``)."""
        return type(self), self.cfg

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The Flax initializers, drawn from ``generator``: lecun_normal dense
        kernels (normal truncated at +-2 sigma, sigma = sqrt(1/fan_in) /
        TRUNC_NORMAL_STD), normal(0.02) embedding, lm head and ``lora_a``,
        zero ``lora_b``, unit norm scales; the MoE router and stacked
        expert weights lecun_normal too, with Flax's fan-in over every axis
        but the last (the expert axis counts). A frozen base cast to the compute
        dtype (``only_lora``) is drawn in ``param_dtype`` and cast, as when
        it was built."""
        for name, p in init_targets(self, self.cfg.param_dtype):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight",) + MOE_LEAVES:
                fan_in = p.shape[1] if leaf == "weight" else p.numel() // p.shape[-1]
                std = math.sqrt(1.0 / fan_in) / TRUNC_NORMAL_STD
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
            elif leaf in ("embedding", "lm_head", "lora_a"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "lora_b":
                p.zero_()
            else:
                p.fill_(1.0)

    def forward(self, tokens, positions=None, return_hidden: bool = False):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x = F.embedding(tokens, self.embedding.to(cfg.dtype))
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                # Rematerialize each layer: only its input is kept for the
                # backward, which runs the layer's forward again.
                x = checkpoint(layer, x, positions, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, positions)
        x = self.final_norm(x)
        if return_hidden:
            return x, self.lm_head
        return (x @ self.lm_head.to(cfg.dtype)).float()


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax ``Llama`` param tree (nested dicts of arrays, the ``params``
    collection, unboxed) -> this module's ``state_dict``: ``layer_i``
    becomes ``layers.i``, dense ``kernel`` [in,out] becomes ``weight``
    [out,in], every other leaf is copied as it is."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        for key, value in node.items():
            if key.startswith("layer_"):
                key = "layers." + key[len("layer_"):]
            if isinstance(value, dict):
                walk(prefix + key + ".", value)
                continue
            t = torch.from_numpy(np.array(value, dtype=np.float32))
            if key == "kernel":
                out[prefix + "weight"] = t.T.contiguous()
            else:
                out[prefix + key] = t

    walk("", params)
    return out
