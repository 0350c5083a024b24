"""Llama-style decoder-only transformer with optional LoRA adapters
(BASELINE.md config 5: "Llama-3-8B LoRA hyperparameter sweep").

PyTorch counterpart of ``maggy_tpu/models/llama.py`` with the same layout
and numerics: RMSNorm, split-half RoPE computed in fp32, SwiGLU, grouped-query
attention, fp32 parameters (``param_dtype``) read only after a cast to the
compute dtype (``dtype``), LoRA adapters on q/k/v/o, an untied lm head, and
per-layer rematerialization when ``remat`` (``models/remat.py``:
``torch.utils.checkpoint`` in eager autograd, an ``autograd.Function``
that recomputes under ``torch.func.vjp`` inside the vectorized lanes).
Attention goes through ``multi_head_attention``, so a CUDA model whose
sequence length tiles runs the flash kernels (causal, GQA).
``attention_impl="ring"`` runs sequence parallelism instead
(``maggy_tpu/models/llama.py:173-190``): each rank of ``seq_mesh``'s
``seq_axis`` holds one shard of the sequence, its RoPE positions offset by
the shard's start, and attention is ``parallel.ring_attention`` over the
axis (causal only: an explicit mask raises). Its next-token labels are
shifted over the global sequence before it is sharded
(``ops.losses.next_token_labels``).

Parameter names follow the Flax module names (``layer_i`` -> ``layers.i``),
which is what ``flax_to_state_dict`` relies on. Layouts: dense kernels are
``nn.Linear``-style weights [out, in] (Flax: [in, out]); ``lora_a`` [in, r],
``lora_b`` [r, out], ``embedding`` [vocab, hidden] and ``lm_head``
[hidden, vocab] are kept as in Flax, and so are a ``moe_mlp``'s router and
stacked experts (``num_experts > 0``; ``models/moe.py``), whose
load-balancing losses the Trainer adds to the objective.

On a mesh every parameter declares the logical axes of
``maggy_tpu/models/llama.py:94-255`` (``param_axes``), and the mesh
Trainer cuts it by them (``parallel/sharded.py``). Under tensor
parallelism q/k/v are column-parallel and ``o_proj`` row-parallel, each
rank attending with its own heads (a head count that does not divide the
"model" axis raises, where GSPMD would pad); the vocab-cut embedding looks
up the rows a rank holds and sums over "model". The vocab-cut head, two
ways: ``return_hidden`` hands it on cut, and ``ops.losses``' chunked
losses (what the Llama sweeps use) compute the softmax vocab-parallel,
the max and the sum of exponentials combined over "model" (no rank holds
the whole head, nor the whole logits); the dense logits gather the head
whole first (its gradient: this rank's slice), so that any loss function
of logits runs unchanged, each "model" rank computing the same loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.models import variables
from maggy_tpu_torch.models.moe import MoEMLP
from maggy_tpu_torch.models.params import check_device, init_targets
from maggy_tpu_torch.models.remat import remat_layer
from maggy_tpu_torch.ops.attention import multi_head_attention
from maggy_tpu_torch.parallel import sharded

#: Logical axis names (``maggy_tpu/models/llama.py``), mapped onto mesh
#: axes by ``parallel.sharding.logical_axis_rules``.
EMBED, HEADS, KV, MLP_AXIS, VOCAB = "embed", "heads", "kv", "mlp", "vocab"

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
    # Sequence parallelism: attention_impl="ring" runs ring attention over
    # ``seq_mesh``'s ``seq_axis`` (a DeviceMesh, ``ShardingEnv.mesh``), each
    # rank holding one shard of the sequence; "auto" is
    # multi_head_attention.
    attention_impl: str = "auto"
    seq_axis: str = "seq"
    seq_mesh: Any = None
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

    def param_axes(self):
        return {"scale": (EMBED,)}

    def forward(self, x):
        return _rms_norm(x, sharded.gathered(self.scale).to(x.dtype), self.eps)


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
    "cpu" (or "meta"). ``kernel_axes`` are the Flax kernel's logical axes
    (in, out); the weight is [out, in], ``lora_a`` [in, r] and ``lora_b``
    [r, out]. Under tensor parallelism (a weight cut over "model") an
    output-cut layer is column-parallel and an input-cut one row-parallel:
    the adapter's low-rank product enters or leaves the region on its own,
    so that the replicated factor's gradient is whole on every rank."""

    def __init__(self, in_dim: int, features: int, cfg: LlamaConfig, lora_rank: int,
                 device="cuda", kernel_axes=(None, None)):
        super().__init__()
        device = check_device(device)
        self.kernel_axes = tuple(kernel_axes)
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

    def param_axes(self):
        a_in, a_out = self.kernel_axes
        axes = {"weight": (a_out, a_in)}
        if self.lora_rank > 0:
            axes.update(lora_a=(a_in, None), lora_b=(None, a_out))
        return axes

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight
        y = F.linear(sharded.column_parallel(x, w), sharded.gathered(w).to(dt))
        y = sharded.row_parallel(y, w)
        if self.lora_rank > 0:
            xa = x @ sharded.gathered(self.lora_a).to(dt)
            xa = sharded.column_parallel(sharded.row_parallel(xa, w), w)
            y = y + xa @ sharded.gathered(self.lora_b).to(dt) * self.lora_scale
        return y


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        H, r = cfg.hidden_dim, cfg.lora_rank
        q_dim, kv_dim = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        self.q_proj = LoRADense(H, q_dim, cfg, r, device, (EMBED, HEADS))
        self.k_proj = LoRADense(H, kv_dim, cfg, r, device, (EMBED, KV))
        self.v_proj = LoRADense(H, kv_dim, cfg, r, device, (EMBED, KV))
        self.o_proj = LoRADense(q_dim, H, cfg, r, device, (HEADS, EMBED))

    def forward(self, x, positions, mask=None):
        """Under tensor parallelism each rank attends with its own heads:
        ``num_heads / n`` query and ``num_kv_heads / n`` kv heads of the n
        "model" ranks (a count that does not divide raises)."""
        cfg = self.cfg
        B, S, _ = x.shape
        sharded.check_heads(cfg.num_heads, cfg.num_kv_heads, self.q_proj.weight)
        q = self.q_proj(x).reshape(B, S, -1, cfg.head_dim)
        k = self.k_proj(x).reshape(B, S, -1, cfg.head_dim)
        v = self.v_proj(x).reshape(B, S, -1, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cfg.attention_impl == "ring":
            if mask is not None:
                raise ValueError("attention_impl='ring' supports only causal masking; "
                                 "got an explicit mask")
            from maggy_tpu_torch.parallel.mesh import axis_group
            from maggy_tpu_torch.parallel.ring_attention import ring_attention

            # GQA rides the ring natively: k/v circulate with Hkv heads.
            out = ring_attention(q, k, v, axis_group(cfg.seq_mesh, cfg.seq_axis), causal=True)
        else:
            out = multi_head_attention(q, k, v, causal=True, mask=mask)
        return self.o_proj(out.reshape(B, S, -1))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        H, M = cfg.hidden_dim, cfg.intermediate_dim
        # The JAX package's dense MLP names its kernels' hidden dim with its
        # own ``MLP`` module class, which shadows the logical axis name
        # (``maggy_tpu/models/llama.py:31, 194``): no rule maps it, so the
        # JAX Trainer never cuts that dim, and neither does the port.
        self.gate_proj = LoRADense(H, M, cfg, 0, device, (EMBED, None))
        self.up_proj = LoRADense(H, M, cfg, 0, device, (EMBED, None))
        self.down_proj = LoRADense(M, H, cfg, 0, device, (None, EMBED))

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
                                  dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device,
                                  embed_axis=EMBED, mlp_axis=MLP_AXIS)
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
        if cfg.attention_impl == "ring" and cfg.seq_mesh is None:
            raise ValueError("attention_impl='ring' requires cfg.seq_mesh (a DeviceMesh with "
                             "a '{}' axis)".format(cfg.seq_axis))
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

    def param_axes(self):
        return {"embedding": (VOCAB, EMBED), "lm_head": (EMBED, VOCAB)}

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
            start = 0
            if cfg.attention_impl == "ring":
                # This rank's shard of the global sequence.
                from maggy_tpu_torch.parallel.mesh import axis_index

                start = axis_index(cfg.seq_mesh, cfg.seq_axis) * tokens.shape[1]
            positions = torch.arange(start, start + tokens.shape[1],
                                     device=tokens.device).expand(tokens.shape)
        x = sharded.vocab_parallel_embedding(tokens, self.embedding, cfg.dtype)
        group = variables.stats_group()
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                # Rematerialize each layer: only its inputs are kept for the
                # backward, which runs the layer's forward again.
                x = remat_layer(layer, x, positions, group=group)
            else:
                x = layer(x, positions)
        x = self.final_norm(x)
        if return_hidden:
            # A vocab-cut head stays cut: the chunked losses run
            # vocab-parallel on it (ops/losses.py).
            return x, sharded.gathered(self.lm_head)
        # Dense logits: a vocab-cut head is gathered whole, so that any loss
        # function reads whole logits (every "model" rank computes the same).
        return (x @ sharded.whole(self.lm_head, 1).to(cfg.dtype)).float()


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
