"""BERT-style encoder (BASELINE.md config 4: "BERT-base GLUE fine-tune HPO").

PyTorch counterpart of ``maggy_tpu/models/bert.py`` with the same pre-LN
layout and numerics: LayerNorm with eps 1e-6 computed in fp32, the tanh
approximation of GELU, fp32 parameters with bf16 compute, fp32 logits, and
dropout only when called with ``train=True``. Attention goes through
``multi_head_attention``, so a CUDA model whose sequence length tiles runs
the flash kernels. Parameter names follow the Flax module names, which is
what ``flax_to_state_dict`` relies on, and each parameter declares the
logical axes of ``maggy_tpu/models/bert.py:45-110`` (``param_axes``) for the
mesh Trainer: under tensor parallelism the q/k/v products are
column-parallel and ``o_proj`` row-parallel, and each rank attends with
``num_heads / n`` heads; the MLP and the LayerNorms are not cut over
"model" (the LayerNorms are not annotated in Flax; the MLP, below).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.models.params import init_targets
from maggy_tpu_torch.ops.attention import multi_head_attention
from maggy_tpu_torch.parallel import sharded

EMBED, HEADS, VOCAB = "embed", "heads", "vocab"

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_dim: int = 768
    intermediate_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    num_classes: int = 2
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(num_classes: int = 2, **overrides) -> "BertConfig":
        """Two layers at head_dim 64 (hidden 128, two heads), for tests."""
        fields = dict(vocab_size=128, hidden_dim=128, intermediate_dim=256,
                      num_layers=2, num_heads=2, max_seq_len=256,
                      num_classes=num_classes, dropout=0.0)
        fields.update(overrides)
        return BertConfig(**fields)

    @staticmethod
    def base(num_classes: int = 2) -> "BertConfig":
        """uncased_L-12_H-768_A-12 (Devlin et al. 2018, bert_config.json)."""
        return BertConfig(num_classes=num_classes)


class _Dense(nn.Linear):
    """nn.Dense(dtype=compute, param_dtype=fp32): fp32 weights, products in
    the compute dtype. ``kernel_axes``: the Flax kernel's logical axes (in,
    out); the bias takes the output's."""

    def __init__(self, fan_in, fan_out, cfg: BertConfig, device, kernel_axes=(None, None)):
        super().__init__(fan_in, fan_out, device=device, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype
        self.kernel_axes = tuple(kernel_axes)

    def param_axes(self):
        a_in, a_out = self.kernel_axes
        return {"weight": (a_out, a_in), "bias": (a_out,)}

    def forward(self, x):
        dt = self.compute_dtype
        w, b = sharded.gathered(self.weight).to(dt), sharded.gathered(self.bias).to(dt)
        x = sharded.column_parallel(x.to(dt), self.weight)
        if sharded.group_of(self.weight, 1, "model") is None:
            return F.linear(x, w, b)
        # Row-parallel: the partial products summed, then the bias.
        return sharded.row_parallel(F.linear(x, w), self.weight) + b


def _layer_norm(ln: nn.LayerNorm, x):
    """flax LayerNorm(dtype=float32): statistics and output in fp32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, LN_EPS)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, M = cfg.hidden_dim, cfg.intermediate_dim
        self.ln_attn = nn.LayerNorm(H, eps=LN_EPS, device=device)
        self.q_proj = _Dense(H, H, cfg, device, (EMBED, HEADS))
        self.k_proj = _Dense(H, H, cfg, device, (EMBED, HEADS))
        self.v_proj = _Dense(H, H, cfg, device, (EMBED, HEADS))
        self.o_proj = _Dense(H, H, cfg, device, (HEADS, EMBED))
        self.ln_mlp = nn.LayerNorm(H, eps=LN_EPS, device=device)
        # The JAX package imports its Llama's ``MLP``, which by then is the
        # MLP module class, not the axis name (``maggy_tpu/models/bert.py:17``):
        # the MLP dim is never cut there, and is not here.
        self.fc_in = _Dense(H, M, cfg, device, (EMBED, None))
        self.fc_out = _Dense(M, H, cfg, device, (None, EMBED))

    def forward(self, x, pad_mask, train: bool = False):
        cfg = self.cfg
        B, S, _ = x.shape
        sharded.check_heads(cfg.num_heads, cfg.num_heads, self.q_proj.weight)
        shape4 = (B, S, -1, cfg.hidden_dim // cfg.num_heads)
        h = _layer_norm(self.ln_attn, x).to(cfg.dtype)
        att = multi_head_attention(
            self.q_proj(h).reshape(shape4), self.k_proj(h).reshape(shape4),
            self.v_proj(h).reshape(shape4), causal=False,
            mask=pad_mask[:, None, None, :])
        att = self.o_proj(att.reshape(B, S, -1))
        x = x + F.dropout(att, cfg.dropout, training=train)
        h = _layer_norm(self.ln_mlp, x).to(cfg.dtype)
        h = self.fc_out(F.gelu(self.fc_in(h), approximate="tanh"))
        return x + F.dropout(h, cfg.dropout, training=train)


class BertEncoder(nn.Module):
    """tokens [B,S] int, attention_mask [B,S] (True = real token) ->
    logits [B, num_classes] fp32, from [CLS] pooling."""

    def __init__(self, cfg: BertConfig, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BertEncoder(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.tok_embedding = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.hidden_dim, device=device, dtype=cfg.param_dtype))
        self.pos_embedding = nn.Parameter(torch.empty(
            cfg.max_seq_len, cfg.hidden_dim, device=device, dtype=cfg.param_dtype))
        self.layers = nn.ModuleList(EncoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.ln_final = nn.LayerNorm(cfg.hidden_dim, eps=LN_EPS, device=device)
        # (EMBED, None), not (EMBED, EMBED): one spec must not name the same
        # mesh axis twice under fsdp strategies (maggy_tpu/models/bert.py:106).
        self.pooler = _Dense(cfg.hidden_dim, cfg.hidden_dim, cfg, device, (EMBED, None))
        self.classifier = _Dense(cfg.hidden_dim, cfg.num_classes, cfg, device, (EMBED, None))

    @property
    def identity(self):
        """The warm cache's model identity (``models/params.py``)."""
        return type(self), self.cfg

    def param_axes(self):
        return {"tok_embedding": (VOCAB, EMBED), "pos_embedding": (None, EMBED)}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The Flax initializers: normal(0.02) embeddings and dense kernels,
        zero biases, unit LayerNorm scales, drawn from ``generator``."""
        for name, p in init_targets(self, self.cfg.param_dtype):
            if name.endswith("embedding") or (name.endswith("weight") and p.ndim == 2):
                p.normal_(0.0, 0.02, generator=generator)
            elif ".ln" in name or name.startswith("ln"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.zero_()

    def forward(self, tokens, attention_mask=None, train: bool = False):
        cfg = self.cfg
        B, S = tokens.shape
        if attention_mask is None:
            attention_mask = torch.ones(B, S, dtype=torch.bool, device=tokens.device)
        x = sharded.vocab_parallel_embedding(tokens, self.tok_embedding, cfg.param_dtype) \
            .to(cfg.dtype) + sharded.gathered(self.pos_embedding)[:S].to(cfg.dtype)[None]
        for layer in self.layers:
            x = layer(x, attention_mask.bool(), train=train)
        x = _layer_norm(self.ln_final, x)
        pooled = torch.tanh(self.pooler(x[:, 0].to(cfg.dtype)))
        return self.classifier(pooled).float()


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax ``BertEncoder`` param tree (nested dicts of arrays, the
    ``params`` collection, unboxed) -> this module's ``state_dict``. Dense
    kernels [in,out] become Linear weights [out,in]; LayerNorm scale/bias
    become weight/bias; the embeddings are copied as they are."""
    out: Dict[str, torch.Tensor] = {}

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    for key, value in params.items():
        if key in ("tok_embedding", "pos_embedding"):
            out[key] = t(value)
            continue
        prefix = "layers.{}".format(key[len("layer_"):]) if key.startswith("layer_") else key
        modules = value.items() if key.startswith("layer_") else [(None, value)]
        for sub, leaves in modules:
            name = prefix if sub is None else "{}.{}".format(prefix, sub)
            if "kernel" in leaves:
                out[name + ".weight"] = t(leaves["kernel"]).T.contiguous()
                out[name + ".bias"] = t(leaves["bias"])
            else:
                out[name + ".weight"] = t(leaves["scale"])
                out[name + ".bias"] = t(leaves["bias"])
    return out
