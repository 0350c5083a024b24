"""LoRA training: freeze the base model, train only the adapters.

Counterpart of ``maggy_tpu/train/lora.py``. The Llama LoRA sweep trains
only the low-rank ``lora_a``/``lora_b`` matrices of
``models.llama.LoRADense``; every other parameter is frozen, gets no
gradient and no optimizer state. The JAX package masks its optimizer
(``optax.masked``); here the optimizer is simply built over the adapters.
"""

from __future__ import annotations

from typing import Callable

import torch

LORA_LEAVES = ("lora_a", "lora_b")


def is_lora_param(name: str) -> bool:
    """True for a ``named_parameters()`` name whose leaf is an adapter."""
    return name.rsplit(".", 1)[-1] in LORA_LEAVES


def lora_adapter_count(model: torch.nn.Module) -> int:
    """Number of trainable (adapter) parameters in ``model``."""
    return sum(p.numel() for name, p in model.named_parameters() if is_lora_param(name))


def only_lora(factory: Callable) -> Callable:
    """Wrap an optimizer factory (``train.optim.adamw(lr)``) so it optimizes
    ONLY the LoRA adapters: ``only_lora(adamw(lr))(model)`` builds the
    optimizer over the ``lora_a``/``lora_b`` parameters alone.

    Before that it freezes every other parameter (``requires_grad_(False)``)
    and casts it IN PLACE to the model's compute dtype (``model.cfg.dtype``).
    The model reads each of those parameters only after casting it to that
    dtype, and a frozen parameter is never updated, so the cast changes
    neither the function nor the adapters' gradients; it halves the base
    model's memory (an 8.03B-parameter base: 16.06 GB in bf16 instead of
    32.1 GB in fp32). The adapters stay in ``param_dtype``."""

    def build(model: torch.nn.Module):
        dtype = model.cfg.dtype
        adapters = []
        with torch.no_grad():
            for name, p in model.named_parameters():
                if is_lora_param(name):
                    adapters.append(p)
                    continue
                p.requires_grad_(False)
                p.data = p.data.to(dtype)
        return factory(adapters)

    return build
