"""What the warm path (``train/warm.py``) needs of every model.

A model is identified by ``(type, frozen config)`` (its ``identity``
property), which keys its warm slot; a module without one gets a private
slot. A model can be built on ``device="meta"`` (a description with no
storage, the counterpart of a Flax module), and its ``init_weights`` draws
through ``init_targets``, so a retired unit's parameters are re-initialized
in place with the values a fresh build would draw.
"""

from __future__ import annotations

import torch


def init_targets(module: torch.nn.Module, dtype: torch.dtype):
    """Yield ``(name, tensor)`` for each parameter, in ``named_parameters``
    order, for an initializer to fill in place. A parameter held in another
    dtype than ``dtype`` (``train.lora.only_lora`` casts the frozen base to
    the compute dtype) is drawn into a ``dtype`` tensor of its shape and
    then copied in: the draws, and the rounding of the cast, are those of a
    fresh model initialized in ``dtype`` and then cast."""
    for name, p in module.named_parameters():
        if p.dtype == dtype:
            yield name, p
            continue
        tmp = torch.empty(p.shape, dtype=dtype, device=p.device)
        yield name, tmp
        with torch.no_grad():
            p.copy_(tmp)
