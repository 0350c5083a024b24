"""The Flax variable collections beside ``params``, in PyTorch's idiom.

- ``batch_stats``: a module's registered buffers (BatchNorm's running mean
  and variance). A forward with ``train=True`` updates them in place, which
  a captured step records, so each replay updates them once. Flax refuses
  to update a collection that ``apply`` was not told is mutable; the
  Trainer's ``has_aux_collections`` is that flag here (``mutable_buffers``),
  and outside a Trainer the buffers are mutable, as in PyTorch.
- ``losses``: a scalar a module adds to the objective (MoE's load-balancing
  loss), sowed with ``sow_loss`` into the list of the innermost
  ``sowing_losses`` block on this thread, and dropped outside one. The
  Trainer opens the block around its forward only, so a forward that
  rematerialization runs again in the backward sows nothing.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List

import torch

_local = threading.local()


@contextlib.contextmanager
def sowing_losses():
    """Collect every auxiliary loss sowed in the block, in forward order."""
    prev = getattr(_local, "losses", None)
    losses: List[torch.Tensor] = []
    _local.losses = losses
    try:
        yield losses
    finally:
        _local.losses = prev


def sow_loss(value: torch.Tensor) -> None:
    """Add ``value`` to the innermost ``sowing_losses`` block's list; a
    no-op outside one."""
    losses = getattr(_local, "losses", None)
    if losses is not None:
        losses.append(value)


@contextlib.contextmanager
def mutable_buffers(mutable: bool):
    """Within the block a forward may update its buffers only when
    ``mutable`` (Flax's ``mutable=["batch_stats"]``)."""
    prev = getattr(_local, "mutable", True)
    _local.mutable = bool(mutable)
    try:
        yield
    finally:
        _local.mutable = prev


def buffers_mutable() -> bool:
    return getattr(_local, "mutable", True)
