"""Per-trial training harness: init + step, loss broadcast lazily.

Counterpart of ``maggy_tpu/train/trainer.py``'s `Trainer` for one device:
no mesh, no warm cache (``init`` notes its time in the trial's
telemetry scope) — a trial builds its model, optimizer and state
fresh. The step returns the loss as an un-synced 0-d tensor, which the
`Reporter` materializes on its heartbeat thread.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from maggy_tpu_torch.train import warm


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy in fp32 (``maggy_tpu`` `trainer.py:22-25`)."""
    return F.cross_entropy(logits.float(), labels.long())


class Trainer:
    """``Trainer(model, optimizer, loss_fn, device, train_kwargs)``:
    ``optimizer`` is a factory ``model -> (optimizer, lr_scheduler)`` such
    as ``train.optim.adamw(...)`` (every parameter) or
    ``train.lora.only_lora(adamw(...))`` (the adapters alone);
    ``loss_fn(outputs, batch)`` returns a scalar, where ``outputs`` is what
    the model returns (a tuple such as ``(hidden, head)`` included). The
    model is called as ``model(*batch["inputs"], **train_kwargs)`` (dropout
    off, as the JAX Trainer calls its model without ``train``)."""

    def __init__(self, model: torch.nn.Module, optimizer: Callable, loss_fn: Callable,
                 device="cuda", train_kwargs: Optional[Dict[str, Any]] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') needs a CUDA device; pass "
                               "device='cpu' to train on the CPU")
        self.model = model.to(self.device)
        self.optimizer_factory = optimizer
        self.loss_fn = loss_fn
        self.train_kwargs = dict(train_kwargs or {})
        self.optimizer = None
        self.scheduler = None

    def init(self, seed: Optional[int] = None,
             state_dict: Optional[Dict[str, torch.Tensor]] = None) -> "Trainer":
        """Fresh parameters — from ``state_dict`` when given, else the
        model's ``init_weights`` under a generator seeded with ``seed`` — and
        a fresh optimizer state. Inside a trial its host time is noted as
        the trial's ``init_ms`` (``maggy_tpu/train/trainer.py:512-518``);
        the model was built on the device before this call, so its
        construction falls into the trial's ``first_step_ms``."""
        t0 = time.perf_counter()
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0 if seed is None else int(seed))
            self.model.init_weights(gen)
        self.optimizer, self.scheduler = self.optimizer_factory(self.model)
        warm.note_compile(warm=False, init_ms=(time.perf_counter() - t0) * 1e3)
        return self

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """numpy/tensor leaves of ``batch`` -> tensors on the device."""
        def put(x):
            if isinstance(x, (tuple, list)):
                return type(x)(put(v) for v in x)
            t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
            return t.to(self.device, non_blocking=True)

        return {k: put(v) for k, v in batch.items()}

    def step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step; returns the loss (lazy 0-d tensor)."""
        loss = self.loss_fn(self.model(*batch["inputs"], **self.train_kwargs), batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return loss.detach()
