"""The optax pieces the BERT sweep uses, as torch optimizers.

``adamw`` matches ``optax.adamw``'s defaults (b1 0.9, b2 0.999, eps 1e-8,
weight decay 1e-4 on every parameter — torch's own AdamW default decay is
1e-2). ``warmup_cosine_decay_schedule`` is optax's schedule (step ->
learning rate); ``adamw`` drives torch.optim.AdamW with a base rate of 1 and
a LambdaLR whose factor at step t is that schedule's value, so update t
uses schedule(t) exactly as optax's step counter does.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at ``decay_steps``
    (which includes the warmup) — optax's definition, edge cases included:
    a non-positive warmup is a constant ``init_value`` before the boundary."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("The cosine decay needs decay_steps > warmup_steps, got "
                         "decay_steps={}, warmup_steps={}".format(decay_steps, warmup_steps))
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """An optimizer factory: ``params -> (torch.optim.AdamW, LambdaLR)``,
    where ``params`` is a module (all its parameters) or an iterable of
    parameters."""
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def build(params):
        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        opt = torch.optim.AdamW(params, lr=1.0, betas=(b1, b2), eps=eps,
                                weight_decay=weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)

    return build
