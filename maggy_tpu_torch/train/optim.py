"""The optax pieces the BERT and MNIST sweeps use, as torch optimizers.

``adam`` is ``optax.adam`` (eps 1e-8 added after the square root, eps_root
0): ``adamw`` with no weight decay computes the same update. ``adamw`` matches ``optax.adamw``'s defaults (b1 0.9, b2 0.999, eps 1e-8,
weight decay 1e-4 on every parameter — torch's own AdamW default decay is
1e-2). ``sgd`` is ``optax.sgd`` (examples/distributed_training.py's optimizer).
``warmup_cosine_decay_schedule`` is optax's schedule (step ->
learning rate); ``adamw`` drives torch.optim.AdamW with a base rate of 1 and
a LambdaLR whose factor at step t is that schedule's value, so update t
uses schedule(t) exactly as optax's step counter does.

A factory's builder also carries ``scheduler`` (optimizer -> this
builder's LambdaLR over it), ``schedule`` (step -> learning rate) and
``kwargs`` (its AdamW arguments), which the warm path (``train/warm.py``)
reads to hand a retired optimizer to the next trial and the vectorized
lanes (``train/vmap.py``) read to drive one AdamW param group a lane. ``swept_transform`` is the counterpart of
``maggy_tpu/train/trainer.py:354-405``: see its docstring for which
hyperparameters ride tensors and which are baked into the family.
"""

from __future__ import annotations

import math
import numbers
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
    kwargs = dict(betas=(b1, b2), eps=eps, weight_decay=weight_decay)

    def build(params):
        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        opt = torch.optim.AdamW(params, lr=1.0, **kwargs)
        return opt, build.scheduler(opt)

    build.scheduler = lambda opt: torch.optim.lr_scheduler.LambdaLR(opt, schedule)
    build.schedule = schedule
    build.kwargs = kwargs
    return build


def adam(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """``optax.adam``'s update as an optimizer factory (see ``adamw``)."""
    return adamw(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def sgd(learning_rate: Union[float, Schedule], momentum: float = 0.0, nesterov: bool = False):
    """``optax.sgd``'s update as an optimizer factory (see ``adamw``):
    torch.optim.SGD without dampening keeps optax's trace, m <- g + mu m
    (m starts at 0, so the first step's m is g), and steps p <- p - lr m,
    or p <- p - lr (g + mu m) with ``nesterov``. At momentum 0 the trace is
    g, Nesterov's included (torch refuses the flag there, so it is
    dropped)."""
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
    kwargs = dict(momentum=momentum, nesterov=bool(nesterov) and momentum > 0)

    def build(params):
        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        opt = torch.optim.SGD(params, lr=1.0, **kwargs)
        return opt, build.scheduler(opt)

    build.scheduler = lambda opt: torch.optim.lr_scheduler.LambdaLR(opt, schedule)
    build.schedule = schedule
    build.kwargs = kwargs
    return build


#: The hyperparameter that rides the optimizer's learning-rate tensor.
SWEPT_TENSOR_HPARAMS = ("learning_rate",)


def _repr_stable(v) -> bool:
    """Whether ``v``'s repr is determined by its value (a schedule's or a
    callable's carries a memory address)."""
    if v is None or isinstance(v, (str, bytes, bool, numbers.Number)):
        return True
    if isinstance(v, (tuple, list)):
        return all(_repr_stable(x) for x in v)
    return False


def swept_transform(factory: Callable, **hparams):
    """``factory(**hparams)`` (``adam``, ``adamw`` or a factory of the same
    shape) marked as one member of a program family, so trials that differ
    only in the swept values share one warm slot: one materialized module,
    one optimizer and one set of captured step graphs (``train/warm.py``).
    The counterpart of ``maggy_tpu/train/trainer.py:354-405``.

    The family is the factory's qualified name, the NAMES of the numeric
    hyperparameters and the reprs of the other (static) ones; a static
    whose repr is not value-determined (a schedule, a callable) leaves the
    factory family-less (a private slot: it captures its own graphs and
    shares nothing). Which values ride tensors: ``learning_rate`` lives in
    a 0-d tensor in the optimizer's param group (on the card, with
    ``capturable=True``), which a later trial of the family overwrites
    through its own LambdaLR; torch.optim.AdamW takes ``betas``, ``eps``
    and ``weight_decay`` as Python floats, which a captured graph bakes in,
    so their VALUES join the family (two trials that differ in them do not
    share a slot). A factory without a ``scheduler`` attribute bakes every
    value. A factory whose builders are ``only_lora`` wrappers has the
    family ``("only_lora", family)``."""
    build = factory(**hparams)
    numeric = {k: v for k, v in hparams.items()
               if isinstance(v, numbers.Real) and not isinstance(v, bool)}
    statics = {k: v for k, v in hparams.items() if k not in numeric}
    if all(_repr_stable(v) for v in statics.values()):
        tensors = set(SWEPT_TENSOR_HPARAMS) if hasattr(build, "scheduler") else set()
        baked = tuple(sorted((k, repr(v)) for k, v in numeric.items() if k not in tensors))
        family = ("{}.{}".format(getattr(factory, "__module__", "?"),
                                 getattr(factory, "__qualname__", repr(factory))),
                  tuple(sorted(numeric)), tuple(sorted((k, repr(v)) for k, v in statics.items())),
                  baked)
        if getattr(build, "freeze", None) is not None:
            # An only_lora builder (train/lora.py): another program than
            # the factory's own builders, whose lanes stack every parameter.
            family = ("only_lora", family)
    else:
        family, tensors = None, set()
    build._maggy_swept = {"family": family,
                          "hparams": {k: v for k, v in numeric.items() if k in tensors}}
    return build
