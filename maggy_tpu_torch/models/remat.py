"""Per-layer rematerialization that runs under ``torch.func`` transforms.

A rematerialized layer keeps only its inputs for the backward, which runs
the layer's forward again (``nn.remat`` in ``maggy_tpu/models/llama.py:
247-250``). Two ways, one function:

- **Eager autograd** (the scalar ``Trainer``) keeps
  ``torch.utils.checkpoint(..., use_reentrant=False)``: it keeps the input
  through saved-tensor hooks and recomputes the layer inside the backward,
  and it gives the scalar path the numbers it always had.
- **Under ``torch.func``** (the vectorized lanes' ``vmap(grad(...))``,
  ``train/vmap.py``) saved-tensor hooks are refused, so ``remat_layer``
  calls ``_RematLayer``: an ``autograd.Function`` that takes the layer's
  parameters as explicit inputs, runs the layer without keeping its
  activations, and in its backward runs it again under ``torch.func.vjp``,
  differentiating only the inputs autograd asks for. A frozen parameter (a
  LoRA base shared by every lane, unbatched) stays a constant of that
  recompute: no gradient is computed for it, and no lane axis is added to
  it. Its batching rule is generated (``generate_vmap_rule``): the layer
  runs on the lanes' batched tensors, so the flash Functions inside it
  launch once for all lanes, in the forward and again in the recompute.

Either way the recompute re-enters the forward's batch-statistics group
(``variables.batch_stats_over``). Each loss the layer sows in its forward
leaves the Function as an output and is sowed again outside it, so its
gradient flows; the recompute sows nothing.
"""

from __future__ import annotations

import contextlib

import torch

from maggy_tpu_torch.models import variables


def under_transform() -> bool:
    """Whether a ``torch.func`` transform (grad, vjp, vmap) is active."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def _call(layer, names, params, args, group):
    """The layer on ``args`` with ``params`` as its parameters: (output,
    *the losses it sowed)."""
    with variables.sowing_losses() as sown, variables.batch_stats_over(group):
        out = torch.func.functional_call(layer, dict(zip(names, params)), args)
    return (out, *sown)


class _RematLayer(torch.autograd.Function):
    """``(layer, names, group, n_args, *args, *params)`` -> the layer's
    output and the losses it sowed; see the module docstring."""

    generate_vmap_rule = True

    @staticmethod
    def forward(layer, names, group, n_args, *tensors):
        return _call(layer, names, tensors[n_args:], tensors[:n_args], group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        layer, names, group, n_args = inputs[:4]
        ctx.save_for_backward(*inputs[4:])
        ctx.layer, ctx.names, ctx.group, ctx.n_args = layer, names, group, n_args

    @staticmethod
    def backward(ctx, *grads):
        tensors = list(ctx.saved_tensors)
        want = [i for i, w in enumerate(ctx.needs_input_grad[4:]) if w]
        n_args = ctx.n_args

        def recompute(*diff):
            full = list(tensors)
            for i, t in zip(want, diff):
                full[i] = t
            return _call(ctx.layer, ctx.names, full[n_args:], tuple(full[:n_args]), ctx.group)

        _, vjp_fn = torch.func.vjp(recompute, *(tensors[i] for i in want))
        # No graph of the recompute behind the gradients (the outer grad
        # transform runs this backward with grad mode on): each layer's
        # recomputed activations are freed before the next layer's.
        out = [None] * len(tensors)
        for i, g in zip(want, vjp_fn(grads, retain_graph=False, create_graph=False)):
            out[i] = g
        return (None, None, None, None, *out)


def remat_layer(layer: torch.nn.Module, *args, group=None):
    """``layer(*args)``, rematerialized in the backward (see the module
    docstring). ``group`` is the forward's batch-statistics group."""
    if not under_transform():
        from torch.utils.checkpoint import checkpoint

        # The recomputed forward runs where the backward runs (a device
        # thread on the card): it re-enters the forward's statistics group.
        return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              variables.batch_stats_over(group)))
    if next(layer.buffers(), None) is not None:
        raise ValueError("remat under torch.func takes a layer without buffers")
    names, params = zip(*layer.named_parameters())
    out, *sown = _RematLayer.apply(layer, names, group, len(args), *args, *params)
    for loss in sown:
        variables.sow_loss(loss)
    return out
