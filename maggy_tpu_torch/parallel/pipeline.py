"""Pipeline parallelism: GPipe and 1F1B microbatching over a "pipe" mesh axis.

Counterpart of ``maggy_tpu/parallel/pipeline.py:33-367``, with its names and
schedules. JAX runs one program on every device under ``shard_map``, the
stacked stage dim of the layer parameters sharded over "pipe"; here one
rank process holds one stage (``stage_param_sharding``: the stage of this
rank is its "pipe" coordinate), and the same program is every rank's:

- every rank runs every tick of the schedule, as under ``shard_map``, and
  one activation slot circulates by ``collectives.ppermute`` once a tick
  (through host memory on gloo, ``collectives.ring_shift``);
- ``pipeline_apply`` (GPipe): M + n - 1 ticks, stage 0 ingesting
  microbatch t, stage n-1 emitting microbatch t - (n-1); the last stage's
  outputs are summed over "pipe" (``maggy_tpu/parallel/pipeline.py:83-84``)
  so every rank holds them. Autograd gives the backward pipeline: each hop's
  backward sends the gradient back the other way, and since every rank
  keeps each received slot in its graph (stage 0 with a zero gradient), the
  reverse hops meet in the same order on every rank;
- ``pipeline_1f1b_grads`` (PipeDream-flush): the JAX package's slot
  formulas ``F_m(i)``, ``B_m(i)``, its [n, ...] stash doubling as the
  backward's recompute store, the loss inside the pipeline, one hop each
  way a slot. The schedule is known on the host, so a rank skips the
  compute of an inactive sub-step (the JAX program computes it and masks
  it), and still makes every exchange;
- a "data" (or "fsdp") axis beside "pipe" splits each microbatch's rows
  (``:88-97``): each rank pipelines its rows, and 1F1B averages the loss
  and gradients over the data-like axes (``:260-266``).

``PipelinedLM`` is the JAX package's functional decoder (embedding ->
pipelined residual SwiGLU blocks -> head) as an ``nn.Module`` holding the
stages it is given (all of them for ``apply_sequential``, the rank's one for
``apply``); ``pipelined_lm_state`` carries a JAX param tree across.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.parallel import collectives
from maggy_tpu_torch.parallel.sharding import DATA_AXES


def _microbatches(x: torch.Tensor, M: int) -> torch.Tensor:
    B = x.shape[0]
    if B % M:
        raise ValueError("Batch {} must divide into {} microbatches".format(B, M))
    return x.reshape((M, B // M) + tuple(x.shape[1:]))


def _data_rows(x_mb: torch.Tensor, env) -> torch.Tensor:
    """This rank's rows of every microbatch [M, mb, ...] over the mesh's
    data-like axes; all the rows when they do not divide (JAX's ``P()``)."""
    axes = tuple(a for a in DATA_AXES if a in env.axis_names)
    dp = math.prod(env.axis_size(a) for a in axes)
    if dp == 1 or x_mb.shape[1] % dp:
        return x_mb
    index, _ = env._coordinate(axes)
    rows = x_mb.shape[1] // dp
    return x_mb[:, index * rows:(index + 1) * rows]


def _data_group(env):
    return env.group(*(a for a in DATA_AXES if a in env.axis_names))


def stage_param_sharding(env, axis: str = "pipe") -> int:
    """The stage this rank holds: its coordinate on ``axis``."""
    return env.axis_index(axis)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, env,
                   axis: str = "pipe", num_microbatches: Optional[int] = None) -> torch.Tensor:
    """Run ``x`` through the n = ``env.axis_size(axis)`` pipeline stages.

    stage_fn(params, act) -> act: one stage's compute; must preserve the
        activation's shape and dtype (residual-block style).
    stage_params: this rank's stage (``stage_param_sharding``'s index of
        stacked [n, ...] leaves).
    x: [B, ...] global batch, the same on every rank; B must divide into
        ``num_microbatches`` (default n) equal microbatches.

    Returns the pipeline's output for this rank's rows, on every rank of
    ``axis``: [B, ...] without a data-like axis, else the rank's rows of
    each microbatch, microbatch by microbatch ([M * mb / dp, ...])."""
    n, idx, group = env.axis_size(axis), env.axis_index(axis), env.group(axis)
    M = int(num_microbatches or n)
    x_mb = _data_rows(_microbatches(x, M), env)
    if group is not None:
        # x is replicated over the stages: its gradient is the stages' sum.
        x_mb = collectives.copy_to_region(x_mb, group, "pipe")
    first = torch.tensor(idx == 0, device=x.device)
    state = torch.zeros_like(x_mb[0])
    emits = []
    for t in range(M + n - 1):
        state = torch.where(first, x_mb[min(t, M - 1)], state)
        out = stage_fn(stage_params, state)
        emits.append(out)
        if group is not None and t < M + n - 2:
            # Forward one stage a tick; stage n-1 -> 0 wraps but is
            # overwritten by fresh input.
            state = collectives.ppermute(out, group, 1, "pipe")
    # On the last stage, microbatch m leaves the pipe at tick m + n - 1.
    y = torch.stack(emits[n - 1:])
    if group is not None:
        y = torch.where(torch.tensor(idx == n - 1, device=y.device), y, torch.zeros_like(y))
        y = collectives.reduce_from_region(y, group, "pipe")
    return y.reshape((-1,) + tuple(y.shape[2:]))


def pipeline_1f1b_grads(stage_fn: Callable, loss_fn: Callable, stage_params, x: torch.Tensor,
                        targets: torch.Tensor, env, axis: str = "pipe",
                        num_microbatches: Optional[int] = None):
    """One-forward-one-backward (PipeDream-flush) pipelined training step:
    returns ``(mean_loss, stage_param_grads)`` for this rank's stage, the
    loss the same on every rank (``maggy_tpu/parallel/pipeline.py:106-
    282``).

    Schedule (0-based stage i, microbatch m, n stages, M microbatches, one
    slot = one F and one B sub-step, T = 2(M+n-1) slots):

    - warmup forwards (m < n - i):  F_m(i) = i + m
    - steady forwards  (m >= n-i):  F_m(i) = 2m + i
    - backwards:                    B_m(i) = 2n - 1 - i + 2m

    Arrivals are stashed into the [n, ...] ring keyed by microbatch mod n,
    which the backward reads again to recompute the stage's forward.

    stage_fn(params, act) -> act          (shape-preserving, as GPipe)
    loss_fn(act, target) -> scalar        (per microbatch, on the last
                                           stage's output)
    targets: [B, ...] aligned with x's batch dim."""
    n, idx, group = env.axis_size(axis), env.axis_index(axis), env.group(axis)
    M = int(num_microbatches or n)
    x_mb = _data_rows(_microbatches(x, M), env)
    t_mb = _data_rows(_microbatches(targets, M), env)
    T = 2 * (M + n - 1)
    names = list(stage_params)
    params = [stage_params[k].detach() for k in names]

    def fwd_mb(t, i):
        """(active, m) of stage i's F sub-step at slot t."""
        d = t - i
        warm = i <= t < n and d < M
        m_steady = d // 2
        steady = d >= 0 and d % 2 == 0 and n - i <= m_steady < M
        return warm or steady, min(max(d if warm else m_steady, 0), M - 1)

    def bwd_mb(t):
        r = t - (2 * n - 1 - idx)
        return r >= 0 and r % 2 == 0 and r // 2 < M, min(max(r // 2, 0), M - 1)

    zeros = torch.zeros_like(x_mb[0])
    stash = [zeros] * n
    act_in, grad_in, dy_pending = zeros, zeros, zeros
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    gacc = [torch.zeros_like(p) for p in params]
    is_last = idx == n - 1
    for t in range(T):
        # The activation that just arrived, sent by stage idx-1 at slot t-1.
        in_active, m_in = fwd_mb(t - 1, idx - 1)
        if in_active and idx > 0:
            stash[m_in % n] = act_in
        f_active, m_f = fwd_mb(t, idx)
        out, dy_next = zeros, dy_pending
        if f_active:
            inp = x_mb[m_f] if idx == 0 else stash[m_f % n]
            if idx == 0:
                stash[m_f % n] = inp
            with torch.no_grad():
                out = stage_fn(dict(zip(names, params)), inp)
            if is_last:
                # The loss and its output cotangent, consumed by this
                # stage's own backward next slot (B_m = F_m + 1 here).
                leaf = out.detach().requires_grad_()
                with torch.enable_grad():
                    loss = loss_fn(leaf, t_mb[m_f])
                    dy_next, = torch.autograd.grad(loss, leaf)
                loss_sum = loss_sum + loss.detach().float()
        dx = zeros
        b_active, m_b = bwd_mb(t)
        if b_active:
            inp_b = stash[m_b % n].detach().requires_grad_()
            ps = [p.requires_grad_() for p in (q.detach() for q in params)]
            with torch.enable_grad():
                o = stage_fn(dict(zip(names, ps)), inp_b)
                *dps, dx = torch.autograd.grad(o, ps + [inp_b], dy_pending if is_last else grad_in)
            gacc = [a + d for a, d in zip(gacc, dps)]
        if group is not None:
            act_in = collectives.ring_shift([out], group, -1, kind="pipe_hop")[0]
            grad_in = collectives.ring_shift([dx], group, 1, kind="pipe_hop_reverse")[0]
        dy_pending = dy_next
    loss = loss_sum.reshape(1)
    if group is not None:
        # Only the last stage accumulated loss; share it around the ring.
        collectives.all_reduce_(loss, group, kind="pipe_loss_all_reduce")
    loss = loss / M
    data = _data_group(env)
    if data is not None:
        dp = torch.distributed.get_world_size(data)
        collectives.all_reduce_(loss, data, kind="loss_all_reduce")
        loss = loss / dp
        for g in gacc:
            collectives.all_reduce_(g, data, kind="grad_all_reduce")
            g /= dp
    # Mean of the microbatch means.
    return loss[0], {k: g / M for k, g in zip(names, gacc)}


class _SharedCast(torch.autograd.Function):
    """``w`` read as ``low``, its copy in the compute dtype made once for
    every tick: the products of all ticks keep that one copy for their
    backward (a cast a tick would keep one each), and each use still adds
    its gradient to ``w`` in ``w``'s dtype, as the transpose of JAX's cast
    inside the stage does."""

    @staticmethod
    def forward(ctx, w, low):
        ctx.dtype = w.dtype
        return low.view_as(low)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


#: The stacked stage parameters of a ``PipelinedLM``.
STAGE_LEAVES = ("w_gate", "w_up", "w_down")


class PipelinedLM(nn.Module):
    """Minimal decoder for the pipeline path (``maggy_tpu/parallel/
    pipeline.py:294-367``): embedding [V, D] -> ``num_stages`` stages of
    ``layers_per_stage`` residual SwiGLU blocks -> head [D, V], fp32
    parameters and ``dtype`` compute. The module holds the stages named by
    ``stages`` (default: all): ``w_gate`` / ``w_up`` [s, L, D, F] and
    ``w_down`` [s, L, F, D] for s stages held, in the JAX layout."""

    def __init__(self, vocab_size: int, hidden_dim: int, intermediate_dim: int,
                 num_stages: int, layers_per_stage: int = 1, dtype=torch.bfloat16,
                 stages: Optional[Sequence[int]] = None, device="cuda"):
        super().__init__()
        from maggy_tpu_torch.models.params import check_device

        device = check_device(device)
        self.vocab_size, self.hidden_dim = vocab_size, hidden_dim
        self.intermediate_dim, self.num_stages = intermediate_dim, num_stages
        self.layers_per_stage, self.dtype = layers_per_stage, dtype
        self.stages = tuple(range(num_stages) if stages is None else stages)
        V, D, Fd, L, s = vocab_size, hidden_dim, intermediate_dim, layers_per_stage, \
            len(self.stages)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=torch.float32, device=device))

        self.embed = param(V, D)
        self.w_gate = param(s, L, D, Fd)
        self.w_up = param(s, L, D, Fd)
        self.w_down = param(s, L, Fd, D)
        self.head = param(D, V)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX initializers' distributions: normal(0.02) embedding and
        head, stage kernels normal with std 1/sqrt(fan_in), drawn for every
        stage (so a rank's stage holds the values a whole model's has)."""
        D, Fd = self.hidden_dim, self.intermediate_dim
        self.embed.normal_(0.0, 0.02, generator=generator)
        for name, std in (("w_gate", D ** -0.5), ("w_up", D ** -0.5), ("w_down", Fd ** -0.5)):
            p = getattr(self, name)
            for i in range(self.num_stages):
                block = torch.empty(p.shape[1:], device=p.device).normal_(
                    0.0, std, generator=generator)
                if i in self.stages:
                    p[self.stages.index(i)].copy_(block)
        self.head.normal_(0.0, 0.02, generator=generator)

    def stage_params(self, stage: int) -> Dict[str, torch.Tensor]:
        """Stage ``stage``'s parameters [L, ...] (a stage this module holds)."""
        j = self.stages.index(stage)
        return {k: getattr(self, k)[j] for k in STAGE_LEAVES}

    def stage_fn(self, stage_params, x):
        """L residual SwiGLU blocks; [mb, S, D] -> [mb, S, D]."""
        dt = self.dtype
        for li in range(stage_params["w_gate"].shape[0]):
            h = x @ stage_params["w_gate"][li].to(dt)
            u = x @ stage_params["w_up"][li].to(dt)
            x = x + (F.silu(h) * u) @ stage_params["w_down"][li].to(dt)
        return x

    def apply(self, tokens, env, axis: str = "pipe", num_microbatches: Optional[int] = None,
              return_hidden: bool = False):
        """The pipelined forward on this rank's stage: fp32 logits of the
        rank's rows (``pipeline_apply``), or with ``return_hidden`` the
        pipeline's output and the head for a chunked loss."""
        x = self.embed.to(self.dtype)[tokens]
        params = self.stage_params(stage_param_sharding(env, axis))
        low = {k: v.detach().to(self.dtype) for k, v in params.items()}

        def stage_fn(p, a):
            return self.stage_fn({k: _SharedCast.apply(w, low[k]) for k, w in p.items()}, a)

        x = pipeline_apply(stage_fn, params, x, env, axis=axis,
                           num_microbatches=num_microbatches)
        if return_hidden:
            return x, self.head
        return (x @ self.head.to(self.dtype)).float()

    def apply_sequential(self, tokens, return_hidden: bool = False):
        """Reference forward with no pipelining (every stage held)."""
        x = self.embed.to(self.dtype)[tokens]
        for i in range(self.num_stages):
            x = self.stage_fn(self.stage_params(i), x)
        if return_hidden:
            return x, self.head
        return (x @ self.head.to(self.dtype)).float()


def pipelined_lm_state(params, stages: Optional[Sequence[int]] = None):
    """A JAX ``PipelinedLM`` param tree (a plain dict of arrays: "embed",
    "stages" {"w_gate", "w_up", "w_down"} stacked [n, ...], "head") -> a
    ``PipelinedLM`` state dict holding ``stages`` (default: all)."""
    import numpy as np

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {"embed": t(params["embed"]), "head": t(params["head"])}
    for k in STAGE_LEAVES:
        stacked = t(params["stages"][k])
        out[k] = stacked if stages is None else stacked[list(stages)].contiguous()
    return out
