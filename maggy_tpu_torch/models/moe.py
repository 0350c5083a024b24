"""Mixture-of-experts MLP: top-k routing with a static expert capacity.

PyTorch counterpart of ``maggy_tpu/models/moe.py``. The router's top-k
experts per token, each token's position in its expert's buffer by a
cumulative sum, and dispatch and combine as dense one-hot einsums over
[B, S, E, C] tensors: no gather, no sort, no shape that depends on the
data, and no value read back to the host, so the layer runs inside a
captured CUDA graph. XLA computes these einsums outside any Pallas kernel
in the JAX package; ``torch.einsum`` is their counterpart here.

The load-balancing loss (``aux_loss_weight * E * sum_e f_e p_e``) is sowed
(``models/variables.py``), and the Trainer adds it to the objective.
Expert weights are stacked on a leading expert dim in Flax's layout
(``router`` [D, E], ``gate_proj``/``up_proj`` [E, D, F], ``down_proj``
[E, F, D]), with the logical axes of ``maggy_tpu/models/moe.py:100-110``.

Expert parallelism (a strategy with "ep" on a mesh with an "expert" axis):
the stacked expert dim is cut over "expert", so each of the n ranks holds
E / n experts, while tokens are cut only over the data-like axes: every
expert rank sees the same tokens (``maggy_tpu/parallel/sharding.py:
121-147``). The router (cut over "expert" too, as its logical axes say) is
gathered whole, so routing and the aux loss are the same on every rank;
each rank's experts take their slice of the dispatch, and the combine is
summed over "expert". The gradients entering the experts' region (the
tokens and the gates) are summed over "expert" in the backward. A
"model"-cut expert MLP dim is tensor-parallel within each expert.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.models.params import check_device
from maggy_tpu_torch.models.variables import sow_loss, stats_group
from maggy_tpu_torch.parallel import collectives, sharded

#: The experts' logical axis (mapped to the "expert" mesh axis under "ep").
EXPERT = "expert"


def _top_k_mask(probs, k: int):
    """[*, E] -> 0/1 mask of every entry >= the row's k-th largest: a tie
    at the threshold keeps more than k experts, as in the JAX package."""
    thresh = torch.topk(probs, k, dim=-1).values[..., -1:]
    return (probs >= thresh).to(probs.dtype)


def routing_tensors(router_logits, num_experts: int, capacity: int, top_k: int):
    """(dispatch [B,S,E,C] 0/1, combine [B,S,E,C], aux_loss), all fp32.

    A token's position in an expert's buffer counts the tokens routed to
    that expert before it in its batch row; a token past ``capacity`` is
    dropped (zero combine weight: the residual carries it through)."""
    dispatch, gates, aux_loss = routing(router_logits, num_experts, capacity, top_k)
    return dispatch, dispatch * gates[..., None], aux_loss


def routing(router_logits, num_experts: int, capacity: int, top_k: int, group=None):
    """``routing_tensors`` with the gates [B,S,E] in place of the combine
    (``dispatch * gates[..., None]``). With ``group`` (the mesh Trainer's
    data-like axes, ``variables.stats_group``) the load-balancing loss's
    routed fractions and mean probabilities are over every rank's tokens,
    as GSPMD computes them over the global batch."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    mask = _top_k_mask(probs, top_k)  # [B,S,E]
    pos = torch.cumsum(mask, dim=1) * mask - 1.0  # -1 where unrouted
    keep = (pos >= 0) & (pos < capacity)
    pos = pos.clamp(0, capacity - 1).long()
    slots = torch.arange(capacity, device=pos.device)
    dispatch = (pos[..., None] == slots).to(probs.dtype) * keep.to(probs.dtype)[..., None]
    gates = probs * mask
    # Kept gates renormalized, so each token's combine weights sum to ~1.
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    if group is None:
        f = mask.mean((0, 1))
        p = probs.mean((0, 1))
    else:
        E = num_experts
        count = torch.full((1,), float(mask.shape[0] * mask.shape[1]), device=mask.device)
        sums = collectives.sum_both_ways(
            torch.cat([mask.sum((0, 1)), probs.sum((0, 1)), count]), group, "moe_stats")
        f, p = sums[:E] / sums[-1], sums[E:2 * E] / sums[-1]
    aux_loss = num_experts * (f * p).sum()
    return dispatch, gates, aux_loss


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU MLP with E stacked experts: x [B, S, D] ->
    [B, S, D] in ``dtype``; router logits and routing in fp32. ``device``
    defaults to the card and raises without one unless it is "cpu"."""

    #: Parameters read in their own dtype, whatever the compute dtype: the
    #: router's logits are fp32. A cast of the frozen base
    #: (``train.lora.only_lora``) leaves them as they are.
    full_precision_params = ("router",)

    def __init__(self, hidden_dim: int, intermediate_dim: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 2.0, aux_loss_weight: float = 0.01,
                 dtype=torch.bfloat16, param_dtype=torch.float32, device="cuda",
                 embed_axis: str = "embed", mlp_axis: str = "mlp"):
        super().__init__()
        device = check_device(device)
        self.embed_axis, self.mlp_axis = embed_axis, mlp_axis
        E, D, M = num_experts, hidden_dim, intermediate_dim
        self.num_experts = E
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.compute_dtype = dtype

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=param_dtype, device=device))

        self.router = param(D, E)
        self.gate_proj = param(E, D, M)
        self.up_proj = param(E, D, M)
        self.down_proj = param(E, M, D)

    def capacity(self, seq_len: int) -> int:
        """Buffer slots per expert and batch row."""
        top_k = min(self.top_k, self.num_experts)
        return max(1, int(self.capacity_factor * seq_len * top_k / self.num_experts))

    def param_axes(self):
        embed, mlp = self.embed_axis, self.mlp_axis
        return {"router": (embed, EXPERT), "gate_proj": (EXPERT, embed, mlp),
                "up_proj": (EXPERT, embed, mlp), "down_proj": (EXPERT, mlp, embed)}

    def forward(self, x):
        S = x.shape[1]
        E, dt = self.num_experts, self.compute_dtype
        # A single expert degenerates to top-1 routing.
        top_k = min(self.top_k, E)
        router = sharded.whole(self.router, 1, axis="expert", kind="ep")
        logits = x.float() @ router.float()  # [B,S,E]
        dispatch, gates, aux = routing(logits, E, self.capacity(S), top_k, stats_group())
        sow_loss(self.aux_loss_weight * aux)
        w_gate, w_up, w_down = (sharded.gathered(w).to(dt)
                                for w in (self.gate_proj, self.up_proj, self.down_proj))
        ep = sharded.group_of(self.gate_proj, 0, "expert")
        if ep is not None:
            # This rank's experts: their slice of the dispatch and the gates.
            start, n = sharded.local_range(self.gate_proj, 0)
            gates = collectives.copy_to_region(gates, ep, "ep")[:, :, start:start + n]
            dispatch = dispatch[:, :, start:start + n]
            x = collectives.copy_to_region(x, ep, "ep")
        combine = (dispatch * gates[..., None]).to(dt)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x.to(dt))
        tp = sharded.group_of(self.gate_proj, 2, "model")
        if tp is not None:
            expert_in = collectives.copy_to_region(expert_in, tp, "tp")
        gate = torch.einsum("ebcd,edf->ebcf", expert_in, w_gate)
        up = torch.einsum("ebcd,edf->ebcf", expert_in, w_up)
        expert_out = torch.einsum("ebcf,efd->ebcd", F.silu(gate) * up, w_down)
        if tp is not None:
            expert_out = collectives.reduce_from_region(expert_out, tp, "tp")
        out = torch.einsum("bsec,ebcd->bsd", combine, expert_out)
        return out if ep is None else collectives.reduce_from_region(out, ep, "ep")
