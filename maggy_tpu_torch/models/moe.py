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
[E, F, D]). Expert parallelism over an "expert" mesh axis is multi-device
and not ported (ROADMAP.md queue 1 item 8): every expert lives on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maggy_tpu_torch.models.params import check_device
from maggy_tpu_torch.models.variables import sow_loss


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
    combine = dispatch * gates[..., None]
    f = mask.mean((0, 1))
    p = probs.mean((0, 1))
    aux_loss = num_experts * (f * p).sum()
    return dispatch, combine, aux_loss


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
                 dtype=torch.bfloat16, param_dtype=torch.float32, device="cuda"):
        super().__init__()
        device = check_device(device)
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

    def forward(self, x):
        S = x.shape[1]
        E, dt = self.num_experts, self.compute_dtype
        # A single expert degenerates to top-1 routing.
        top_k = min(self.top_k, E)
        logits = x.float() @ self.router.float()  # [B,S,E]
        dispatch, combine, aux = routing_tensors(logits, E, self.capacity(S), top_k)
        sow_loss(self.aux_loss_weight * aux)
        dispatch, combine = dispatch.to(dt), combine.to(dt)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x.to(dt))
        gate = torch.einsum("ebcd,edf->ebcf", expert_in, self.gate_proj.to(dt))
        up = torch.einsum("ebcd,edf->ebcf", expert_in, self.up_proj.to(dt))
        expert_out = torch.einsum("ebcf,efd->ebcd", F.silu(gate) * up, self.down_proj.to(dt))
        return torch.einsum("bsec,ebcd->bsd", combine, expert_out)
