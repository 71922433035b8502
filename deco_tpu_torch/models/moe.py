"""Mixture-of-experts SwiGLU MLP, GShard style with a fixed capacity
(``deco_tpu/models/moe.py``).

- Fixed per-(batch row, expert) capacity: tokens past it are dropped (their
  MLP output is zero; the residual carries them).
- Dispatch and combine as (S, E, C) one-hot tensors, so routing is two
  products, not gathers.
- k-major slot order: every first choice of a row claims its slot before
  any second choice, in token order within a choice; the expert-parallel
  executor (``parallel/ep_moe.py``) reproduces it shard by shard.

The router runs in fp32. The parameters keep the JAX layout: ``router``
(d, E), ``w1`` and ``w3`` (E, d, m), ``w2`` (E, m, d);
``convert.moe_state_dict_from_jax`` carries a JAX tree across.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def topk_masks(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """(K, ..., E) one-hot masks, the k-th slice each token's k-th choice;
    ties go to the lowest index (argmax's first maximum)."""
    masks, p = [], probs
    for _ in range(top_k):
        m = F.one_hot(torch.argmax(p, dim=-1), probs.shape[-1]).to(probs.dtype)
        masks.append(m)
        p = p * (1.0 - m) - m  # never picked again
    return torch.stack(masks, dim=0)


def dispatch_tensors(probs: torch.Tensor, top_k: int, capacity: int,
                     position_offset: Optional[torch.Tensor] = None):
    """(dispatch, combine, aux) of one batch row's (S, E) fp32 router
    probabilities: dispatch (S, E, C) in {0, 1}, combine = dispatch times the
    gate renormalised over the K choices, aux = E * sum_e(first-choice
    fraction_e * mean probability_e). ``position_offset`` (K, E): the first
    slot of each (choice, expert), which the expert-parallel executor sets
    to the slots earlier shards claimed."""
    s, e = probs.shape
    masks = topk_masks(probs, top_k)  # (K, S, E)
    gates = (masks * probs[None]).sum(-1)  # (K, S)
    gates = gates / torch.clamp(gates.sum(0, keepdim=True), min=1e-9)
    flat = masks.reshape(top_k * s, e)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(top_k, s, e)  # exclusive, k-major
    if position_offset is not None:
        pos = pos + position_offset[:, None, :]
    slot = (pos * masks).sum(-1).to(torch.long)  # (K, S)
    keep = (slot < capacity) & (masks.sum(-1) > 0)
    oh = F.one_hot(slot.clamp(max=capacity - 1), capacity).to(probs.dtype)
    disp_k = masks[..., None] * oh[:, :, None, :] * keep[..., None, None].to(probs.dtype)
    dispatch = disp_k.sum(0)
    combine = (disp_k * gates[..., None, None]).sum(0)
    aux = e * (masks[0].mean(0) * probs.mean(0)).sum()
    return dispatch, combine, aux


def expert_swiglu(p: dict, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Each expert's SwiGLU on its slots: x (E, C, d) with w1/w3 (E, d, m)
    and w2 (E, m, d)."""
    xd = x.to(dtype)
    a = torch.einsum("ecd,edm->ecm", xd, p["w1"].to(dtype))
    b = torch.einsum("ecd,edm->ecm", xd, p["w3"].to(dtype))
    return torch.einsum("ecm,emd->ecd", F.silu(a) * b, p["w2"].to(dtype))


def capacity_of(seq_len: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots per (batch row, expert): ceil(cf * S * K / E)."""
    return int(-(-capacity_factor * seq_len * top_k // num_experts))


class MoEMLP(nn.Module):
    """Drop-in MoE for the dense SwiGLU MLP (``MoEMLP``): ``num_experts``
    experts of width ``mlp_dim``, ``top_k`` choices a token, capacity
    ``ceil(capacity_factor * S * top_k / E)`` a row. ``forward`` returns
    the output in x's dtype and keeps the load-balance loss, the mean over
    rows, in ``aux_loss`` (JAX sows it under ``("aux_loss", "moe")``).
    Parameters are fp32, drawn normal / sqrt(fan in)."""

    def __init__(self, dim: int, num_experts: int, mlp_dim: int, top_k: int = 2,
                 capacity_factor: float = 1.25, dtype=torch.bfloat16, device="cpu"):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        kw = dict(dtype=torch.float32, device=device)
        self.router = nn.Parameter(torch.randn(dim, num_experts, **kw) / math.sqrt(dim))
        self.w1 = nn.Parameter(torch.randn(num_experts, dim, mlp_dim, **kw) / math.sqrt(dim))
        self.w3 = nn.Parameter(torch.randn(num_experts, dim, mlp_dim, **kw) / math.sqrt(dim))
        self.w2 = nn.Parameter(torch.randn(num_experts, mlp_dim, dim, **kw) / math.sqrt(mlp_dim))
        self.aux_loss = None

    def params(self) -> dict:
        return {"router": self.router, "w1": self.w1, "w3": self.w3, "w2": self.w2}

    def forward(self, x):
        b, s, _ = x.shape
        cap = capacity_of(s, self.num_experts, self.top_k, self.capacity_factor)
        probs = torch.softmax(x.float() @ self.router, dim=-1)  # (B, S, E)
        ys, auxes = [], []
        for pr, xr in zip(probs, x):
            dispatch, combine, aux = dispatch_tensors(pr, self.top_k, cap)
            slots = torch.einsum("sec,sd->ecd", dispatch.to(self.dtype), xr.to(self.dtype))
            out = expert_swiglu(self.params(), slots, self.dtype)
            ys.append(torch.einsum("sec,ecd->sd", combine.to(self.dtype), out))
            auxes.append(aux)
        self.aux_loss = torch.stack(auxes).mean()
        return torch.stack(ys).to(x.dtype)
