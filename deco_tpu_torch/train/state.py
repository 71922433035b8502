"""Train state: fp32 parameters, their fp32 EMA copy, the optimizer, the step
(``deco_tpu/train/state.py``).

The JAX package keeps params, EMA params and the optax state as one pytree
and updates them inside the jitted step; here the model's parameters are the
params, ``ema_params`` a list of tensors in ``model.parameters()`` order, and
the optimizer ``torch.optim.AdamW`` with optax.adamw's defaults (betas
(0.9, 0.999), eps 1e-8, decoupled weight decay), which computes the same
update. The EMA and optimizer update tensors in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[list]
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, lr: float = 1e-4, weight_decay: float = 0.0,
               betas=(0.9, 0.999), eps: float = 1e-8, ema: bool = True) -> "TrainState":
        """State over ``model``'s parameters, which must be fp32 (the master
        weights; the model computes in its own ``dtype``)."""
        params = list(model.parameters())
        wrong = {p.dtype for p in params} - {torch.float32}
        if wrong:
            raise TypeError(f"TrainState: parameters must be float32 (param_dtype), got {wrong}")
        optimizer = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay)
        ema_params = [p.detach().clone() for p in params] if ema else None
        return cls(model=model, optimizer=optimizer, ema_params=ema_params)


@torch.no_grad()
def ema_update(ema_params, params, decay: float) -> None:
    """In place: e <- e * decay + p * (1 - decay)."""
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, [p.detach() for p in params], alpha=1.0 - decay)


def ema_decay_schedule(step: int, decay: float = 0.9999, min_decay: float = 0.0,
                       update_after_step: int = 0, update_every: int = 1,
                       use_ema_warmup: bool = False, inv_gamma: float = 1.0,
                       power: float = 2.0 / 3.0) -> float:
    """Warmup-decayed EMA factor of ``step`` (``deco_tpu`` ``ema_decay_schedule``).

    ``clamp(warmup(s), min_decay, decay)`` with ``warmup = 1 - (1 + s /
    inv_gamma) ** -power`` under ``use_ema_warmup``, else ``(1 + s) / (10 +
    s)``, where ``s = max(0, step - update_after_step - 1)``; 0 while s <= 0,
    and 1 (EMA unchanged) on steps off the ``update_every`` grid.
    """
    s = max(0, step - update_after_step - 1)
    warm = 1.0 - (1.0 + s / inv_gamma) ** -power if use_ema_warmup else (1.0 + s) / (10.0 + s)
    d = max(min(warm, decay), min_decay)
    if s <= 0:
        d = 0.0
    if update_every > 1 and (step - 1) % update_every != 0:
        d = 1.0
    return d
