"""Train state: fp32 parameters, their fp32 EMA copy, the optimizer, the step
(``deco_tpu/train/state.py``).

The JAX package keeps params, EMA params and the optax state as one pytree
and updates them inside the jitted step; here the params are the model's
parameters and then those of the trainer's ``proj_module`` when it has one
(the REPA projection: the JAX combined ``{"model", "trainer"}`` layout),
:meth:`TrainState.named_parameters` names them (the trainer's under
``diffusion_trainer.``), ``ema_params`` is a list of tensors in that order, and
the optimizer ``torch.optim.AdamW`` with optax.adamw's defaults (betas
(0.9, 0.999), eps 1e-8, decoupled weight decay), which computes the same
update. The EMA and optimizer update tensors in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


TRAINER_PREFIX = "diffusion_trainer."


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[list]
    step: int = 0
    trainer_module: Optional[nn.Module] = None

    def named_parameters(self) -> list:
        """[(name, parameter)]: the model's, then the trainer module's under
        ``diffusion_trainer.``, the order of ``ema_params``."""
        named = list(self.model.named_parameters())
        if self.trainer_module is not None:
            named += [(TRAINER_PREFIX + n, p) for n, p in self.trainer_module.named_parameters()]
        return named

    def parameters(self) -> list:
        return [p for _, p in self.named_parameters()]

    def model_ema(self) -> list:
        """The EMA of the model's parameters alone, in ``model.parameters()`` order."""
        return self.ema_params[:len(list(self.model.parameters()))]

    @classmethod
    def create(cls, model: nn.Module, lr: float = 1e-4, weight_decay: float = 0.0,
               betas=(0.9, 0.999), eps: float = 1e-8, ema: bool = True,
               trainer_module: Optional[nn.Module] = None) -> "TrainState":
        """State over ``model``'s parameters and those of ``trainer_module``
        (a trainer's ``proj_module``), which must be fp32 (the master
        weights; the model computes in its own ``dtype``)."""
        state = cls(model=model, optimizer=None, ema_params=None, trainer_module=trainer_module)
        params = state.parameters()
        wrong = {p.dtype for p in params} - {torch.float32}
        if wrong:
            raise TypeError(f"TrainState: parameters must be float32 (param_dtype), got {wrong}")
        optimizer = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay)
        state.optimizer = optimizer
        state.ema_params = [p.detach().clone() for p in params] if ema else None
        return state


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
