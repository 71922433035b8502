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
update, or :class:`Adafactor` (``optax.adafactor``). The EMA and optimizer
update tensors in place. A model with int8 trunk modules
(``quantize="int8"``, ``DECO_QUANT=int8``) is refused: that mode serves, it
does not train.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
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
    # what the train step runs: the model under DDP on a mesh, else None
    # (the model itself)
    net: Optional[nn.Module] = None

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
               trainer_module: Optional[nn.Module] = None,
               optimizer: Optional[Callable] = None) -> "TrainState":
        """State over ``model``'s parameters and those of ``trainer_module``
        (a trainer's ``proj_module``), which must be fp32 (the master
        weights; the model computes in its own ``dtype``). ``optimizer``
        (parameters -> optimizer) replaces AdamW and its settings."""
        from deco_tpu_torch.ops.quant import quant_modules

        if quant_modules(model):
            raise ValueError(
                "the int8 trunk (quantize='int8' / DECO_QUANT=int8) is an inference-only "
                "serving mode: its int8 products pass no gradient to the trunk weights, "
                "which would stop learning while the rest trains. Unset it for fit.")
        state = cls(model=model, optimizer=None, ema_params=None, trainer_module=trainer_module)
        params = state.parameters()
        wrong = {p.dtype for p in params} - {torch.float32}
        if wrong:
            raise TypeError(f"TrainState: parameters must be float32 (param_dtype), got {wrong}")
        if optimizer is None:
            state.optimizer = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                                weight_decay=weight_decay)
        else:
            state.optimizer = optimizer(params)
        state.ema_params = [p.detach().clone() for p in params] if ema else None
        return state


def _factored_dims(shape, min_dim_size_to_factor: int):
    """The two largest dims (second largest, largest) when the second
    largest has at least ``min_dim_size_to_factor`` entries, else None
    (optax's ``_factored_dims``, numpy's argsort included)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` with optax's defaults, written out:

    1. ``scale_by_factored_rms``: with decay ``1 - (t + 1) ** -0.8`` at step
       t, the second moment of ``g * g + 1e-30`` is kept factored (a row and
       a column mean, over the two largest dims) where the second largest
       has at least 128 entries, else whole; the update is ``g`` over its
       square root (the row factor normalised by its mean);
    2. ``clip_by_block_rms(1.0)``: divided by max(1, rms of the update);
    3. times ``lr``;
    4. ``scale_by_param_block_rms``: times max(rms of the parameter, 1e-3)
       (the parameter before the update);
    5. subtracted from the parameter.

    Each parameter's state: ``step`` (0-d fp32), and ``v_row`` and ``v_col``
    (factored) or ``v``. The factoring is symmetric in the two dims, so a
    torch (out, in) weight gets the update of the JAX (in, out) kernel.
    """

    def __init__(self, params, lr: float = 1e-4, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0,
                 min_scale: float = 1e-3, eps: float = 1e-30):
        super().__init__(params, dict(lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
                                      decay_rate=decay_rate,
                                      clipping_threshold=clipping_threshold,
                                      min_scale=min_scale, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad.float(), self.state[p], group)

    @staticmethod
    def _update(p, g, state, group):
        dims = _factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32)
            if dims is None:
                state["v"] = torch.zeros_like(p, dtype=torch.float32)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros_like(p, dtype=torch.float32).select(d0, 0)
                state["v_col"] = torch.zeros_like(p, dtype=torch.float32).select(d1, 0)
        t = state["step"] + 1.0
        decay = float(1.0 - t ** -group["decay_rate"])
        grad_sqr = g * g + group["eps"]
        if dims is None:
            v = state["v"].mul_(decay).add_(grad_sqr, alpha=1.0 - decay)
            update = g * torch.rsqrt(v)
        else:
            d1, d0 = dims
            v_row = state["v_row"].mul_(decay).add_(grad_sqr.mean(dim=d0), alpha=1.0 - decay)
            v_col = state["v_col"].mul_(decay).add_(grad_sqr.mean(dim=d1), alpha=1.0 - decay)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = torch.rsqrt(v_row / v_row.mean(dim=reduced_d1, keepdim=True))
            update = g * row_factor.unsqueeze(d0) * torch.rsqrt(v_col).unsqueeze(d1)
        update = update / torch.clamp_min(
            update.pow(2).mean().sqrt() / group["clipping_threshold"], 1.0)
        update = update * group["lr"]
        rms = p.float().pow(2).mean().sqrt()
        update = update * torch.where(rms <= group["min_scale"],
                                      torch.full_like(rms, group["min_scale"]), rms)
        p.sub_(update.to(p.dtype))
        state["step"] = t


@torch.no_grad()
def ema_update(ema_params, params, decay: float) -> None:
    """In place: e <- e * decay + p * (1 - decay) (on the local shards of
    FSDP2's sharded parameters)."""
    from deco_tpu_torch.parallel.mesh import local

    ema = [local(e) for e in ema_params]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [local(p).detach() for p in params], alpha=1.0 - decay)


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
