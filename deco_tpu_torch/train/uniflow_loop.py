"""UniFlow training and reconstruction (``deco_tpu/train/uniflow_loop.py``).

:class:`UniFlowExperiment` builds :class:`~deco_tpu_torch.models.uniflow.model.UniFlowVision`
and its train state: two AdamW groups (:func:`~deco_tpu_torch.train.schedules.adamw_with_groups`:
the vision encoder, the shallow one and ``mlp1`` at ``vision_lr``, the rest
at ``lr``, each on its ``cosine_with_min_lr`` of the shared update count),
the EMA of every parameter, and the freeze flags: ``frozen_encoder`` (both
ViTs) and ``frozen_mlp`` leave those parameters out of the optimizer, as
``with_frozen`` zeroes their updates in JAX, while the step still takes
their gradients and counts them in the clip's norm (``train/freeze.py``).

A step, as the JAX step: ``forward_loss``; the gradient of every
parameter; the clip by the global norm of all of them,
``min(1, clip / (norm + 1e-6))``; AdamW; the EMA. It updates the state in
place and returns the loss terms and ``grad_norm`` as 0-d tensors.
:meth:`UniFlowExperiment.reconstruct` pads H and W symmetrically with zeros
to multiples of 2 x patch (28), reconstructs and crops back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from deco_tpu_torch.models.uniflow.model import UniFlowConfig, UniFlowVision
from deco_tpu_torch.train.freeze import split_frozen
from deco_tpu_torch.train.schedules import adamw_with_groups, cosine_with_min_lr, set_group_lrs
from deco_tpu_torch.train.state import ema_update

# the JAX parameter groups ("vision", "shallow", "mlp1") in the port's names
VISION_GROUP = ("embeddings.", "encoder.", "shallow_", "mlp1.")
FROZEN_ENCODER = ("embeddings", "encoder", "shallow_embeddings", "shallow_encoder")
FROZEN_MLP = ("mlp1",)


@dataclasses.dataclass
class UniFlowTrainConfig:
    lr: float = 1e-4
    vision_lr: float = 1e-5
    warmup_steps: int = 10000
    total_steps: int = 200000
    min_lr: float = 1e-5
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.95)
    use_ema: bool = True
    ema_decay: float = 0.9999
    frozen_encoder: bool = False
    frozen_mlp: bool = False
    grad_clip: float = 1.0

    def __post_init__(self):
        # a YAML 1.1 reader gives `lr: 1e-4` as a string (ROADMAP §C 5)
        for k in ("lr", "vision_lr", "min_lr", "weight_decay", "ema_decay", "grad_clip"):
            setattr(self, k, float(getattr(self, k)))
        self.betas = tuple(float(b) for b in self.betas)


@dataclasses.dataclass
class UniFlowTrainState:
    """The model, the optimizer (its trainable parameters), the EMA (a list
    of fp32 tensors in ``model.parameters()`` order, or None) and the step."""

    model: UniFlowVision
    optimizer: torch.optim.Optimizer
    ema_params: Optional[list]
    step: int = 0


class UniFlowExperiment:
    def __init__(self, model_cfg: UniFlowConfig = UniFlowConfig(),
                 train_cfg: UniFlowTrainConfig = UniFlowTrainConfig(),
                 teacher_fn: Optional[Callable] = None, lpips_fn: Optional[Callable] = None,
                 dtype=torch.bfloat16, device="cuda"):
        self.model = UniFlowVision(model_cfg, dtype=dtype, device=device)
        self.cfg = train_cfg
        self.teacher_fn = teacher_fn
        self.lpips_fn = lpips_fn

    def frozen_prefixes(self) -> tuple:
        return ((FROZEN_ENCODER if self.cfg.frozen_encoder else ())
                + (FROZEN_MLP if self.cfg.frozen_mlp else ()))

    def init_state(self, seed: Optional[int] = 0) -> UniFlowTrainState:
        """The train state over the model's parameters, drawn from ``seed``
        first unless it is None (parameters loaded already)."""
        if seed is not None:
            self.model.init_like_jax_(seed)
        cfg = self.cfg
        trainable, _ = split_frozen(self.model.named_parameters(), self.frozen_prefixes())
        optimizer = adamw_with_groups(
            trainable, cfg.lr, VISION_GROUP, cfg.vision_lr, cfg.weight_decay, cfg.betas,
            schedule_fn=lambda lr: cosine_with_min_lr(lr, cfg.warmup_steps, cfg.total_steps,
                                                      cfg.min_lr))
        ema = [p.detach().clone() for p in self.model.parameters()] if cfg.use_ema else None
        return UniFlowTrainState(self.model, optimizer, ema)

    def train_step(self, state: UniFlowTrainState, x, draws: Optional[dict] = None,
                   generator=None, teacher_feat: Optional[dict] = None) -> dict:
        """One update of ``state`` in place from the batch ``x`` (B, H, W, 3)
        in [-1, 1]; returns the loss terms and ``grad_norm``."""
        model = self.model.train()
        params = list(model.parameters())
        losses = model.forward_loss(x, draws, generator, teacher_feat, self.lpips_fn)
        grads = torch.autograd.grad(losses["loss"], params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))  # optax.global_norm
        torch._foreach_mul_(grads, torch.clamp(self.cfg.grad_clip / (norm + 1e-6), max=1.0))
        for p, g in zip(params, grads):
            p.grad = g
        set_group_lrs(state.optimizer, state.step)
        state.optimizer.step()
        for p in params:
            p.grad = None
        if state.ema_params is not None:
            ema_update(state.ema_params, params, self.cfg.ema_decay)
        state.step += 1
        return {**{k: v.detach() for k, v in losses.items()}, "grad_norm": norm.detach()}

    @torch.no_grad()
    def reconstruct(self, x, mode: str = "pixel", noise=None, generator=None):
        """Pad H and W symmetrically with zeros to multiples of 2 x patch,
        reconstruct, crop the pixel reconstruction back to (H, W)."""
        _, h, w, _ = x.shape
        mult = 2 * self.model.cfg.patch_size
        ph, pw = (-h) % mult, (-w) % mult
        pt, pl = ph // 2, pw // 2
        if ph or pw:
            x = F.pad(x, (0, 0, pl, pw - pl, pt, ph - pt))
        out = self.model.eval()(x, mode=mode, noise=noise, generator=generator)
        if mode == "pixel" and (ph or pw):
            out = out[:, pt:pt + h, pl:pl + w]
        return out
