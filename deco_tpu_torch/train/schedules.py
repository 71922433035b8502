"""Learning-rate schedules and the two-group AdamW (``deco_tpu/train/schedules.py``).

A schedule is a function of the step; a caller sets it on the optimizer,
e.g. through ``torch.optim.lr_scheduler.LambdaLR``, or, for the optimizer of
:func:`adamw_with_groups`, through :func:`set_group_lrs`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def cosine_with_min_lr(base_lr: float, warmup_steps: int, total_steps: int,
                       min_lr: float) -> Callable[[int], float]:
    """Linear warmup, then cosine decay to ``min_lr`` (HF semantics)."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * min(step / max(warmup_steps, 1), 1.0)
        progress = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * progress))

    return schedule


def adamw_with_groups(named_parameters, base_lr: float, group_prefixes: Sequence[str],
                      group_lr: float, weight_decay: float = 0.0, betas=(0.9, 0.999),
                      schedule_fn: Optional[Callable[[float], Callable[[int], float]]] = None
                      ) -> torch.optim.AdamW:
    """AdamW (optax's eps 1e-8) with two parameter groups: the parameters
    whose name starts with one of ``group_prefixes`` at ``group_lr`` (the
    vision encoder's lower rate), the others at ``base_lr``. Each group
    carries its ``schedule`` (``schedule_fn(lr)``, else the constant rate),
    which :func:`set_group_lrs` evaluates at the shared update count: it
    starts at 0, so a warmup schedule gives the first update a rate of 0,
    as ``optax.multi_transform`` of two ``optax.adamw`` does."""
    default, group = [], []
    for name, p in named_parameters:
        (group if any(name.startswith(pre) for pre in group_prefixes) else default).append(p)
    groups = [{"params": params, "lr": 0.0, "group": label,
               "schedule": schedule_fn(lr) if schedule_fn else (lambda step, lr=lr: lr)}
              for label, params, lr in (("default", default, base_lr), ("group", group, group_lr))
              if params]
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(betas), eps=1e-8,
                             weight_decay=weight_decay)


def set_group_lrs(optimizer: torch.optim.Optimizer, step: int) -> list:
    """Set each group's rate to its ``schedule`` at ``step``; returns the rates."""
    for group in optimizer.param_groups:
        group["lr"] = group["schedule"](step)
    return [group["lr"] for group in optimizer.param_groups]
