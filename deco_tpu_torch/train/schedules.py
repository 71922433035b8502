"""Learning-rate schedules (``deco_tpu/train/schedules.py``).

A schedule is a function of the step; a caller sets it on the optimizer,
e.g. through ``torch.optim.lr_scheduler.LambdaLR``. ``adamw_with_groups``
(UniFlow's lower vision-encoder LR) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_with_min_lr(base_lr: float, warmup_steps: int, total_steps: int,
                       min_lr: float) -> Callable[[int], float]:
    """Linear warmup, then cosine decay to ``min_lr`` (HF semantics)."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * min(step / max(warmup_steps, 1), 1.0)
        progress = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * progress))

    return schedule
