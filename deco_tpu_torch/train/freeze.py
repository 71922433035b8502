"""Freezing parameters by name prefix (``deco_tpu/train/freeze.py``).

The JAX package freezes a subtree by giving it a zero update
(``optax.multi_transform`` with ``set_to_zero``) after the gradient clip,
so a frozen parameter keeps its value and has no optimizer state, while its
gradient is still computed and still counts in the clip's norm. The port
does the same: :func:`split_frozen` leaves the frozen parameters out of the
optimizer and the training step still takes their gradients for the norm.
"""

from __future__ import annotations

from typing import Sequence


def is_frozen(name: str, frozen_prefixes: Sequence[str]) -> bool:
    """True when the dotted parameter name lies under one of the prefixes
    (``vision_model`` freezes ``vision_model.*``)."""
    return any(name == p or name.startswith(p + ".") for p in frozen_prefixes)


def split_frozen(named_parameters, frozen_prefixes: Sequence[str]) -> tuple:
    """([(name, parameter)] to train, [(name, parameter)] frozen)."""
    train, frozen = [], []
    for name, p in named_parameters:
        (frozen if is_frozen(name, frozen_prefixes) else train).append((name, p))
    return train, frozen
