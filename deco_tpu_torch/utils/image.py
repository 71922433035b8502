"""Image range conversions (``deco_tpu/utils/image.py``), on tensors."""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _channels(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, device=like.device)


def normalize_to_neg1_to_1(x01):
    """[0, 1] -> [-1, 1]."""
    return x01 * 2.0 - 1.0


def normalize_from_neg1_to_1(xn):
    """[-1, 1] -> [0, 1]."""
    return (xn + 1.0) * 0.5


def normalize_imagenet(x01: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> ImageNet-normalised, channels last."""
    return (x01 - _channels(IMAGENET_MEAN, x01)) / _channels(IMAGENET_STD, x01)


def denormalize_imagenet(x: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """ImageNet-normalised -> [0, 1], channels last."""
    out = x * _channels(IMAGENET_STD, x) + _channels(IMAGENET_MEAN, x)
    return torch.clamp(out, 0.0, 1.0) if clamp else out


def to_uint8(x01: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> uint8 with rounding."""
    return torch.clamp(x01 * 255.0 + 0.5, 0, 255).to(torch.uint8)
