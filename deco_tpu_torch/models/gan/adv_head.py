"""Adversarial heads over DiT token features (``deco_tpu/models/gan/adv_head.py``;
the reference's ``src/models/layers/adv_head.py``).

Small conv discriminator heads that score a (B, L, C) token grid (L a
square, read row-major): :class:`ConvHead` (image tokens only),
:class:`ConvLinearMMHead` (image tokens and a pooled multimodal vector
through a linear tower) and :class:`ConvMMHead` (image tokens and a second
token grid through a twin conv tower). Each conv tower is 3 x [4 x 4
convolution of stride 2 and padding 1, GroupNorm(32, eps 1e-5), SiLU], then
a global average pool; the outputs go through a sigmoid clamped to [0.01,
0.99]. Outputs are (B, 1), as the JAX heads give them. The reference file
has no call site upstream.

Flax infers each first layer's input width; here ``in_channels`` (the
tokens' C) and ``mm_channels`` (the second input's) default to
``hidden_size``. :func:`~deco_tpu_torch.convert.adv_head_state_dict_from_jax`
converts the Flax params.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _tokens_to_grid(feature: torch.Tensor) -> torch.Tensor:
    """(B, L, C) row-major tokens -> (B, C, H, W), H = W = sqrt(L)."""
    b, l, c = feature.shape
    h = int(math.sqrt(l))
    if h * h != l:
        raise ValueError(f"token count {l} is not a square grid")
    return feature.reshape(b, h, h, c).permute(0, 3, 1, 2)


class ConvTower(nn.Module):
    """3 x [Conv 4 x 4 s2 p1, GroupNorm(32), SiLU] and a global average pool."""

    def __init__(self, hidden_size: int, in_channels: Optional[int] = None):
        super().__init__()
        widths = [in_channels or hidden_size] + [hidden_size] * 3
        self.convs = nn.ModuleList(nn.Conv2d(widths[i], hidden_size, 4, stride=2, padding=1)
                                   for i in range(3))
        self.norms = nn.ModuleList(nn.GroupNorm(32, hidden_size, eps=1e-5) for _ in range(3))

    def forward(self, x):
        for conv, norm in zip(self.convs, self.norms):
            x = F.silu(norm(conv(x)))
        return x.mean(dim=(2, 3))


def _squash(x):
    return torch.clamp(torch.sigmoid(x), 0.01, 0.99)


class ConvHead(nn.Module):
    """Image-token head."""

    def __init__(self, hidden_size: int, in_channels: Optional[int] = None):
        super().__init__()
        self.tower = ConvTower(hidden_size, in_channels)
        self.out = nn.Linear(hidden_size, 1)  # the 1 x 1 convolution

    def forward(self, feature, text_embedding=None):
        return _squash(self.out(self.tower(_tokens_to_grid(feature))))


class ConvLinearMMHead(nn.Module):
    """Image tokens and a pooled multimodal vector."""

    def __init__(self, hidden_size: int, in_channels: Optional[int] = None,
                 mm_channels: Optional[int] = None):
        super().__init__()
        self.conv_head = ConvTower(hidden_size, in_channels)
        self.lin0 = nn.Linear(mm_channels or hidden_size, hidden_size)
        self.lin1 = nn.Linear(hidden_size, hidden_size)
        self.out = nn.Linear(2 * hidden_size, 1)

    def forward(self, im_feature, mm_feature):
        im = self.conv_head(_tokens_to_grid(im_feature))
        mm = F.silu(self.lin1(F.silu(self.lin0(mm_feature))))
        return _squash(self.out(torch.cat([im, mm], dim=-1)))


class ConvMMHead(nn.Module):
    """Image tokens and a second token grid through a twin tower."""

    def __init__(self, hidden_size: int, in_channels: Optional[int] = None,
                 mm_channels: Optional[int] = None):
        super().__init__()
        self.conv1_head = ConvTower(hidden_size, in_channels)
        self.conv2_head = ConvTower(hidden_size, mm_channels)
        self.out = nn.Linear(2 * hidden_size, 1)

    def forward(self, im_feature, mm_feature):
        im = self.conv1_head(_tokens_to_grid(im_feature))
        mm = self.conv2_head(_tokens_to_grid(mm_feature))
        return _squash(self.out(torch.cat([im, mm], dim=-1)))
