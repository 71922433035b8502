"""UniFlow building blocks that ReCo shares (``deco_tpu/models/uniflow/components.py``).

- :func:`pixel_shuffle_tokens` and :func:`resample_tokens`: the token-grid
  pixel shuffle, step for step the reference's, so the flattened element
  order matches converted checkpoints (``mlp1`` reads the x0.5 shuffle of
  the ViT tokens).
- :class:`PlainDiTBlock`: a pre-norm DiT block without adaLN, RMSNorm,
  :class:`~deco_tpu_torch.models.layers.RAttention` with RoPE, residual,
  RMSNorm, the fused SwiGLU of exact width ``mlp_ratio * dim``, residual.
  ``is_causal`` builds the lower-triangular mask, which ``layers.sdpa``
  takes on the CPU and refuses on the card (the kernel is unmasked).

The sincos tables, the gated res blocks, the latent projector and the
time-conditioned decoder are UniFlow's alone and are not here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deco_tpu_torch.models import layers as L


def pixel_shuffle_tokens(x, scale_factor: float):
    """Token-grid pixel shuffle of x (B, H, W, C), the reference's reshapes
    and transposes in its order."""
    n, w, h, c = x.shape  # the reference names the dims (n, w, h, c)
    s = scale_factor
    x = x.reshape(n, w, int(h * s), int(c / s))
    x = x.transpose(1, 2)
    x = x.reshape(n, int(h * s), int(w * s), int(c / (s * s)))
    return x.transpose(1, 2)


def resample_tokens(tokens, scale_factor: float):
    """(B, N, C) -> (B, N * s^2, C / s^2) over the square token grid; s = 0.5
    halves the grid, s = 2 doubles it."""
    b, n, c = tokens.shape
    side = int(round(np.sqrt(n)))
    x = pixel_shuffle_tokens(tokens.reshape(b, side, side, c), scale_factor)
    return x.reshape(b, -1, x.shape[-1])


class PlainDiTBlock(nn.Module):
    """Pre-norm DiT block: RMSNorm, RoPE attention, residual; RMSNorm, fused
    SwiGLU of width ``int(dim * mlp_ratio)``, residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, is_causal: bool = False,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.is_causal = is_causal
        self.norm1 = L.RMSNorm(dim)
        self.attn = L.RAttention(dim, num_heads, **kw)
        self.norm2 = L.RMSNorm(dim)
        self.mlp = L.SwiGLUFused(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x, rope):
        mask = None
        if self.is_causal:
            n = x.shape[1]
            mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device=x.device))[None, None]
        x = x + self.attn(self.norm1(x), rope, mask)
        return x + self.mlp(self.norm2(x))
