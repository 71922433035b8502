"""Multi-scale deformable convolution (MSDCN) (``deco_tpu/ops/msdcn.py``).

Per output position and group, K learned sampling points bilinearly
interpolate the value grid (zero outside the image) and are combined with
learned per-point weights; :class:`MultiScaleDCN` wraps the op with the
offset, scale and weight projections and the multi-scale sigmoid prior.
The op has no call site in the reference outside its own file; it is here
for parity. The JAX package computes it as an XLA gather with the backward
from autodiff, and has no Pallas kernel for it; the port computes it in
plain PyTorch (one gather per corner) with the backward from autograd.
Layouts are channels last, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from deco_tpu_torch.models.layers import Linear


def deformable_sample(v, deformables, weights):
    """v: (B, H, W, G, C); deformables: (B, H, W, G, K, 2) xy offsets;
    weights: (B, H, W, G, K). Returns (B, H, W, G, C)."""
    b, h, w, g, _ = v.shape
    dev = v.device
    # absolute sample coordinates (x = offset + column, y = offset + row)
    x = deformables[..., 0] + torch.arange(w, dtype=deformables.dtype, device=dev)[
        None, None, :, None, None]
    y = deformables[..., 1] + torch.arange(h, dtype=deformables.dtype, device=dev)[
        None, :, None, None, None]
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = x0 + 1, y0 + 1
    bi = torch.arange(b, device=dev)[:, None, None, None, None]
    gi = torch.arange(g, device=dev)[None, None, None, :, None]

    def corner(yc, xc, wgt):
        valid = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        sampled = v[bi, yc.clamp(0, h - 1), xc.clamp(0, w - 1), gi]  # (B, H, W, G, K, C)
        return sampled * (wgt * valid)[..., None]

    out = (corner(y0, x0, (x1 - x) * (y1 - y)) + corner(y0, x1, (x - x0) * (y1 - y))
           + corner(y1, x0, (x1 - x) * (y - y0)) + corner(y1, x1, (x - x0) * (y - y0)))
    return torch.einsum("bhwgkc,bhwgk->bhwgc", out, weights)


class MultiScaleDCN(nn.Module):
    """Deformable attention-style module over (B, H, W, dim) inputs:
    values ``v`` (dim -> groups * channels), offsets ``qk_deformables``,
    log-scales ``qk_scales`` and point weights ``qk_weights`` (all three
    zero-initialised, as in the JAX module), the per-group prior scale
    ``deformables_scale`` and the output projection ``out``. The offsets are
    (projection + a sqrt(K) x sqrt(K) grid in [-1, 1]) times
    sigmoid(log-scale + group prior) * ``max_scale``."""

    def __init__(self, dim: int, groups: int, channels: int, kernels: int,
                 max_scale: float = 6.0, dtype=torch.float32):
        super().__init__()
        g, c, k = groups, channels, kernels
        self.groups, self.channels, self.kernels = g, c, k
        self.max_scale = max_scale
        self.v = Linear(dim, g * c, dtype=dtype)
        self.qk_deformables = Linear(dim, g * k * 2, dtype=dtype)
        self.qk_scales = Linear(dim, g * k, bias=False, dtype=dtype)
        self.qk_weights = Linear(dim, g * k, dtype=dtype)
        self.out = Linear(g * c, dim, dtype=dtype)
        for lin in (self.qk_deformables, self.qk_scales, self.qk_weights):
            nn.init.zeros_(lin.weight)
        for lin in (self.v, self.qk_deformables, self.qk_weights, self.out):
            nn.init.zeros_(lin.bias)
        inv_scales = [math.log(((i + 1) / g - 1e-4) / (1 - ((i + 1) / g - 1e-4)))
                      for i in range(g)]
        self.deformables_scale = nn.Parameter(
            torch.tensor(inv_scales, dtype=torch.float32).reshape(1, 1, 1, g, 1, 1))
        prior = np.zeros((k, 2), np.float32)
        num_prior = int(round(math.sqrt(k)))
        if num_prior >= 1:
            d = np.linspace(-1, 1, num_prior)
            gx, gy = np.meshgrid(d, d, indexing="xy")
            prior[: num_prior * num_prior] = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
        self.register_buffer("prior", torch.from_numpy(prior).reshape(1, 1, 1, 1, k, 2),
                             persistent=False)

    def forward(self, x):
        b, h, w, _ = x.shape
        g, c, k = self.groups, self.channels, self.kernels
        v = self.v(x).reshape(b, h, w, g, c)
        deform = self.qk_deformables(x).reshape(b, h, w, g, k, 2)
        scale = self.qk_scales(x).reshape(b, h, w, g, k, 1)
        wts = self.qk_weights(x).reshape(b, h, w, g, k)
        scale = torch.sigmoid(scale + self.deformables_scale) * self.max_scale
        deform = (deform + self.prior) * scale
        return self.out(deformable_sample(v, deform, wts).reshape(b, h, w, g * c))
