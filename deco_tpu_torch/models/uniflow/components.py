"""UniFlow building blocks (``deco_tpu/models/uniflow/components.py``).

- :func:`pixel_shuffle_tokens` and :func:`resample_tokens`: the token-grid
  pixel shuffle, step for step the reference's, so the flattened element
  order matches converted checkpoints (``mlp1`` reads the x0.5 shuffle of
  the ViT tokens; the latent projector halves the grid, the pixel trunk
  doubles it again).
- :func:`p2l_transform` and :func:`l2p_transform`: an NHWC image to patch
  tokens, channel-major within a patch, and back.
- :func:`get_2d_sincos_pos_embed`: the MAE 2-D sincos table (numpy).
- :class:`GatedResBlock`, :class:`GatedFinalLayer` and
  :class:`LatentProjector`: the condition-gated projector from the ViT
  tokens (conditioned on the shallow ViT's) to the 256-channel latent grid.
- :class:`PlainDiTBlock`: a pre-norm DiT block without adaLN, RMSNorm,
  :class:`~deco_tpu_torch.models.layers.RAttention` with RoPE, residual,
  RMSNorm, the fused SwiGLU of exact width ``mlp_ratio * dim``, residual.
  ``is_causal`` calls the attention with ``causal=True``: the kernel's causal
  instantiation on the card, the masked plain version on the CPU.
- :class:`UniFlowNerfEmbedder` and :class:`TimeCondMLPAdaLN`: the flow
  decoder's condition embedder (the cos-RoPE basis of the token grid at
  ``max_freqs`` 32) and its token-wise MLP, whose timestep embedding has
  ``max_period`` 10,000 (the DeCo family's is 10).

Module names are the reference's state-dict keys.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deco_tpu_torch.models import layers as L
from deco_tpu_torch.models.dit_t2i import nerf_rope_cos_basis


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


def p2l_transform(x, patch_size: int):
    """NHWC image -> (B, L, C * P * P) patch tokens, channel-major within a patch."""
    b, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def l2p_transform(x, patch_size: int):
    """(B, L, C * P * P) over a square grid -> NHWC image (the inverse of
    :func:`p2l_transform`)."""
    b, n, d = x.shape
    p = patch_size
    c = d // (p * p)
    g = int(round(np.sqrt(n)))
    x = x.reshape(b, g, g, c, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, g * p, g * p, c)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """The MAE 2-D sincos position embedding, (grid_size^2, embed_dim) float32."""

    def one_axis(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    axis = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(axis, axis), axis=0).reshape(2, 1, grid_size, grid_size)
    return np.concatenate([one_axis(embed_dim // 2, grid[0]), one_axis(embed_dim // 2, grid[1])],
                          axis=1).astype(np.float32)


# The gated res block (LayerNorm eps 1e-6, adaLN shift, scale and gate from
# silu(y) through the zero-initialised ``adaLN_modulation.1``, linear, SiLU,
# linear, gated residual) is the DeCo pixel decoder's, under UniFlow's name.
GatedResBlock = L.AdaLNResBlock


class GatedFinalLayer(nn.Module):
    """A parameter-free LayerNorm (eps 1e-6) modulated by silu(c) through the
    zero-initialised ``adaLN_modulation.1``, then the zero-initialised ``linear``."""

    def __init__(self, channels: int, out_channels: int, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), L.Linear(channels, 2 * channels, **kw))
        self.norm_final = L.LayerNorm(channels, eps=1e-6, affine=False, dtype=dtype)
        self.linear = L.Linear(channels, out_channels, **kw)
        for layer in (self.adaLN_modulation[1], self.linear):
            nn.init.zeros_(layer.weight)
            nn.init.zeros_(layer.bias)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(L.modulate(self.norm_final(x), shift, scale))


class LatentProjector(nn.Module):
    """Condition-gated projector: input and condition projections, gated res
    blocks, the gated final layer, the x0.5 token shuffle, a linear to
    ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int = 256, num_res_blocks: int = 3,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.input_proj = L.Linear(in_channels, in_channels, **kw)
        self.cond_proj = L.Linear(in_channels, in_channels, **kw)
        self.res_blocks = nn.ModuleList(GatedResBlock(in_channels, **kw)
                                        for _ in range(num_res_blocks))
        self.final_layer = GatedFinalLayer(in_channels, in_channels, **kw)
        self.post_shuffle_proj = L.Linear(4 * in_channels, out_channels, **kw)

    def forward(self, x, condition):
        x, cond = self.input_proj(x), self.cond_proj(condition)
        for block in self.res_blocks:
            x = block(x, cond)
        return self.post_shuffle_proj(resample_tokens(self.final_layer(x, cond), 0.5))


class PlainDiTBlock(nn.Module):
    """Pre-norm DiT block: RMSNorm, RoPE attention (causal with
    ``is_causal``), residual; RMSNorm, fused SwiGLU of width
    ``int(dim * mlp_ratio)``, residual."""

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
        x = x + self.attn(self.norm1(x), rope, causal=self.is_causal)
        return x + self.mlp(self.norm2(x))


class UniFlowNerfEmbedder(nn.Module):
    """Condition tokens (B, N, z) and the cos-RoPE basis of their square
    grid (N, max_freqs^2), concatenated in the compute dtype, through a
    linear back to ``hidden_size``."""

    def __init__(self, in_channels: int, hidden_size: int, max_freqs: int = 32,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.max_freqs = max_freqs
        self.dtype = dtype
        self.embedder = nn.Sequential(L.Linear(in_channels + max_freqs**2, hidden_size,
                                               dtype=dtype, param_dtype=param_dtype))
        self._basis: dict = {}

    def basis(self, n: int, device) -> torch.Tensor:
        key = (n, device)
        if key not in self._basis:
            grid = int(round(np.sqrt(n)))
            self._basis[key] = torch.from_numpy(nerf_rope_cos_basis(grid, self.max_freqs)).to(device)
        return self._basis[key]

    def forward(self, z):
        b, n, _ = z.shape
        basis = self.basis(n, z.device).to(self.dtype).expand(b, n, -1)
        return self.embedder(torch.cat([z.to(self.dtype), basis], dim=-1))


class TimeCondMLPAdaLN(nn.Module):
    """The token-wise flow MLP: ``input_proj`` of x, ``time_embed`` of t
    (already x1000; max_period 10,000) plus ``cond_embed`` of the condition
    as y, gated res blocks on y, the gated final layer."""

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 z_channels: int, num_res_blocks: int, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.input_proj = L.Linear(in_channels, model_channels, **kw)
        self.time_embed = L.TimestepEmbedder(model_channels, max_period=10000.0, **kw)
        self.cond_embed = L.Linear(z_channels, model_channels, **kw)
        self.res_blocks = nn.ModuleList(GatedResBlock(model_channels, **kw)
                                        for _ in range(num_res_blocks))
        self.final_layer = GatedFinalLayer(model_channels, out_channels, **kw)

    def forward(self, x, t, c):
        """x (..., C_in); t (...) timesteps; c (..., z)."""
        x = self.input_proj(x)
        c = self.cond_embed(c)
        y = self.time_embed(t).reshape(c.shape) + c
        for block in self.res_blocks:
            x = block(x, y)
        return self.final_layer(x, y)
