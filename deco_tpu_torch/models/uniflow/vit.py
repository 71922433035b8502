"""InternViT-style vision transformer (``deco_tpu/models/uniflow/vit.py``).

The tower that the REPA encoder DINOv2 builds on, and that the UniFlow and
ReCo families share:

- a patch embed (a stride-p convolution, computed as an unfold and a
  product so that fp32 stays fp32 on the card), a class token and a learned
  position embedding, cubic-resized to the input's grid
  (:func:`interp_pos_embed`);
- pre-norm layers: norm1, attention (qkv bias per config; with
  ``qk_normalization`` an RMSNorm over the flattened heads x dim width, the
  InternViT quirk), LayerScale ``ls1``, residual; norm2, exact-GELU MLP,
  ``ls2``, residual; ``norm_type`` "layer_norm" or "rms_norm";
- :class:`ViTEncoder` with the ``select_layer`` tap (1-based).

:func:`resize_cubic` is the port's copy of ``jax.image.resize(...,
"cubic")``: Keys cubic (a = -0.5), half-pixel centres, and on a downscale
the kernel widened by the scale (antialiasing), weights normalised per
output sample. ``torch.nn.functional.interpolate(mode="bicubic")`` uses
a = -0.75 and no antialiasing, so it is not used.

Parameter names are those of the InternViT torch model
(``embeddings.patch_embedding``, ``encoder.layers.{i}.attn.qkv``, ...), which
``convert.dinov2_state_dict_from_jax`` and the DINOv2 hub loader write.
Attention goes through ``layers.sdpa``: the flash kernel on the card
(fp32 operands included), its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    image_size: int = 448
    qkv_bias: bool = True
    qk_normalization: bool = False
    norm_type: str = "layer_norm"  # or "rms_norm"
    layer_norm_eps: float = 1e-6
    initializer_factor: float = 1.0


def _keys_cubic(x):
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of ``jax.image.resize``'s cubic
    along one axis (``compute_weight_mat`` with antialias)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = _keys_cubic(dist / np.float32(kernel_scale)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0.0).T.astype(np.float32))


def resize_cubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, height, width, C), "cubic")`` of an NHWC
    tensor, in fp32: two separable products."""
    wh = torch.from_numpy(cubic_resize_weights(x.shape[1], height)).to(x.device)
    ww = torch.from_numpy(cubic_resize_weights(x.shape[2], width)).to(x.device)
    x = torch.einsum("oh,bhwc->bowc", wh, x.float())
    return torch.einsum("pw,bowc->bopc", ww, x)


def interp_pos_embed(pos_embed, grid_h: int, grid_w: int):
    """Cubic-resize a (1, N, C) square-grid position embedding to
    (1, grid_h * grid_w, C), fp32; unchanged when the grid matches."""
    n = pos_embed.shape[1]
    orig = int(round(np.sqrt(n)))
    if (orig, orig) == (grid_h, grid_w):
        return pos_embed
    pe = pos_embed.float().reshape(1, orig, orig, -1)
    return resize_cubic(pe, grid_h, grid_w).reshape(1, grid_h * grid_w, -1)


def _norm(cfg: ViTConfig, dim: int) -> nn.Module:
    if cfg.norm_type == "rms_norm":
        return L.RMSNorm(dim, eps=cfg.layer_norm_eps)
    # flax nn.LayerNorm(dtype=None): fp32 statistics and an fp32 output
    return L.LayerNorm(dim, eps=cfg.layer_norm_eps)


class PatchEmbedding(nn.Module):
    """A stride-p p x p convolution (weight (C, 3, p, p), as the torch
    conv's) as an unfold and a product."""

    def __init__(self, channels: int, patch_size: int, in_channels: int = 3,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        pd = param_dtype or dtype
        self.weight = nn.Parameter(torch.zeros(channels, in_channels, patch_size, patch_size,
                                               dtype=pd))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=pd))

    def forward(self, x):
        """x: (B, H, W, 3) -> (B, H/p * W/p, C)."""
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, gh * gw, c * p * p).to(self.dtype)
        return F.linear(x, self.weight.reshape(self.weight.shape[0], -1).to(self.dtype),
                        self.bias.to(self.dtype))


class ViTEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg.hidden_size
        base = cfg.image_size // cfg.patch_size
        self.patch_embedding = PatchEmbedding(c, cfg.patch_size, dtype=dtype,
                                              param_dtype=param_dtype)
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, c))
        self.position_embedding = nn.Parameter(torch.zeros(1, base * base + 1, c))

    def forward(self, pixel_values):
        """(B, H, W, 3) -> (B, 1 + N, C), the class token first."""
        b, h, w, _ = pixel_values.shape
        p = self.cfg.patch_size
        patches = self.patch_embedding(pixel_values)
        pos = self.position_embedding
        pos = torch.cat([pos[:, :1].float(), interp_pos_embed(pos[:, 1:], h // p, w // p)], dim=1)
        cls = self.class_embedding.to(self.dtype).expand(b, 1, -1)
        return torch.cat([cls, patches], dim=1) + pos.to(self.dtype)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, param_dtype=None):
        super().__init__()
        c = cfg.hidden_size
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.num_heads = cfg.num_heads
        self.qkv = L.Linear(c, 3 * c, bias=cfg.qkv_bias, **kw)
        self.q_norm = self.k_norm = None
        if cfg.qk_normalization:  # over the flattened heads x dim width
            self.q_norm = L.RMSNorm(c, eps=cfg.layer_norm_eps)
            self.k_norm = L.RMSNorm(c, eps=cfg.layer_norm_eps)
        self.proj = L.Linear(c, c, **kw)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, c).unbind(2)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        shape = (b, n, self.num_heads, c // self.num_heads)
        out = L.sdpa(q.reshape(shape), k.reshape(shape), v.reshape(shape))
        return self.proj(out.reshape(b, n, c))


class ViTMLP(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.fc1 = L.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = L.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, param_dtype=None):
        super().__init__()
        c = cfg.hidden_size
        self.dtype = dtype
        self.norm1 = _norm(cfg, c)
        self.attn = ViTAttention(cfg, dtype, param_dtype)
        self.ls1 = nn.Parameter(torch.full((c,), cfg.initializer_factor))
        self.norm2 = _norm(cfg, c)
        self.mlp = ViTMLP(cfg, dtype, param_dtype)
        self.ls2 = nn.Parameter(torch.full((c,), cfg.initializer_factor))

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.ls1.to(self.dtype)
        return x + self.mlp(self.norm2(x)) * self.ls2.to(self.dtype)


class ViTEncoder(nn.Module):
    """The layers; ``select_layer`` (1-based, 0 off) taps one layer's output.
    ``grad_checkpoint`` recomputes each layer in the backward."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, param_dtype=None,
                 select_layer: int = 0, grad_checkpoint: bool = False):
        super().__init__()
        self.select_layer = select_layer
        self.grad_checkpoint = grad_checkpoint
        self.layers = nn.ModuleList(ViTLayer(cfg, dtype, param_dtype)
                                    for _ in range(cfg.num_layers))

    def forward(self, x):
        """(last hidden, the tapped layer's output or None)."""
        tapped = torch.zeros_like(x) if self.select_layer else None
        for i, layer in enumerate(self.layers):
            x = L.run_checkpointed(layer, x, enabled=self.grad_checkpoint)
            if i == self.select_layer - 1:
                tapped = x
        return x, tapped


class VisionModel(nn.Module):
    """Embeddings + encoder; returns (last_hidden, tapped_hidden or None)."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, param_dtype=None,
                 select_layer: int = 0, grad_checkpoint: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ViTEmbeddings(cfg, dtype, param_dtype)
        self.encoder = ViTEncoder(cfg, dtype, param_dtype, select_layer, grad_checkpoint)

    def forward(self, pixel_values):
        return self.encoder(self.embeddings(pixel_values))


@torch.no_grad()
def init_like_jax_(model: nn.Module, seed: int) -> nn.Module:
    """Draw a ViT's parameters from the JAX initializers' distributions
    (flax defaults): lecun-normal (truncated) kernels over their fan-in,
    zero biases, unit norm scales, normal(1.0) class and position
    embeddings, LayerScale at ``initializer_factor``. The values come from a
    CPU generator seeded with ``seed``; they are not the JAX package's."""
    gen = torch.Generator().manual_seed(seed)
    norms = {m for m in model.modules() if isinstance(m, (L.RMSNorm, L.LayerNorm))}
    for module in model.modules():
        for pname, param in module.named_parameters(recurse=False):
            r = torch.empty(param.shape, dtype=torch.float32)
            if module in norms:
                r.fill_(1.0 if pname == "weight" else 0.0)
            elif pname in ("ls1", "ls2"):
                r.copy_(param.detach().float())  # built at initializer_factor
            elif pname in ("class_embedding", "position_embedding"):
                r.normal_(0.0, 1.0, generator=gen)
            elif pname == "bias":
                r.zero_()
            else:
                std = (1.0 / param[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(r, 0.0, std, -2 * std, 2 * std, generator=gen)
            param.copy_(r)
    return model
