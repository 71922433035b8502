"""DC-AE, the deep-compression autoencoder of SANA (f32c32)
(``deco_tpu/models/dcae.py``).

The decoder the VAE-GAN trains (InternViT -> DC-AE), and the network of the
``DCLatentAE`` codec. Module and parameter names are the diffusers
``AutoencoderDC`` layout that ``deco_tpu/convert/dcae_bridge.py`` reads
(``encoder.down_blocks.{i}.{j}`` with the stage's ``DCDownBlock2d`` last,
``decoder.up_blocks.{i}.{j}`` with its ``DCUpBlock2d`` first, ``attn.qkv``,
``attn.q_norm``, ``conv_out.conv_inverted``, ...), so a diffusers state dict
loads with ``load_state_dict`` (:func:`deco_tpu_torch.convert.dcae_from_torch_state`
builds the model from one).

Numerics follow the Flax modules:

- convolutions and linears keep fp32 parameters and compute in the model's
  ``dtype`` (:class:`Conv2d`, ``layers.Linear``);
- :class:`DCRMSNorm` (diffusers ``get_normalization("rms_norm")``: eps
  1e-5 and a bias) and the attention's q/k ``RMSNorm`` (eps 1e-6, over the
  flattened heads) compute in fp32 and cast back;
- the attention rotates q and k by the EX2D 2-D RoPE table
  (``precompute_rope_2d(32, h, w, scale=1.0, extrapolate=True)``) and goes
  through ``layers.sdpa``: on the card the bf16 flash kernels at D = 32
  (forward with lse and both backward kernels under autograd), or the fp32
  forward kernel; the plain version on the CPU.

The public functions take and return NHWC tensors, the JAX layout; inside,
the feature maps are NCHW, the layout of torch's convolutions, and the
channel norms reduce over dim 1. ``pixel_shuffle`` and ``pixel_unshuffle``
are torch's (the JAX NHWC versions reproduce their channel order).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch.models import layers as L


class Conv2d(nn.Conv2d):
    """``nn.Conv(dtype=...)``: fp32 parameters, input, weight and bias cast
    to the compute ``dtype``; "same" padding k // 2 as the Flax ``padding=1``
    of a 3x3."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, bias: bool = True,
                 groups: int = 1, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, bias=bias,
                         groups=groups)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                        self.dilation, self.groups)


class DCRMSNorm(nn.Module):
    """RMSNorm over the channels (dim 1 of NCHW, or the last dim of tokens)
    with a bias, eps 1e-5, in fp32, cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, channel_dim: int = 1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        d = self.channel_dim
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(d, keepdim=True) + self.eps)
        shape = [1] * x.dim()
        shape[d] = -1
        return (self.weight.view(shape) * xf + self.bias.view(shape)).to(x.dtype)


class ResBlock(nn.Module):
    """conv3x3, SiLU, conv3x3 (no bias), DCRMSNorm, residual (``DCResBlock``)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, dtype=dtype)
        self.conv2 = Conv2d(channels, channels, 3, bias=False, dtype=dtype)
        self.norm = DCRMSNorm(channels)

    def forward(self, x):
        return self.norm(self.conv2(F.silu(self.conv1(x)))) + x


class GLUMBConv(nn.Module):
    """SANA's gated inverted-residual conv at expand ratio 4: 1x1 to 2 x
    hidden, SiLU, depthwise 3x3, h * SiLU(gate), 1x1 back (no bias),
    DCRMSNorm, residual."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        hidden = 4 * channels
        self.conv_inverted = Conv2d(channels, 2 * hidden, 1, dtype=dtype)
        self.conv_depth = Conv2d(2 * hidden, 2 * hidden, 3, groups=2 * hidden, dtype=dtype)
        self.conv_point = Conv2d(hidden, channels, 1, bias=False, dtype=dtype)
        self.norm = DCRMSNorm(channels)

    def forward(self, x):
        h, gate = self.conv_depth(F.silu(self.conv_inverted(x))).chunk(2, dim=1)
        return self.norm(self.conv_point(h * F.silu(gate))) + x


@functools.lru_cache(maxsize=32)
def _rope_table(head_dim: int, h: int, w: int):
    return L.precompute_rope_2d(head_dim, h, w, scale=1.0, extrapolate=True)


class Attention(nn.Module):
    """RoPE + qk-norm self-attention over the grid's tokens (the ``attn``
    of ``DCAttentionBlock``): qkv and proj without bias, the q/k RMSNorm
    over all heads' channels, the output through DCRMSNorm, residual."""

    def __init__(self, channels: int, head_dim: int = 32, dtype=torch.float32):
        super().__init__()
        self.head_dim = head_dim
        self.qkv = L.Linear(channels, 3 * channels, bias=False, dtype=dtype,
                            param_dtype=torch.float32)
        self.q_norm = L.RMSNorm(channels)
        self.k_norm = L.RMSNorm(channels)
        self.proj = L.Linear(channels, channels, bias=False, dtype=dtype,
                             param_dtype=torch.float32)
        self.norm_out = DCRMSNorm(channels, channel_dim=-1)

    def forward(self, tokens, h: int, w: int):
        """tokens (B, h * w, C), row-major over the grid."""
        b, n, c = tokens.shape
        heads, hd = c // self.head_dim, self.head_dim
        q, k, v = self.qkv(tokens).reshape(b, n, 3, heads, hd).unbind(2)
        cos, sin = (torch.from_numpy(t).to(tokens.device) for t in _rope_table(hd, h, w))
        q, k = L.apply_rope(q, k, (cos, sin))
        q = self.q_norm(q.reshape(b, n, c)).reshape(b, n, heads, hd)
        k = self.k_norm(k.reshape(b, n, c)).reshape(b, n, heads, hd)
        o = L.sdpa(q, k, v).reshape(b, n, c)
        return self.norm_out(self.proj(o)) + tokens


class AttentionBlock(nn.Module):
    """``DCAttentionBlock``: :class:`Attention` over the tokens, then
    :class:`GLUMBConv` over the grid."""

    def __init__(self, channels: int, head_dim: int = 32, dtype=torch.float32):
        super().__init__()
        self.attn = Attention(channels, head_dim, dtype)
        self.conv_out = GLUMBConv(channels, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.attn(x.flatten(2).transpose(1, 2), h, w)
        return self.conv_out(tokens.transpose(1, 2).reshape(b, c, h, w))


class DownBlock(nn.Module):
    """conv3x3 to out/4 then pixel-unshuffle x2, plus the channel-mean of the
    unshuffled input (``DCDownBlock`` as every DC-AE config builds it)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.out_ch = out_ch
        self.conv = Conv2d(in_ch, out_ch // 4, 3, dtype=dtype)

    def forward(self, x):
        y = F.pixel_unshuffle(x, 2)
        b, c, hh, ww = y.shape
        return (F.pixel_unshuffle(self.conv(x), 2)
                + y.view(b, self.out_ch, c // self.out_ch, hh, ww).mean(2))


class UpBlock(nn.Module):
    """conv3x3 to 4 x out then pixel-shuffle x2, plus the channel-repeated
    input pixel-shuffled (``DCUpBlock`` as every DC-AE config builds it)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.out_ch = out_ch
        self.conv = Conv2d(in_ch, 4 * out_ch, 3, dtype=dtype)

    def forward(self, x):
        y = x.repeat_interleave(4 * self.out_ch // x.shape[1], dim=1)
        return F.pixel_shuffle(self.conv(x), 2) + F.pixel_shuffle(y, 2)


def _stage_block(channels: int, attention: bool, head_dim: int, dtype):
    if attention:
        return AttentionBlock(channels, head_dim, dtype)
    return ResBlock(channels, dtype)


class DCAEDecoder(nn.Module):
    """Latent (B, h, w, latent) -> image (B, 32h, 32w, out) NHWC: conv_in with
    the channel-repeat shortcut, the stages from the top down (each below
    the top opens with its :class:`UpBlock`), and with ``head`` the
    diffusers head (DCRMSNorm, ReLU, conv_out); without it the
    ``block_out_channels[0]``-wide feature map."""

    def __init__(self, latent_channels: int = 32, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512, 1024, 1024),
                 layers_per_block: Sequence[int] = (3, 3, 3, 3, 3, 3),
                 attention_stages: Sequence[bool] = (False, False, False, True, True, True),
                 attention_head_dim: int = 32, head: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.latent_channels = latent_channels
        self.dtype = dtype
        num = len(block_out_channels)
        top = block_out_channels[-1]
        self.conv_in = Conv2d(latent_channels, top, 3, dtype=dtype)
        stages = []
        for i in range(num):
            ch = block_out_channels[i]
            blocks = []
            if i < num - 1 and layers_per_block[i] > 0:
                blocks.append(UpBlock(block_out_channels[i + 1], ch, dtype=dtype))
            blocks += [_stage_block(ch, attention_stages[i], attention_head_dim, dtype)
                       for _ in range(layers_per_block[i])]
            stages.append(nn.Sequential(*blocks))
        self.up_blocks = nn.ModuleList(stages)
        self.norm_out = self.conv_out = None
        if head:
            self.norm_out = DCRMSNorm(block_out_channels[0])
            self.conv_out = Conv2d(block_out_channels[0], out_channels, 3, dtype=dtype)

    def forward(self, z):
        z = z.permute(0, 3, 1, 2)
        h = self.conv_in(z)
        h = h + z.repeat_interleave(h.shape[1] // self.latent_channels, dim=1)
        for stage in reversed(self.up_blocks):
            h = stage(h)
        if self.conv_out is not None:
            h = self.conv_out(F.relu(self.norm_out(h)))
        return h.permute(0, 2, 3, 1)


class DCAEEncoder(nn.Module):
    """Image (B, H, W, 3) -> latent (B, H/32, W/32, latent) NHWC: conv_in, the
    stages (each below the top closing with its :class:`DownBlock`),
    conv_out with the channel-mean shortcut."""

    def __init__(self, latent_channels: int = 32,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512, 1024, 1024),
                 layers_per_block: Sequence[int] = (2, 2, 2, 3, 3, 3),
                 attention_stages: Sequence[bool] = (False, False, False, True, True, True),
                 attention_head_dim: int = 32, dtype=torch.float32):
        super().__init__()
        self.latent_channels = latent_channels
        num = len(block_out_channels)
        self.conv_in = Conv2d(3, block_out_channels[0], 3, dtype=dtype)
        stages = []
        for i in range(num):
            ch = block_out_channels[i]
            blocks = [_stage_block(ch, attention_stages[i], attention_head_dim, dtype)
                      for _ in range(layers_per_block[i])]
            if i < num - 1 and layers_per_block[i] > 0:
                blocks.append(DownBlock(ch, block_out_channels[i + 1], dtype=dtype))
            stages.append(nn.Sequential(*blocks))
        self.down_blocks = nn.ModuleList(stages)
        self.conv_out = Conv2d(block_out_channels[-1], latent_channels, 3, dtype=dtype)

    def forward(self, x):
        h = self.conv_in(x.permute(0, 3, 1, 2))
        for stage in self.down_blocks:
            h = stage(h)
        b, c, hh, ww = h.shape
        out = self.conv_out(h) + h.view(b, self.latent_channels, c // self.latent_channels, hh,
                                        ww).mean(2)
        return out.permute(0, 2, 3, 1)


def _blend(a, b, extent: int, dim: int):
    """Blend the end of tile ``a`` into the start of ``b`` along ``dim`` (1:
    rows, 2: columns of NHWC), linearly over ``extent`` pixels."""
    extent = min(a.shape[dim], b.shape[dim], extent)
    if extent <= 0:
        return b
    shape = [1, 1, 1, 1]
    shape[dim] = extent
    w = torch.from_numpy((np.arange(extent) / extent).reshape(shape)).to(b.device, b.dtype)
    head = a.narrow(dim, a.shape[dim] - extent, extent) * (1 - w) + b.narrow(dim, 0, extent) * w
    return torch.cat([head, b.narrow(dim, extent, b.shape[dim] - extent)], dim=dim)


def tiled_apply(fn, x, tile: int, stride: int, scale: float):
    """``fn`` over overlapping ``tile`` x ``tile`` tiles at ``stride`` of NHWC
    ``x``; the outputs (``scale`` x the input size) are seam-blended with
    the tile above, then with the raw tile to the left (diffusers), cropped
    to the stride grid and joined (``deco_tpu`` ``tiled_apply``)."""
    _, h, w, _ = x.shape
    out_tile, out_stride = int(tile * scale), int(stride * scale)
    blend = out_tile - out_stride
    rows = [[fn(x[:, i:i + tile, j:j + tile]) for j in range(0, w, stride)]
            for i in range(0, h, stride)]
    joined = []
    for i, row in enumerate(rows):
        out_row = []
        for j, t in enumerate(row):
            if i > 0:
                t = _blend(rows[i - 1][j], t, blend, 1)
            if j > 0:
                t = _blend(row[j - 1], t, blend, 2)
            out_row.append(t[:, :out_stride, :out_stride])
        joined.append(torch.cat(out_row, dim=2))
    return torch.cat(joined, dim=1)[:, :int(h * scale), :int(w * scale)]


class AutoencoderDC(nn.Module):
    """The DC-AE: ``encode`` to f32c32 latents and ``decode`` back, NHWC, with
    per-side stage geometry (the published Sana shapes by default)."""

    def __init__(self, latent_channels: int = 32, dtype=torch.float32,
                 encoder_block_out_channels: Sequence[int] = (128, 256, 512, 512, 1024, 1024),
                 encoder_layers_per_block: Sequence[int] = (2, 2, 2, 3, 3, 3),
                 encoder_attention_stages: Sequence[bool] = (False, False, False, True, True,
                                                             True),
                 decoder_block_out_channels: Sequence[int] = (128, 256, 512, 512, 1024, 1024),
                 decoder_layers_per_block: Sequence[int] = (3, 3, 3, 3, 3, 3),
                 decoder_attention_stages: Sequence[bool] = (False, False, False, True, True,
                                                             True),
                 attention_head_dim: int = 32, decoder_head: bool = True, device="cuda"):
        super().__init__()
        from deco_tpu_torch._device import resolve_device

        with resolve_device(device):
            self.encoder = DCAEEncoder(latent_channels, encoder_block_out_channels,
                                       encoder_layers_per_block, encoder_attention_stages,
                                       attention_head_dim, dtype=dtype)
            self.decoder = DCAEDecoder(latent_channels, 3, decoder_block_out_channels,
                                       decoder_layers_per_block, decoder_attention_stages,
                                       attention_head_dim, head=decoder_head, dtype=dtype)
        # a stage resamples when it is below the top and has blocks
        self.spatial_compression = 2 ** sum(
            1 for n in encoder_layers_per_block[:-1] if n > 0)
        self.decoder_expansion = 2 ** sum(1 for n in decoder_layers_per_block[:-1] if n > 0)

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)

    def tiled_encode(self, x, tile_sample: int = 512, tile_stride: int = 448):
        return tiled_apply(self.encoder, x, tile_sample, tile_stride,
                           1.0 / self.spatial_compression)

    def tiled_decode(self, z, tile_latent: int = 16, tile_stride: int = 14):
        return tiled_apply(self.decoder, z, tile_latent, tile_stride,
                           float(self.decoder_expansion))

    def forward(self, x):
        return self.decode(self.encode(x))
