"""The patch discriminator of the VAE-GAN (``deco_tpu/models/gan/discriminator.py``).

TF-style "SAME" convolutions (the pad computed from the input size,
asymmetric at stride 2), blur-kernel downsampling ((1, 3, 3, 1) by
default), GroupNorm(32) and LeakyReLU(0.1) stages, an adaptive max pool to
16 x 16 and a conv head to one logit channel. fp32, as in JAX. Parameter
names are the reference torch layout that the JAX package's
``convert_discriminator`` reads: ``block_in.0``, ``blocks.{i}.0`` (conv) and
``blocks.{i}.2`` (GroupNorm), ``to_logits.0`` and ``to_logits.2``. Inputs
are NHWC images in [0, 1]; the output is (B, 16, 16, 1) NHWC.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BLUR_KERNEL_MAP = {3: (1, 2, 1), 4: (1, 3, 3, 1), 5: (1, 4, 6, 4, 1)}


def _same_pad(size: int, kernel: int, stride: int) -> tuple:
    pad = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, kernel: int, stride: int):
    """NCHW ``x`` padded as TF's "SAME" (``_same_pad``) for ``kernel`` at ``stride``."""
    top, bottom = _same_pad(x.shape[2], kernel, stride)
    left, right = _same_pad(x.shape[3], kernel, stride)
    return F.pad(x, (left, right, top, bottom))


class ConvSame(nn.Conv2d):
    """A stride-1 convolution over the "SAME"-padded input."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__(in_ch, out_ch, kernel)

    def forward(self, x):
        return super().forward(_pad_same(x, self.kernel_size[0], 1))


def blur_downsample(x, kernel=(1, 3, 3, 1)):
    """Depthwise blur with the outer product of ``kernel`` (normalised), at
    stride 2 over the "SAME"-padded NCHW input (reference BlurBlock)."""
    k1 = np.asarray(kernel, np.float32)
    k2 = np.outer(k1, k1)
    k2 /= k2.sum()
    c = x.shape[1]
    weight = torch.from_numpy(k2).to(x.device, x.dtype).expand(c, 1, *k2.shape)
    return F.conv2d(_pad_same(x, len(kernel), 2), weight, stride=2, groups=c)


def adaptive_max_pool(x, out_hw: int = 16):
    """Flax's counterpart of AdaptiveMaxPool2d((16, 16)): windows of
    (H // 16, W // 16) at that stride (exact where 16 divides the size);
    inputs no larger than 16 pass unchanged."""
    h, w = x.shape[2:]
    if h <= out_hw and w <= out_hw:
        return x
    kh, kw = max(h // out_hw, 1), max(w // out_hw, 1)
    return F.max_pool2d(x, (kh, kw), stride=(kh, kw))


class GroupNorm(nn.GroupNorm):
    """Flax's ``nn.GroupNorm``: eps 1e-6 and the variance as E[x^2] - E[x]^2
    (clipped at 0) in fp32, differentiated through that formula as JAX does
    (torch's fused GroupNorm moved the adaptive GAN weight, which reads the
    discriminator's backward, by 2e-4 relative against JAX's)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__(num_groups, channels, eps=eps)

    def forward(self, x):
        b, c = x.shape[:2]
        xf = x.float().reshape(b, self.num_groups, -1)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.pow(2).mean(-1, keepdim=True) - mean.pow(2), min=0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    def __init__(self, hidden_channels: int = 128, num_stages: int = 3,
                 blur_resample: bool = True, blur_kernel_size: int = 4):
        super().__init__()
        self.blur_resample = blur_resample
        self.blur_kernel = BLUR_KERNEL_MAP[blur_kernel_size]
        # the reference's channel multipliers (1, 1, 2, 4, ...): the first
        # stage keeps the width
        mult = (1,) + tuple(2 ** t for t in range(num_stages))
        self.block_in = nn.Sequential(ConvSame(3, hidden_channels, 5))
        stages, ch = [], hidden_channels
        for i in range(num_stages):
            out = hidden_channels * mult[i + 1]
            stages.append(nn.Sequential(ConvSame(ch, out, 3), nn.Identity(), GroupNorm(32, out)))
            ch = out
        self.blocks = nn.ModuleList(stages)
        self.to_logits = nn.Sequential(ConvSame(ch, ch, 1), nn.Identity(), ConvSame(ch, 1, 5))

    def forward(self, x):
        """x: (B, H, W, 3) in [0, 1] -> (B, 16, 16, 1) logits."""
        def act(v):
            return F.leaky_relu(v, 0.1)

        h = act(self.block_in[0](x.float().permute(0, 3, 1, 2)))
        for conv, _, norm in self.blocks:
            h = conv(h)
            h = (blur_downsample(h, self.blur_kernel) if self.blur_resample
                 else F.avg_pool2d(h, 2))
            h = act(norm(h))
        h = adaptive_max_pool(h, 16)
        h = self.to_logits[2](act(self.to_logits[0](h)))
        return h.permute(0, 2, 3, 1)
