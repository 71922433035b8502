"""Perceptual losses: VGG16-LPIPS and the ConvNeXt-S logit MSE
(``deco_tpu/models/perceptual.py``).

Inputs are NHWC images in [0, 1]; everything runs in fp32, frozen. The
parameter names are torchvision's (``features.{i}`` of ``vgg16`` and of
``convnext_small``, ``classifier.{0,2}``) and LPIPS's (``lin{k}.model.1``),
the layouts the JAX package's ``vgg16_params_from_torch`` and
``convnext_s_params_from_torch`` read, so those state dicts load with
``load_state_dict`` (:class:`PerceptualLoss` takes them). No pretrained file
is in the repository: without one a tower is drawn at random from a seeded
generator (the Flax initializers' distributions) with a warning, as the JAX
package does, and its losses do not compare with the published setup.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch.models import layers as L
from deco_tpu_torch.models.vae_models import resize_bilinear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# LPIPS input scaling (its ScalingLayer)
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# the convolutions (0-based, counted over VGG16_CFG's numbers) after whose
# ReLU LPIPS taps: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
VGG_TAPS = (1, 3, 6, 9, 12)
VGG_TAP_CHANNELS = (64, 128, 256, 512, 512)
CONVNEXT_S_DEPTHS = (3, 3, 27, 3)
CONVNEXT_S_DIMS = (96, 192, 384, 768)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _vgg16_features() -> nn.Sequential:
    """torchvision's ``vgg16().features``: conv3x3 + ReLU, max pools."""
    layers, ch = [], 3
    for v in VGG16_CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(ch, v, 3, padding=1), nn.ReLU()]
            ch = v
    return nn.Sequential(*layers)


class _LinLayer(nn.Module):
    """LPIPS's ``NetLinLayer``: (dropout, 1x1 conv to one channel, no bias);
    the dropout is the identity at evaluation."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """VGG-LPIPS: the five taps unit-normalised over channels, squared
    differences, a 1x1 linear head each, spatial mean, summed; (B,)."""

    def __init__(self):
        super().__init__()
        self.features = _vgg16_features()
        for i, ch in enumerate(VGG_TAP_CHANNELS):
            setattr(self, f"lin{i}", _LinLayer(ch))
        self.register_buffer("shift", torch.from_numpy(LPIPS_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.from_numpy(LPIPS_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def taps(self, x):
        """The five tap activations of NCHW ``x``."""
        out, conv = [], 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                if conv in VGG_TAPS:
                    out.append(x)
                    if len(out) == len(VGG_TAPS):
                        return out
                conv += 1
        return out

    def forward(self, input01, target01):
        def prep(img):
            return (_nchw(img.float()) * 2.0 - 1.0 - self.shift) / self.scale

        total = 0.0
        for i, (a, b) in enumerate(zip(self.taps(prep(input01)), self.taps(prep(target01)))):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
            lin = getattr(self, f"lin{i}").model[1]((a - b) ** 2)
            total = total + lin.mean(dim=(1, 2, 3))
        return total


class ConvNeXtBlock(nn.Module):
    """torchvision's ``CNBlock``: depthwise 7x7, LayerNorm, linear to 4 dim,
    GELU, linear back, times ``layer_scale``, residual. ``block`` keeps
    torchvision's indices (0 conv, 2 norm, 3 and 5 linears)."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(dim, dim, 7, padding=3, groups=dim), nn.Identity(),
                                   L.LayerNorm(dim, eps=1e-6), nn.Linear(dim, 4 * dim),
                                   nn.GELU(), nn.Linear(4 * dim, dim))
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), 1e-6))

    def forward(self, x):
        """NHWC in and out."""
        blk = self.block
        h = blk[5](F.gelu(blk[3](blk[2](_nhwc(blk[0](_nchw(x)))))))
        return x + self.layer_scale.reshape(-1) * h


class ConvNeXtS(nn.Module):
    """ConvNeXt-Small classifier (depths 3, 3, 27, 3; widths 96-768) in
    torchvision's layout: NHWC (B, H, W, 3) -> logits (B, num_classes).
    torchvision's ``LayerNorm2d`` over the channels is a LayerNorm over the
    last dim here, the maps being NHWC."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        d = CONVNEXT_S_DIMS
        features = [nn.Sequential(nn.Conv2d(3, d[0], 4, stride=4), L.LayerNorm(d[0], eps=1e-6))]
        for si, (depth, dim) in enumerate(zip(CONVNEXT_S_DEPTHS, d)):
            if si > 0:
                features.append(nn.Sequential(L.LayerNorm(d[si - 1], eps=1e-6),
                                              nn.Conv2d(d[si - 1], dim, 2, stride=2)))
            features.append(nn.Sequential(*(ConvNeXtBlock(dim) for _ in range(depth))))
        self.features = nn.Sequential(*features)
        self.classifier = nn.Sequential(L.LayerNorm(d[-1], eps=1e-6), nn.Flatten(1),
                                        nn.Linear(d[-1], num_classes))

    def forward(self, x):
        f = self.features
        x = f[0][1](_nhwc(f[0][0](_nchw(x.float()))))
        for i in range(1, len(f)):
            if i % 2 == 0:  # a downsampling layer: LayerNorm, then the 2x2 conv
                x = _nhwc(f[i][1](_nchw(f[i][0](x))))
            else:
                x = f[i](x)
        return self.classifier[2](self.classifier[0](x.mean(dim=(1, 2))))


@torch.no_grad()
def _init_like_flax_(module: nn.Module, gen: torch.Generator) -> None:
    """Flax's defaults: lecun-normal (truncated) kernels over their fan-in,
    zero biases, unit norm scales; LPIPS's heads uniform on [0, 0.1) and
    ConvNeXt's layer scale 1e-6."""
    for name, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            if isinstance(m, L.LayerNorm):
                p.fill_(1.0 if pname == "weight" else 0.0)
            elif pname == "bias":
                p.zero_()
            elif pname == "layer_scale":
                p.fill_(1e-6)
            elif name.startswith("lin"):
                p.copy_(torch.rand(p.shape, generator=gen) * 0.1)
            else:
                std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
                r = torch.empty(p.shape)
                nn.init.trunc_normal_(r, 0.0, std, -2 * std, 2 * std, generator=gen)
                p.copy_(r)


class PerceptualLoss(nn.Module):
    """The ``"lpips-convnext_s-w1-w2"`` combination: (w1 LPIPS + w2 the
    ConvNeXt-S logit MSE) / (w1 + w2), a (B,) loss of (input01, target01).

    ``lpips_state`` (torchvision ``vgg16`` ``features.*`` and LPIPS ``lin*``
    keys) and ``convnext_state`` (torchvision ``convnext_small``) load the
    published towers; without them each is drawn from ``seed`` with a
    warning. The towers are frozen (no parameter requires grad); gradients
    flow through them to the inputs. The ConvNeXt input is resized to 224 px
    (bilinear, antialiased) and normalised with the ImageNet statistics.
    """

    def __init__(self, model_name: str = "lpips-convnext_s-1.0-0.1",
                 lpips_state: Optional[dict] = None, convnext_state: Optional[dict] = None,
                 seed: int = 0, device="cuda"):
        super().__init__()
        from deco_tpu_torch._device import resolve_device

        self.use_lpips = "lpips" in model_name
        self.use_convnext = "convnext_s" in model_name
        self.w_lpips = self.w_convnext = 1.0
        if self.use_lpips and self.use_convnext:
            self.w_lpips, self.w_convnext = (float(v) for v in model_name.split("-")[-2:])
        gen = torch.Generator().manual_seed(seed)
        self.lpips = self.convnext = None
        if self.use_lpips:
            self.lpips = LPIPS()
            if lpips_state is None:
                _init_like_flax_(self.lpips, gen)
                warnings.warn("LPIPS running with random weights (no pretrained VGG in this "
                              "environment); loss values are not comparable to the published "
                              "setup.")
            else:
                self.lpips.load_state_dict(lpips_state)
        if self.use_convnext:
            self.convnext = ConvNeXtS()
            if convnext_state is None:
                _init_like_flax_(self.convnext, gen)
                warnings.warn("ConvNeXt-S running with random weights.")
            else:
                self.convnext.load_state_dict(convnext_state)
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD), persistent=False)
        self.requires_grad_(False)
        self.to(resolve_device(device)).eval()

    def forward(self, input01, target01):
        loss, denom = 0.0, 0.0
        if self.lpips is not None:
            loss = loss + self.w_lpips * self.lpips(input01, target01)
            denom += self.w_lpips
        if self.convnext is not None:
            def norm(img):
                return (resize_bilinear(img.float(), 224, 224) - self.mean) / self.std

            c = ((self.convnext(norm(input01)) - self.convnext(norm(target01))) ** 2).mean()
            loss = loss + self.w_convnext * c
            denom += self.w_convnext
        return loss / denom
