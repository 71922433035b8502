"""InceptionV3 pool3 features for FID (``deco_tpu/models/inception.py``).

:class:`InceptionV3Features` takes [0, 1] NHWC images and returns the
globally averaged activations at one of the FID taps (64, 192, 768 or
2048). Its module names are the torchvision / pytorch-fid state-dict keys
(``Mixed_5b.branch1x1.conv.weight``, ``...bn.running_var``), so a
pytorch-fid ``.pt``/``.pth`` (``pt_inception-2015-12-05``) loads as it is
through :func:`load_inception`, which skips ``AuxLogits.*``, ``fc.*`` and
``num_batches_tracked`` as ``inception_params_from_torch`` walks past them.
No weights ship with the repository and none are downloaded; without a file
the tower is drawn from a seed (:func:`random_inception`), and its FIDs
compare only with each other.

``fid_variant=True`` (default) is the TF-ported FID tower: TF1-legacy
bilinear resize to 299 (no half-pixel shift), ``(255 x - 128) / 128``,
padding-excluding branch average pools and a max branch pool in Mixed_7c.
``fid_variant=False`` is torchvision's ``inception_v3`` graph: half-pixel
bilinear (``F.interpolate``, no antialias), ``2 x - 1``, average pools that
count the padding.

Every convolution is followed by an eval-mode BatchNorm (eps 1e-3) and a
ReLU. The forward runs its convolutions in fp32 with TF32 off, so a card
computes what the CPU computes to fp32 rounding.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deco_tpu_torch._device import resolve_device

FEATURE_DIMS = (64, 192, 768, 2048)


class BatchNorm(nn.Module):
    """Eval-mode batch norm: the four tensors of a torchvision
    ``BatchNorm2d`` (no ``num_batches_tracked``) and its running statistics
    always."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class ConvBN(nn.Module):
    """Conv (no bias) + eval-mode BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _branch_avg_pool(x, fid_variant: bool):
    """3x3/1 average pool; the FID tower leaves the zero padding out of the divisor."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not fid_variant)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid_variant: bool):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = ConvBN(cin, 64, 1)
        self.branch5x5_1 = ConvBN(cin, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_branch_avg_pool(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid_variant: bool):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = ConvBN(cin, 192, 1)
        self.branch7x7_1 = ConvBN(cin, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_branch_avg_pool(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``max_pool_branch``: the FID tower's last block (Mixed_7c) pools its
    branch with a max pool, a quirk of the original TF graph."""

    def __init__(self, cin: int, fid_variant: bool, max_pool_branch: bool = False):
        super().__init__()
        self.fid_variant = fid_variant
        self.max_pool_branch = max_pool_branch
        self.branch1x1 = ConvBN(cin, 320, 1)
        self.branch3x3_1 = ConvBN(cin, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        if self.max_pool_branch:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _branch_avg_pool(x, self.fid_variant)
        return torch.cat([self.branch1x1(x), self.branch3x3_2a(b3), self.branch3x3_2b(b3),
                          self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
                          self.branch_pool(bp)], dim=1)


def tf1_bilinear_resize(x, out_h: int, out_w: int):
    """TF1-legacy bilinear resize of (B, H, W, C): source coordinate
    ``i * in / out`` (no half-pixel centres, the last source row repeated
    past the edge), one 1-D lerp per spatial axis, in fp32."""

    def lerp_axis(v, axis: int, out_size: int):
        in_size = v.shape[axis]
        coord = torch.arange(out_size, dtype=torch.float32, device=v.device) * (in_size / out_size)
        lo = torch.clamp(torch.floor(coord).long(), 0, in_size - 1)
        hi = torch.clamp(lo + 1, max=in_size - 1)
        shape = [1] * v.dim()
        shape[axis] = out_size
        frac = (coord - lo.float()).reshape(shape)
        a, b = v.index_select(axis, lo), v.index_select(axis, hi)
        return a + (b - a) * frac

    return lerp_axis(lerp_axis(x.float(), 1, out_h), 2, out_w)


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in fp32 for the block: TF32 (on by default in
    PyTorch) would round their inputs to 10 mantissa bits on the card."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class InceptionV3Features(nn.Module):
    """[0, 1] NHWC images -> (B, ``feature_dim``) FID features.

    ``feature_dim`` picks the tap (pytorch-fid's ``BLOCK_INDEX_BY_DIM``): 64
    after the first max pool, 192 after the second, 768 after Mixed_6e,
    2048 the final pool3; each is averaged over H and W.
    """

    def __init__(self, fid_variant: bool = True, feature_dim: int = 2048):
        super().__init__()
        if feature_dim not in FEATURE_DIMS:
            raise ValueError(f"feature_dim {feature_dim} is not a FID tap (choose 64, 192, 768 "
                             "or 2048)")
        self.fid_variant = fid_variant
        self.feature_dim = feature_dim
        fid = fid_variant
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, fid)
        self.Mixed_7c = InceptionE(2048, fid, max_pool_branch=fid)

    def forward(self, x01):
        with fp32_convolutions():
            return self._features(x01)

    def _features(self, x01):
        """The tower at whatever convolution precision is set."""
        x01 = x01.float()
        if self.fid_variant:
            x = (tf1_bilinear_resize(x01, 299, 299) * 255.0 - 128.0) / 128.0
            x = x.permute(0, 3, 1, 2)
        else:
            x = F.interpolate(x01.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=False) * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        if self.feature_dim == 64:
            return x.mean(dim=(2, 3))
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, stride=2)
        if self.feature_dim == 192:
            return x.mean(dim=(2, 3))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        if self.feature_dim == 768:
            return x.mean(dim=(2, 3))
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        return x.mean(dim=(2, 3))


def inception_state_dict(sd: dict) -> dict:
    """The tensors of a torchvision / pytorch-fid InceptionV3 state dict that
    the feature tower has: the ``AuxLogits.*`` and ``fc.*`` heads and the
    BatchNorms' ``num_batches_tracked`` are left out."""
    return {k: v for k, v in sd.items()
            if not k.startswith(("AuxLogits.", "fc.")) and not k.endswith("num_batches_tracked")}


def load_inception(path: str, device="cuda", fid_variant: bool = True,
                   feature_dim: int = 2048) -> InceptionV3Features:
    """The tower with the weights of a torch state-dict file (``.pt``, ``.pth``,
    ``.bin``; pytorch-fid or torchvision layout), in eval mode on ``device``."""
    if not path.endswith((".pt", ".pth", ".bin")):
        raise ValueError(
            f"{path}: the port reads InceptionV3 weights from a torch state dict (.pt, .pth, "
            ".bin) only, not from a flax msgpack snapshot; save the torchvision or pytorch-fid "
            "state dict instead")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    tower = InceptionV3Features(fid_variant=fid_variant, feature_dim=feature_dim)
    tower.load_state_dict(inception_state_dict(sd), strict=True)
    return tower.eval().to(resolve_device(device))


def random_inception(seed: int = 0, device="cuda", fid_variant: bool = True,
                     feature_dim: int = 2048) -> InceptionV3Features:
    """A tower drawn from ``seed`` by numpy's generator on the host:
    He-normal convolutions (std sqrt(2 / fan_in), which keeps the
    activations' scale through the ReLUs), BatchNorm as the identity (scale
    1, shift 0, mean 0, variance 1). Its FIDs compare only with FIDs of the
    same tower; they are not the JAX package's random tower (another
    generator) nor comparable to published numbers."""
    warnings.warn("FID with a randomly drawn Inception tower: values are self-consistent "
                  "but not comparable to published FIDs")
    tower = InceptionV3Features(fid_variant=fid_variant, feature_dim=feature_dim)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for module in tower.modules():
            if isinstance(module, nn.Conv2d):
                w = module.weight
                draw = rng.standard_normal(tuple(w.shape), dtype=np.float32)
                w.copy_(torch.from_numpy(draw) * (2.0 / w[0].numel()) ** 0.5)
    return tower.eval().to(resolve_device(device))


@torch.no_grad()
def compute_fid_features(images01, tower: InceptionV3Features, batch_size: int = 64) -> np.ndarray:
    """(N, feature_dim) float32 features of [0, 1] NHWC images (a numpy
    array), ``batch_size`` at a time on the tower's device."""
    device = next(tower.parameters()).device
    outs = []
    for i in range(0, len(images01), batch_size):
        batch = torch.from_numpy(np.asarray(images01[i:i + batch_size], np.float32))
        outs.append(tower(batch.to(device)).cpu().numpy())
    return np.concatenate(outs, axis=0)
