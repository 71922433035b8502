"""ImageNet-style folder datasets with the ADM center crop
(``deco_tpu/data/imagenet.py``).

The crop (repeated halving with a BOX filter while the short side is at
least twice the resolution, one BICUBIC resize of the short side to the
resolution, a center crop) decides FID parity. The JAX package runs it in
PIL or in ``native/libdataplane.so``; the port has no PIL, so
:func:`resample` is a numpy copy of PIL's 8-bit convolution resampler:
per output pixel a clamped window of normalized filter weights, the weights
in 22-bit fixed point, a horizontal pass rounded to a uint8 image, then a
vertical pass. Each pass is one dense (out x in) weight matrix applied with
``np.matmul`` in float64, which holds the fixed-point sums exactly, so the
result equals PIL's.

Images are read with :mod:`deco_tpu_torch.utils.png` (``.png``) or the
native library (``.jpg``/``.jpeg``, decode and crop in one call); other
formats raise. Items are NHWC float32 in [-1, 1] with
``metadata['raw_image']`` the [0, 1] image; :class:`LocalCachedDataset`
gives VAE latents sampled from a cache of ``.npz`` posteriors instead.
"""

from __future__ import annotations

import math
import os

import numpy as np

from deco_tpu_torch.data import native
from deco_tpu_torch.utils import png

IMG_EXTS = (".png", ".jpg", ".jpeg", ".JPEG", ".JPG", ".PNG", ".bmp", ".webp")
_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit images


def _box(x: np.ndarray) -> np.ndarray:
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {"box": (_box, 0.5), "bicubic": (_bicubic, 2.0)}


def _weights(in_size: int, out_size: int, kind: str) -> np.ndarray:
    """(out_size, in_size) float64 matrix of PIL's fixed-point weights."""
    fn, support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    inv = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # PIL truncates toward zero (C int casts) before clamping
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64)
    taps = np.arange(ksize)
    valid = taps[None, :] < (xmax - xmin)[:, None]
    w = np.where(valid, fn((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * inv), 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    matrix = np.zeros((out_size, in_size), np.float64)
    rows = np.repeat(np.arange(out_size), ksize).reshape(out_size, ksize)
    cols = xmin[:, None] + taps[None, :]
    matrix[rows[valid], cols[valid]] = fixed[valid]
    return matrix


def _round_fixed(acc: np.ndarray) -> np.ndarray:
    """PIL's ``clip8((sum + 2^21) >> 22)`` on exact float64 sums."""
    half = float(1 << (_PRECISION_BITS - 1))
    return np.clip(np.floor((acc + half) / float(1 << _PRECISION_BITS)), 0, 255).astype(np.uint8)


def resample(image: np.ndarray, out_w: int, out_h: int, kind: str = "bicubic") -> np.ndarray:
    """PIL ``Image.resize((out_w, out_h), BOX | BICUBIC)`` of an (H, W, C)
    uint8 image. A pass whose size does not change is skipped, as PIL does."""
    image = np.asarray(image, np.uint8)
    h, w, c = image.shape
    out = image
    if out_w != w:
        # (out_w, w) along W for every row and channel, as one GEMM
        cols = out.transpose(1, 0, 2).reshape(w, h * c).astype(np.float64)
        out = _round_fixed(np.matmul(_weights(w, out_w, kind), cols))
        out = out.reshape(out_w, h, c).transpose(1, 0, 2)
    if out_h != h:
        mv = _weights(h, out_h, kind)  # (out_h, h) applied along H
        flat = out.reshape(h, out_w * c).astype(np.float64)
        out = _round_fixed(np.matmul(mv, flat)).reshape(out_h, out_w, c)
    return out


def resize_short_side(image: np.ndarray, resolution: int) -> np.ndarray:
    """PIL ``resize((round(w * s), round(h * s)), BICUBIC)`` of an (H, W, C)
    uint8 image, with s = resolution / its short side."""
    h, w = image.shape[:2]
    scale = resolution / min(h, w)
    return resample(image, round(w * scale), round(h * scale), "bicubic")


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    y0 = (image.shape[0] - size) // 2
    x0 = (image.shape[1] - size) // 2
    return image[y0:y0 + size, x0:x0 + size]


def adm_center_crop(image: np.ndarray, image_size: int) -> np.ndarray:
    """ADM/guided-diffusion center crop of an (H, W, 3) uint8 image."""
    arr = np.asarray(image, np.uint8)
    while min(arr.shape[0], arr.shape[1]) >= 2 * image_size:
        arr = resample(arr, arr.shape[1] // 2, arr.shape[0] // 2, "box")
    return center_crop(resize_short_side(arr, image_size), image_size)


def read_png(path: str) -> np.ndarray:
    """A PNG file as (H, W, 3) uint8 RGB. JPEG is read only through the
    native library's decode-and-crop (:func:`PixImageNet._load_center_cropped`),
    which exposes no full-size decode, so a JPEG path raises, as do other
    formats."""
    if path.lower().endswith(".png"):
        return png.read(path)
    if path.lower().endswith((".jpg", ".jpeg")):
        raise NotImplementedError(
            f"{path}: a full-size JPEG decode is not ported to deco_tpu_torch (the native "
            "library decodes JPEG only behind the ADM crop): ROADMAP §A 2")
    raise ValueError(f"{path}: the port reads PNG and JPEG images only")


def _scan_image_folder(root: str):
    """ImageFolder-compatible scan: sorted class dirs -> (path, class_idx)."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        for dirpath, _, files in sorted(os.walk(os.path.join(root, c))):
            for f in sorted(files):
                if f.endswith(IMG_EXTS):
                    samples.append((os.path.join(dirpath, f), class_to_idx[c]))
    return samples, classes


class PixImageNet:
    """Pixel-space ImageNet folder: ADM crop -> [-1, 1] NHWC.

    ``random_crop`` resizes the short side to the resolution and takes a
    random square, then flips at random; ``random_flip`` flips the center
    crop at random. The draws come from ``RandomState(seed)`` in the JAX
    order (y0, x0, flip).
    """

    def __init__(self, root: str, resolution: int = 256, random_crop: bool = False,
                 random_flip: bool = False, seed: int = 0):
        self.samples, self.classes = _scan_image_folder(root)
        self.resolution = resolution
        self.random_crop = random_crop
        self.random_flip = random_flip
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.samples)

    def _load_center_cropped(self, path: str) -> np.ndarray:
        if path.lower().endswith((".jpg", ".jpeg")):
            with open(path, "rb") as f:
                return native.decode_jpeg_adm(f.read(), self.resolution)
        return adm_center_crop(read_png(path), self.resolution)

    def __getitem__(self, idx: int):
        path, target = self.samples[idx]
        if self.random_crop:
            arr = resize_short_side(read_png(path), self.resolution)
            max_y = arr.shape[0] - self.resolution
            max_x = arr.shape[1] - self.resolution
            y0 = self._rng.randint(0, max_y + 1) if max_y > 0 else 0
            x0 = self._rng.randint(0, max_x + 1) if max_x > 0 else 0
            arr = arr[y0:y0 + self.resolution, x0:x0 + self.resolution]
            if self._rng.rand() < 0.5:
                arr = arr[:, ::-1]
        else:
            arr = self._load_center_cropped(path)
            if self.random_flip and self._rng.rand() < 0.5:
                arr = arr[:, ::-1]
        raw = arr.astype(np.float32) / 255.0  # [0, 1] HWC
        x = raw * 2.0 - 1.0
        return x, target, {"raw_image": raw, "class": target}


class LocalCachedDataset(PixImageNet):
    """:class:`PixImageNet` with a precomputed VAE-latent cache
    (``deco_tpu/data/imagenet.py`` ``LocalCachedDataset``): the latent of
    ``<image path>`` is ``<the same path under cache_root>.npz`` with
    ``mean`` and ``logvar`` arrays, sampled at each read as mean + std *
    ``RandomState(seed)`` normal draws (logvar clipped to [-30, 20]).
    Without ``cache_root`` the item is the [0, 1] ADM crop itself.
    ``metadata['raw_image']`` is the crop in either case."""

    def __init__(self, root: str, resolution: int = 256, cache_root: str | None = None,
                 seed: int = 0):
        super().__init__(root, resolution=resolution, seed=seed)
        self.root = root
        self.cache_root = cache_root

    def __getitem__(self, idx: int):
        path, target = self.samples[idx]
        raw = self._load_center_cropped(path).astype(np.float32) / 255.0
        latent = raw
        if self.cache_root is not None:
            with np.load(path.replace(self.root, self.cache_root) + ".npz") as pk:
                mean = pk["mean"].astype(np.float32)
                logvar = np.clip(pk["logvar"].astype(np.float32), -30.0, 20.0)
            noise = self._rng.randn(*mean.shape).astype(np.float32)
            latent = mean + noise * np.exp(0.5 * logvar)
        return latent, target, {"raw_image": raw, "class": target}
