"""ImageNet-style folder datasets with the ADM center crop
(``deco_tpu/data/imagenet.py``).

The crop (repeated halving with a BOX filter while the short side is at
least twice the resolution, one BICUBIC resize of the short side to the
resolution, a center crop) decides FID parity. The JAX package runs it in
PIL or in its native data-plane library; the port has no PIL, so
:func:`resample` is a numpy copy of PIL's 8-bit convolution resampler:
per output pixel a clamped window of normalized filter weights, the weights
in 22-bit fixed point, a horizontal pass rounded to a uint8 image, then a
vertical pass. Each pass is one dense (out x in) weight matrix applied with
``np.matmul`` in float64, which holds the fixed-point sums exactly, so the
result equals PIL's.

Images are read by :func:`decode_image`: PNG of every kind with
:mod:`deco_tpu_torch.utils.png`, JPEG, WebP, GIF and BMP with the port's own
decoders (:mod:`deco_tpu_torch.data.jpeg`, ``webp``, ``gif``, ``bmp``), all
equal to PIL's ``convert("RGB")``; the other formats Pillow opens raise
naming ROADMAP §A 2e. Items are NHWC float32 in [-1, 1] with
``metadata['raw_image']`` the [0, 1] image; :class:`LocalCachedDataset`
gives VAE latents sampled from a cache of ``.npz`` posteriors instead.
:class:`PixHFDataset` reads a Hugging Face ``datasets`` split the same way.
"""

from __future__ import annotations

import math
import os

import numpy as np

from deco_tpu_torch.data import bmp, gif, ico, jpeg, pnm, qoi, webp
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


def _le32(data: bytes, at: int = 0) -> int:
    return int.from_bytes(data[at:at + 4], "little") if len(data) >= at + 4 else -1


# The formats Pillow 12.1 opens and decodes that the port does not decode,
# by the test of each plugin's ``_accept`` (or, where a plugin has none,
# the header its ``_open`` requires). TGA, SPIDER, IPTC and IMT carry no
# signature, so their bytes read as no image format; the stub plugins
# (BUFR, GRIB, HDF5, MPEG, WMF) open but cannot decode, so they raise
# ``ValueError`` as Pillow raises.
OTHER_FORMATS = (
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda d: d[:4] in (b"BLP1", b"BLP2")),
    ("DCX", lambda d: _le32(d) == 0x3ADE68B1),
    ("DDS", lambda d: d[:4] == b"DDS "),
    ("EPS", lambda d: d[:4] == b"%!PS" or _le32(d) == 0xC6D3D0C5),
    ("FITS", lambda d: d[:6] == b"SIMPLE"),
    ("FLI", lambda d: len(d) >= 16 and int.from_bytes(d[4:6], "little") in (0xAF11, 0xAF12)
     and int.from_bytes(d[14:16], "little") in (0, 3)),
    ("FTEX", lambda d: d[:4] == b"FTEX"),
    ("GBR", lambda d: len(d) >= 8 and int.from_bytes(d[:4], "big") >= 20
     and int.from_bytes(d[4:8], "big") in (1, 2)),
    ("ICNS", lambda d: d[:4] == b"icns"),
    ("IM", lambda d: d[:11] == b"Image type:"),
    ("JPEG2000", lambda d: d[:4] == b"\xff\x4f\xff\x51"
     or d[:12] == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"),
    ("MCIDAS", lambda d: d[:8] == b"\x00\x00\x00\x00\x00\x00\x00\x04"),
    ("MSP", lambda d: d[:4] in (b"DanM", b"LinS")),
    ("PCD", lambda d: d[2048:2052] == b"PCD_"),
    ("PCX", lambda d: len(d) >= 2 and d[0] == 10 and d[1] in (0, 2, 3, 5)),
    ("PIXAR", lambda d: d[:4] == b"\x80\xe8\x00\x00"),
    ("PSD", lambda d: d[:4] == b"8BPS"),
    ("SGI", lambda d: d[:2] == b"\x01\xda"),
    ("SUN", lambda d: d[:4] == b"\x59\xa6\x6a\x95"),
    ("TIFF", lambda d: d[:4] in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                                 b"MM\x00\x2b", b"II\x2b\x00")),
    ("XBM", lambda d: d[:16].lstrip().startswith(b"#define")),
    ("XPM", lambda d: d[:9] == b"/* XPM */"),
    ("XVTHUMB", lambda d: d[:6] == b"P7 332"),
)


DECODED = "PNG, JPEG, WebP, GIF, BMP, DIB, ICO, CUR, PNM or QOI"


def other_format(data: bytes):
    """The name of a format Pillow decodes and the port does not, or None."""
    return next((name for name, accepts in OTHER_FORMATS if accepts(data)), None)


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes as (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")`` gives
    them: PNG of every kind (any colour type, bit depth and interlace)
    through :mod:`deco_tpu_torch.utils.png`; JPEG of every kind Pillow reads
    (baseline, extended, progressive, arithmetic-coded, lossless) through
    :mod:`deco_tpu_torch.data.jpeg`; WebP (lossy, lossless, alpha, the first
    frame of an animation on its canvas), GIF (the first frame), BMP and
    DIB, ICO and CUR, PNM (P1-P6, Pf) and QOI through
    :mod:`~deco_tpu_torch.data.webp`, :mod:`~deco_tpu_torch.data.gif`,
    :mod:`~deco_tpu_torch.data.bmp`, :mod:`~deco_tpu_torch.data.ico`,
    :mod:`~deco_tpu_torch.data.pnm` and :mod:`~deco_tpu_torch.data.qoi`.
    What PIL refuses raises ``ValueError`` (PIL's ``OSError``), bytes of no
    image format too; a format PIL decodes and the port does not (TIFF,
    JPEG 2000, AVIF, ...: :data:`OTHER_FORMATS`) raises
    ``NotImplementedError`` naming ROADMAP §A 2e."""
    if data[:8] == png.SIGNATURE:
        return png.decode(data)
    if jpeg.is_jpeg(data):
        return jpeg.decode(data)
    if data[:4] == b"RIFF":
        if webp.is_webp(data):
            return webp.decode(data)
        raise ValueError("a RIFF file that is not a WebP image")
    if gif.is_gif(data):
        return gif.decode(data)
    if bmp.is_bmp(data):
        return bmp.decode(data)
    if bmp.is_dib(data):
        return bmp.decode_dib(data)
    if ico.is_ico(data) or ico.is_cur(data):
        return ico.decode(data)
    if pnm.is_pnm(data):
        return pnm.decode(data)
    if qoi.is_qoi(data):
        return qoi.decode(data)
    name = other_format(data)
    if name is not None:
        raise NotImplementedError(f"a {name} image: the port decodes {DECODED}: ROADMAP §A 2e")
    raise ValueError(f"not an image the port recognises (no {DECODED} signature)")


def read_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB (:func:`decode_image`)."""
    with open(path, "rb") as f:
        return decode_image(f.read())


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


def _crop_and_flip(ds, read_full, read_center_cropped):
    """The [0, 1] HWC crop of one image as :class:`PixImageNet` takes it:
    with ``random_crop`` the short side resized to the resolution and a
    random square of it, flipped at random; otherwise the ADM center crop,
    flipped at random under ``random_flip``. The draws come from ``ds._rng``
    in the JAX order (y0, x0, flip)."""
    res = ds.resolution
    if ds.random_crop:
        arr = resize_short_side(read_full(), res)
        max_y, max_x = arr.shape[0] - res, arr.shape[1] - res
        y0 = ds._rng.randint(0, max_y + 1) if max_y > 0 else 0
        x0 = ds._rng.randint(0, max_x + 1) if max_x > 0 else 0
        arr = arr[y0:y0 + res, x0:x0 + res]
        if ds._rng.rand() < 0.5:
            arr = arr[:, ::-1]
    else:
        arr = read_center_cropped()
        if ds.random_flip and ds._rng.rand() < 0.5:
            arr = arr[:, ::-1]
    return arr.astype(np.float32) / 255.0


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
        return adm_center_crop(read_image(path), self.resolution)

    def __getitem__(self, idx: int):
        path, target = self.samples[idx]
        raw = _crop_and_flip(self, lambda: read_image(path),
                             lambda: self._load_center_cropped(path))
        return raw * 2.0 - 1.0, target, {"raw_image": raw, "class": target}


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


class PixHFDataset:
    """A Hugging Face ``datasets`` split of images (and ``label``), through
    the ADM crop -> [-1, 1] NHWC (``deco_tpu/data/imagenet.py`` ``PixHFDataset``).

    Takes the arguments the ReCo configs pass, where the JAX class takes
    ``dataset_name``/``num_samples`` and raises on them (ROADMAP §C 10):
    ``root`` goes to ``datasets.load_dataset(root, split=split)`` as the JAX
    class's ``dataset_name`` does (a local dataset directory, an image folder
    with class subdirectories, or a hub name in the local cache);
    ``max_num_samples`` keeps the first n of ``RandomState(seed).permutation``,
    the JAX ``num_samples`` indices; ``random_crop``/``random_flip`` are
    :class:`PixImageNet`'s. ``datasets`` is imported here; without it the
    constructor raises ``ImportError``.

    The ``image`` column is read undecoded (the port has no PIL) and
    decoded by :func:`decode_image` (PNG, JPEG, WebP, GIF, BMP, equal to PIL's), then
    cropped by the numpy resampler. ``label`` (0 where absent) is the
    item's class.
    """

    def __init__(self, root: str, split: str = "train", resolution: int = 256,
                 max_num_samples: int | None = None, random_crop: bool = False,
                 random_flip: bool = False, seed: int = 0):
        try:
            import datasets
        except ImportError as err:
            raise ImportError(f"PixHFDataset({root!r}) needs the 'datasets' package, which is "
                              "not installed") from err
        ds = datasets.load_dataset(root, split=split)
        if max_num_samples is not None:
            ds = ds.select(np.random.RandomState(seed).permutation(len(ds))[:max_num_samples])
        self.ds = ds.cast_column("image", datasets.Image(decode=False))
        self.resolution = resolution
        self.random_crop = random_crop
        self.random_flip = random_flip
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.ds)

    @staticmethod
    def _bytes(image: dict) -> bytes:
        if image.get("bytes"):
            return image["bytes"]
        with open(image["path"], "rb") as f:  # an image folder keeps only the path
            return f.read()

    def __getitem__(self, idx: int):
        rec = self.ds[int(idx)]
        data = self._bytes(rec["image"])
        raw = _crop_and_flip(self, lambda: decode_image(data),
                             lambda: adm_center_crop(decode_image(data), self.resolution))
        target = rec.get("label", 0)
        return raw * 2.0 - 1.0, target, {"raw_image": raw, "class": target}
