"""The PNG fixtures of the port's decoder tests, and a small encoder.

``python tests/torch_png_fixtures/generate.py`` (from the repository root)
writes the fixture files of this folder from a seed, and ``digests.json``:
under ``files`` the sha256 of each file's ``Image.open(f).convert("RGB")``
bytes, with its shape and Pillow's mode. Run it where Pillow is installed;
the card's host reads the files and the digests only.

Pillow writes the kinds it can save (``PIL_FIXTURES``: 1-bit and 8-bit
gray, gray + alpha, palettes of 1, 2, 4 and 8 bits, RGB, RGBA and 16-bit
gray, with and without ``tRNS``, and a 512 x 512 RGB image for the decode
time). :func:`encode` writes the rest (:func:`hand_fixtures`): every colour
type at every bit depth the standard allows, plain and Adam7-interlaced
(Pillow writes no interlaced PNG), with each row filter in turn, and what
Pillow does not write at all: 2- and 4-bit gray, 16-bit RGB, RGBA and gray
+ alpha, an RGB file with a ``PLTE`` chunk and a short palette that pixels
index past.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def photo_like(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """(h, w, channels) float64 in [0, 1]: smooth gradients and blobs with
    a little noise, so that every row filter has work to do."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((h, w, channels))
    for c in range(channels):
        f = rng.uniform(0.5, 3.0, 3)
        v = np.sin(x / w * f[0] * np.pi + c) * np.cos(y / h * f[1] * np.pi) + 0.3 * np.sin(
            (x + y) / (w + h) * f[2] * 4 * np.pi)
        for _ in range(3):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.1, 0.4) * min(h, w)
            v += rng.uniform(-1, 1) * (((y - cy) ** 2 + (x - cx) ** 2) < r * r)
        out[..., c] = v
    out = (out - out.min()) / (np.ptp(out) + 1e-9)
    return np.clip(out + rng.normal(0, 0.01, out.shape), 0, 1)


def samples(h: int, w: int, color: int, depth: int, seed: int, n_palette: int = 0) -> np.ndarray:
    """(h, w, channels) integer samples of ``depth`` bits (palette indices
    below ``min(n_palette, 2 ** depth)`` for colour type 3)."""
    top = (1 << depth) - 1
    arr = photo_like(h, w, CHANNELS[color], seed)
    if color == 3:
        idx = np.round(arr[..., :1] * (min(n_palette, top + 1) - 1)).astype(np.int64)
        return np.minimum(idx, top)
    return np.round(arr * top).astype(np.int64)


def _pack_rows(arr: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) uint8 rows of packed samples."""
    h, w, c = arr.shape
    flat = arr.reshape(h, w * c)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = np.unpackbits(flat.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
    bits = bits.reshape(h, -1)
    pad = (-bits.shape[1]) % 8
    return np.packbits(np.pad(bits, ((0, 0), (0, pad))), axis=1)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Each row led by its filter byte, the filter of row y being
    ``filters[y % len(filters)]``."""
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[:row.size]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:row.size]
        pred = [0, left, prior, (left + prior) >> 1, _paeth(left, prior, upleft)][kind]
        out.append(bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(arr: np.ndarray, color: int, depth: int, interlace: bool = False,
           filters=(0, 1, 2, 3, 4), palette: bytes = None, trns: bytes = None) -> bytes:
    """A PNG of integer samples ``arr`` (h, w, channels), any colour type and
    bit depth, Adam7 when ``interlace``; ``palette`` goes in a PLTE chunk
    (any colour type), ``trns`` in a tRNS chunk."""
    h, w, _ = arr.shape
    bpp = max(1, CHANNELS[color] * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = arr[y0::dy, x0::dx]
        if sub.size:
            data += filter_rows(_pack_rows(sub, depth), bpp, filters)
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                 int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(data, 9)) + chunk(b"IEND", b"")


def _palette(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, 3 * n).astype(np.uint8).tobytes()


def hand_fixtures() -> dict:
    """name -> PNG bytes of :func:`encode`: each colour type and bit depth,
    plain and interlaced, then the kinds Pillow does not write."""
    out = {}
    seed = 100
    for color, depths in DEPTHS.items():
        for depth in depths:
            for interlace in (False, True):
                seed += 1
                n_pal = min(1 << depth, 200) if color == 3 else 0
                arr = samples(29, 37, color, depth, seed, n_pal)
                name = f"c{color}_d{depth}{'_adam7' if interlace else ''}_37x29.png"
                out[name] = encode(arr, color, depth, interlace,
                                   palette=_palette(n_pal, seed) if color == 3 else None)
    top16 = np.array([0, 255, 256, 1000, 40000, 65535])
    gray16 = np.tile(top16, (3, 2))[..., None]  # the 16-bit gray clip
    out["c0_d16_clip_12x3.png"] = encode(gray16, 0, 16)
    out["c0_d16_trns_adam7_37x29.png"] = encode(samples(29, 37, 0, 16, 7), 0, 16, True,
                                                trns=struct.pack(">H", 1000))
    out["c0_d2_trns_37x29.png"] = encode(samples(29, 37, 0, 2, 8), 0, 2, trns=b"\x00\x02")
    out["c2_d8_plte_37x29.png"] = encode(samples(29, 37, 2, 8, 9), 2, 8,
                                         palette=_palette(16, 9))
    out["c2_d16_trns_37x29.png"] = encode(samples(29, 37, 2, 16, 10), 2, 16,
                                          trns=struct.pack(">HHH", 1, 2, 3))
    out["c2_d8_trns_adam7_37x29.png"] = encode(samples(29, 37, 2, 8, 11), 2, 8, True,
                                               trns=struct.pack(">HHH", 10, 20, 30))
    idx = samples(29, 37, 3, 8, 12, n_palette=256)  # indices up to 255, 40 entries
    out["c3_d8_short_palette_37x29.png"] = encode(idx, 3, 8, palette=_palette(40, 12))
    idx4 = samples(29, 37, 3, 4, 13, n_palette=16)
    out["c3_d4_short_palette_trns_adam7_37x29.png"] = encode(
        idx4, 3, 4, True, palette=_palette(5, 13), trns=b"\x00\x80\xff")
    out["c3_d8_no_plte_9x7.png"] = encode(samples(7, 9, 3, 8, 14, n_palette=8), 3, 8)
    for size in ((1, 1), (3, 2), (2, 9)):  # Adam7 with empty passes
        arr = samples(size[1], size[0], 6, 16, 15)
        out[f"c6_d16_adam7_{size[0]}x{size[1]}.png"] = encode(arr, 6, 16, True)
    return out


# name -> (height, width, Pillow mode, save keywords)
PIL_FIXTURES = {
    "pil_1_37x29.png": (29, 37, "1", {}),
    "pil_L_37x29.png": (29, 37, "L", {}),
    "pil_L_trns_37x29.png": (29, 37, "L", dict(transparency=77)),
    "pil_LA_37x29.png": (29, 37, "LA", {}),
    "pil_P1_37x29.png": (29, 37, "P", dict(bits=1)),
    "pil_P2_37x29.png": (29, 37, "P", dict(bits=2)),
    "pil_P4_37x29.png": (29, 37, "P", dict(bits=4)),
    "pil_P8_trns_37x29.png": (29, 37, "P", dict(transparency=3)),
    "pil_RGB_trns_37x29.png": (29, 37, "RGB", dict(transparency=(10, 20, 30))),
    "pil_RGBA_optimize_37x29.png": (29, 37, "RGBA", dict(optimize=True)),
    "pil_I16_37x29.png": (29, 37, "I;16", {}),
    "pil_I16_trns_37x29.png": (29, 37, "I;16", dict(transparency=300)),
    "pil_RGB_512x512.png": (512, 512, "RGB+texture", {}),
}


def pil_image(h: int, w: int, mode: str, seed: int, bits: int = 8):
    from PIL import Image

    rgba = (photo_like(h, w, 4, seed) * 255).round().astype(np.uint8)
    if mode == "1":
        return Image.fromarray(rgba[..., 0] > 127)
    if mode == "L":
        return Image.fromarray(rgba[..., 0])
    if mode == "LA":
        return Image.fromarray(rgba[..., :2])
    if mode == "P":
        return Image.fromarray(rgba[..., :3]).quantize(1 << bits)
    if mode == "RGB":
        return Image.fromarray(rgba[..., :3])
    if mode == "RGB+texture":  # a 2-D texture: Pillow picks Paeth on about a third of rows
        y, x = np.mgrid[0:h, 0:w]
        tex = 40 * np.sin(x / 37.0)[..., None] * np.cos(y / 23.0)[..., None]
        return Image.fromarray(np.clip(rgba[..., :3] * 0.7 + 40 + tex, 0, 255).astype(np.uint8))
    if mode == "RGBA":
        return Image.fromarray(rgba)
    wide = (photo_like(h, w, 1, seed)[..., 0] * 2000).round().astype(np.uint16)  # I;16
    return Image.fromarray(wide)


def pil_fixtures(seed: int = 0) -> dict:
    out = {}
    for i, (name, (h, w, mode, kw)) in enumerate(sorted(PIL_FIXTURES.items())):
        buf = io.BytesIO()
        pil_image(h, w, mode, seed + i, kw.get("bits", 8)).save(buf, "PNG", **kw)
        out[name] = buf.getvalue()
    return out


def rgb_digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb, np.uint8).tobytes()).hexdigest()


def write_fixtures(folder: str = HERE, seed: int = 0) -> dict:
    """Write the fixtures and ``digests.json``; returns the digests."""
    import warnings

    from PIL import Image

    digests = {}
    for name, data in sorted({**hand_fixtures(), **pil_fixtures(seed)}.items()):
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # palette transparency given as bytes
            with Image.open(io.BytesIO(data)) as im:
                mode, rgb = im.mode, np.asarray(im.convert("RGB"))
        digests[name] = {"sha256": rgb_digest(rgb), "shape": list(rgb.shape), "mode": mode}
    out = {"files": digests}
    with open(os.path.join(folder, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


if __name__ == "__main__":
    result = write_fixtures()
    print(f"wrote {len(result['files'])} fixtures and digests.json to {HERE}")
