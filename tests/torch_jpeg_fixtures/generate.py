"""The JPEG fixtures of the port's decoder tests, and a small encoder.

``python tests/torch_jpeg_fixtures/generate.py`` (from the repository
root) writes the eight fixture files of this folder with Pillow from a
seed, and ``digests.json``: under ``files`` the sha256 of each file's
``Image.open(f).convert("RGB")`` bytes, with its shape; under ``readers``
the digests of the port's ``PixImageNet`` items over a folder of the
fixtures (``chip_smoke.jpeg_reader_digests``: the center crop and the
random crop, computed on the CPU; the tests hold them equal to the JAX
package's PIL path). Run it where Pillow is installed; the card's host
reads the files and the digests only.

:func:`encode_baseline` writes a baseline JPEG with any sampling factors,
markers and component ids (Pillow writes only 4:4:4, 4:2:2 and 4:2:0 with
a JFIF or Adobe CMYK header), so the tests can hold the decoder against
Pillow on the 4:4:0, 4:1:1, YCCK and Adobe-RGB streams Pillow reads.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (height, width, Pillow mode, save keywords): the chroma layouts, modes and
# stream kinds the decoder must read, at ImageNet- and BLIP3o-like sizes
FIXTURES = {
    "baseline_420_500x375.jpg": (375, 500, "RGB", dict(quality=85, subsampling=2)),
    "baseline_422_333x500.jpg": (500, 333, "RGB", dict(quality=90, subsampling=1)),
    "progressive_420_640x480.jpg": (480, 640, "RGB", dict(quality=80, subsampling=2,
                                                          progressive=True)),
    "baseline_420_q95_1024x1024.jpg": (1024, 1024, "RGB", dict(quality=95, subsampling=2)),
    "restart_444_517x389.jpg": (389, 517, "RGB", dict(quality=90, subsampling=0,
                                                      restart_marker_blocks=7)),
    "gray_600x400.jpg": (400, 600, "L", dict(quality=85)),
    "adobe_cmyk_400x300.jpg": (300, 400, "CMYK", dict(quality=90)),
    "progressive_444_731x1023.jpg": (1023, 731, "RGB", dict(quality=85, subsampling=0,
                                                            progressive=True, optimize=True)),
}


def photo_like(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """(h, w, channels) uint8: smooth gradients and blobs with texture, so
    the DCT sees both flat and busy blocks, as in a photograph."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((h, w, channels), np.float64)
    for c in range(channels):
        f = rng.uniform(0.5, 4.0, 4)
        ph = rng.uniform(0, 2 * np.pi, 4)
        v = (np.sin(x / w * f[0] * np.pi + ph[0]) * np.cos(y / h * f[1] * np.pi + ph[1])
             + 0.5 * np.sin((x + y) / (w + h) * f[2] * 4 * np.pi + ph[2]))
        for _ in range(6):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.05, 0.3) * min(h, w)
            v += rng.uniform(-1, 1) * (((y - cy) ** 2 + (x - cx) ** 2) < r * r)
        out[..., c] = v
    out = (out - out.min()) / (np.ptp(out) + 1e-9) * 255.0
    out += rng.normal(0, 6, out.shape)  # sensor-like texture
    return np.clip(out, 0, 255).astype(np.uint8)


def rgb_digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb, np.uint8).tobytes()).hexdigest()


def write_fixtures(folder: str = HERE, seed: int = 0) -> dict:
    """Write the fixtures and ``digests.json``; returns the digests."""
    import shutil
    import sys
    import tempfile

    from PIL import Image

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # the repository root
    import chip_smoke

    digests = {}
    for i, (name, (h, w, mode, kw)) in enumerate(sorted(FIXTURES.items())):
        arr = photo_like(h, w, {"L": 1, "RGB": 3, "CMYK": 4}[mode], seed + i)
        image = Image.fromarray(arr[..., 0]) if mode == "L" else (
            Image.fromarray(arr) if mode == "RGB" else Image.frombytes("CMYK", (w, h), arr.tobytes()))
        path = os.path.join(folder, name)
        image.save(path, "JPEG", **kw)
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
        digests[name] = {"sha256": rgb_digest(rgb), "shape": list(rgb.shape)}
    scratch = tempfile.mkdtemp()
    try:
        chip_smoke.jpeg_fixture_folder(scratch, folder)
        readers = chip_smoke.jpeg_reader_digests(scratch)
    finally:
        shutil.rmtree(scratch)
    out = {"files": digests, "readers": readers}
    with open(os.path.join(folder, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


# --- a baseline encoder --------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_STD_DC = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_STD_AC = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25"
    "262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a83"
    "8485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3"
    "d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24,
                    40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103,
                    77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72,
                    92, 95, 98, 112, 100, 103, 99])


def _codes(bits, vals):
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        self.acc = 0


def _dct_matrix():
    c = np.array([[np.sqrt((1 if k == 0 else 2) / 8) * np.cos((2 * n + 1) * k * np.pi / 16)
                   for n in range(8)] for k in range(8)])
    return c


def encode_baseline(planes, sampling, quality_scale: float = 1.0, ids=None, jfif=True,
                    adobe_transform=None, restart_interval: int = 0) -> bytes:
    """A baseline JPEG of ``planes`` (each (H, W) uint8 at full size, coded
    as they are: no colour transform) with ``sampling`` [(h, v), ...]. Each
    plane is box-averaged down to its own size; the standard Huffman
    tables code every component. ``jfif`` writes an APP0, and
    ``adobe_transform`` an APP14 with that transform."""
    planes = [np.asarray(p, np.float64) for p in planes]
    H, W = planes[0].shape
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    q = np.clip(np.round(_LUMA_Q * quality_scale), 1, 255).astype(np.int64)
    c8 = _dct_matrix()
    coefs = []
    for p, (h, v) in zip(planes, sampling):
        fy, fx = vmax // v, hmax // h
        dh, dw = -(-H * v // vmax), -(-W * h // hmax)
        ph = np.pad(p, ((0, dh * fy - H), (0, dw * fx - W)), mode="edge")
        small = ph.reshape(dh, fy, dw, fx).mean(axis=(1, 3))
        full = np.pad(small, ((0, mcuy * v * 8 - dh), (0, mcux * h * 8 - dw)), mode="edge")
        blocks = full.reshape(mcuy * v, 8, mcux * h, 8).transpose(0, 2, 1, 3) - 128.0
        dct = np.einsum("ki,abij,lj->abkl", c8, blocks, c8) * 1.0
        coefs.append(np.round(dct.reshape(*dct.shape[:2], 64) / q).astype(np.int64))
    dc_codes, ac_codes = _codes(*_STD_DC), _codes(*_STD_AC)
    bits = _Bits()
    pred = [0] * n

    def put_block(ci, blk):
        zz = blk[_ZIGZAG]
        diff = int(zz[0]) - pred[ci]
        pred[ci] = int(zz[0])
        size = abs(diff).bit_length()
        bits.put(*dc_codes[size])
        if size:
            bits.put(diff if diff > 0 else diff + (1 << size) - 1, size)
        run = 0
        for k in range(1, 64):
            a = int(zz[k])
            if a == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_codes[0xF0])
                run -= 16
            size = abs(a).bit_length()
            bits.put(*ac_codes[(run << 4) | size])
            bits.put(a if a > 0 else a + (1 << size) - 1, size)
            run = 0
        if run:
            bits.put(*ac_codes[0x00])

    rst = 0
    mcus = [(my, mx) for my in range(mcuy) for mx in range(mcux)]
    single = n == 1
    if single:  # a non-interleaved scan: one block an MCU, blocks with data only
        h, v = sampling[0]
        dh, dw = -(-H * v // vmax), -(-W * h // hmax)
        mcus = [(by, bx) for by in range(-(-dh // 8)) for bx in range(-(-dw // 8))]
    for i, (my, mx) in enumerate(mcus):
        if restart_interval and i and i % restart_interval == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) % 8
            pred = [0] * n
        if single:
            put_block(0, coefs[0][my, mx])
            continue
        for ci, (h, v) in enumerate(sampling):
            for y in range(v):
                for x in range(h):
                    put_block(ci, coefs[ci][my * v + y, mx * h + x])
    bits.flush()

    def segment(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe_transform]))
    out += segment(0xDB, bytes([0]) + bytes(q[_ZIGZAG].astype(np.uint8).tolist()))
    sof = struct.pack(">BHHB", 8, H, W, n)
    for cid, (h, v) in zip(ids, sampling):
        sof += bytes([cid, (h << 4) | v, 0])
    out += segment(0xC0, sof)
    out += segment(0xC4, bytes([0x00]) + bytes(_STD_DC[0]) + bytes(_STD_DC[1]))
    out += segment(0xC4, bytes([0x10]) + bytes(_STD_AC[0]) + _STD_AC[1])
    if restart_interval:
        out += segment(0xDD, struct.pack(">H", restart_interval))
    sos = bytes([n]) + b"".join(bytes([cid, 0x00]) for cid in ids) + bytes([0, 63, 0])
    out += segment(0xDA, sos) + bytes(bits.out) + b"\xff\xd9"
    return bytes(out)


def encode_lossless(image: np.ndarray) -> bytes:
    """A lossless JPEG (SOF3, predictor 1, no point transform) of an (H, W,
    C) uint8 image, every component at full size, coded with the standard
    DC table; Pillow writes no lossless JPEG, and libjpeg-turbo reads it."""
    h, w, n = image.shape
    dc = _codes(*_STD_DC)
    bits = _Bits()
    x = image.astype(np.int64)
    for row in range(h):
        for col in range(w):
            for c in range(n):
                if row == 0 and col == 0:
                    pred = 128
                elif row == 0 or col > 0:
                    pred = x[row, col - 1, c]
                else:
                    pred = x[row - 1, col, c]
                diff = int(x[row, col, c] - pred)
                size = abs(diff).bit_length()
                bits.put(*dc[size])
                if size:
                    bits.put(diff if diff > 0 else diff + (1 << size) - 1, size)
    bits.flush()

    def segment(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    sof = struct.pack(">BHHB", 8, h, w, n) + b"".join(bytes([i + 1, 0x11, 0]) for i in range(n))
    sos = bytes([n]) + b"".join(bytes([i + 1, 0]) for i in range(n)) + bytes([1, 0, 0])
    return (b"\xff\xd8" + segment(0xC3, sof)
            + segment(0xC4, bytes([0]) + bytes(_STD_DC[0]) + bytes(_STD_DC[1]))
            + segment(0xDA, sos) + bytes(bits.out) + b"\xff\xd9")


if __name__ == "__main__":
    written = write_fixtures()
    for name, d in written["files"].items():
        size = os.path.getsize(os.path.join(HERE, name))
        print(f"{name}: {size} bytes, {d['shape']}, sha256 {d['sha256'][:16]}")
    print("readers:", written["readers"])
