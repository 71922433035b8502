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

It also writes the JPEG kinds Pillow reads but does not write into
``kinds/`` (:data:`KIND_FIXTURES`), with their own ``digests.json``:
arithmetic coding (SOF9, SOF10: ``transcode.c``, built against the system
libjpeg here, rewrites Pillow's coefficients with arithmetic coding, a
restart interval, DAC conditioning and a scan script), progressive files
whose scans leave libjpeg's block smoothing on (Huffman and arithmetic),
and lossless JPEG (SOF3, :func:`encode_lossless`).

:func:`encode_baseline` writes a baseline JPEG with any sampling factors,
markers and component ids (Pillow writes only 4:4:4, 4:2:2 and 4:2:0 with
a JFIF or Adobe CMYK header), so the tests can hold the decoder against
Pillow on the 4:4:0, 4:1:1, YCCK and Adobe-RGB streams Pillow reads.
"""

from __future__ import annotations

import hashlib
import io
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


KINDS_DIR = os.path.join(HERE, "kinds")

# scan scripts ("components:Ss-Se:Ah,Al;..."): progressive files whose
# last scans leave some of the first nine AC coefficients unfinished
SCRIPT_EARLY_STOP = ("0,1,2:0-0:0,1;0:1-5:0,2;2:1-63:0,1;1:1-63:0,1;0:6-63:0,2;0:1-63:2,1;"
                     "0,1,2:0-0:1,0")  # the luma AC refinement stops at Al 1
SCRIPT_NO_CHROMA_AC = "0,1,2:0-0:0,0;0:1-63:0,0"
SCRIPT_DC_ONLY = "0,1,2:0-0:0,0"
SCRIPT_CUSTOM = ("0:0-0:0,1;1:0-0:0,1;2:0-0:0,1;0:1-2:0,1;0:3-63:0,2;1:1-63:0,1;2:1-63:0,1;"
                 "0:3-63:2,1;0,1,2:0-0:1,0;0:1-63:1,0;1:1-63:1,0;2:1-63:1,0")

# name -> how it is written: ("transcode", (h, w, Pillow mode, save keywords),
# (arith, restart, dac, scans)) or ("lossless", (h, w, channels), keywords)
KIND_FIXTURES = {
    # SOF9: arithmetic-coded, sequential
    "arith_420_512x512.jpg": ("transcode", (512, 512, "RGB", dict(quality=75, subsampling=2)),
                              (1, 0, "-", "-")),
    "arith_444_restart_dac_333x250.jpg": ("transcode", (250, 333, "RGB", dict(
        quality=90, subsampling=0)), (1, 5, "2,6,12", "-")),
    "arith_422_restart_dac_250x333.jpg": ("transcode", (333, 250, "RGB", dict(
        quality=60, subsampling=1)), (1, 7, "0,3,1", "-")),
    "arith_gray_restart_300x200.jpg": ("transcode", (200, 300, "L", dict(quality=85)),
                                       (1, 11, "-", "-")),
    "arith_adobe_cmyk_dac_240x180.jpg": ("transcode", (180, 240, "CMYK", dict(quality=80)),
                                         (1, 0, "1,1,63", "-")),
    "arith_q100_noise_160x120.jpg": ("transcode", (120, 160, "RGB", dict(
        quality=100, subsampling=0, noise=40)), (1, 3, "-", "-")),
    # SOF10: arithmetic-coded, progressive
    "arith_progressive_420_512x512.jpg": ("transcode", (512, 512, "RGB", dict(
        quality=75, subsampling=2)), (1, 0, "-", "simple")),
    "arith_progressive_custom_scans_300x200.jpg": ("transcode", (200, 300, "RGB", dict(
        quality=85, subsampling=2)), (1, 4, "5,9,20", SCRIPT_CUSTOM)),
    "arith_progressive_gray_restart_200x150.jpg": ("transcode", (150, 200, "L", dict(
        quality=70)), (1, 9, "-", "simple")),
    # progressive files libjpeg smooths, Huffman (SOF2) and arithmetic (SOF10)
    **{f"smooth_{name}_{coding}_{w}x{h}.jpg": ("transcode", (h, w, "RGB", dict(
        quality=q, subsampling=2)), (int(coding == "arith"), 0, "-", script))
       for name, script, h, w, q in (("early_stop", SCRIPT_EARLY_STOP, 157, 211, 80),
                                     ("no_chroma_ac", SCRIPT_NO_CHROMA_AC, 131, 199, 75),
                                     ("dc_only", SCRIPT_DC_ONLY, 93, 177, 85))
       for coding in ("huffman", "arith")},
    "smooth_dc_successive_huffman_64x48.jpg": ("transcode", (48, 64, "RGB", dict(
        quality=70, subsampling=2)), (0, 0, "-", "0,1,2:0-0:0,2")),
    "smooth_gray_two_blocks_wide_arith_15x70.jpg": ("transcode", (70, 15, "L", dict(
        quality=80)), (1, 0, "-", "0:0-0:0,0;0:1-2:0,1")),
    # SOF3: lossless
    "lossless_rgb_p6_512x512.jpg": ("lossless", (512, 512, 3), dict(predictor=6, blur=2)),
    **{f"lossless_p{p}_pt{pt}_61x47.jpg": ("lossless", (47, 61, 3), dict(predictor=p, pt=pt))
       for p, pt in ((1, 0), (2, 1), (3, 2), (4, 0), (5, 1), (6, 2), (7, 0))},
    "lossless_restart_p4_73x41.jpg": ("lossless", (41, 73, 3), dict(predictor=4, restart_rows=4)),
    "lossless_gray_restart_p7_64x64.jpg": ("lossless", (64, 64, 1), dict(predictor=7,
                                                                         restart_rows=5)),
    "lossless_420_p5_71x53.jpg": ("lossless", (53, 71, 3), dict(
        predictor=5, sampling=[(2, 2), (1, 1), (1, 1)], restart_rows=3)),
    "lossless_three_scans_p2_59x37.jpg": ("lossless", (37, 59, 3), dict(
        predictor=2, interleaved=False)),
    "lossless_wild_classes_p4_45x33.jpg": ("lossless", (33, 45, 3), dict(predictor=4,
                                                                         wild=0.08)),
    "lossless_adobe_cmyk_p1_37x29.jpg": ("lossless", (29, 37, 4), dict(predictor=1,
                                                                       adobe_transform=0)),
    "lossless_rgb_ids_p3_40x30.jpg": ("lossless", (30, 40, 3), dict(predictor=3,
                                                                   ids=[82, 71, 66])),
}


def build_transcoder(folder: str) -> str:
    """``transcode.c`` built against the system libjpeg into ``folder``."""
    import subprocess

    exe = os.path.join(folder, "transcode")
    subprocess.run([os.environ.get("CC", "cc"), "-O2", os.path.join(HERE, "transcode.c"), "-o",
                    exe, "-ljpeg"], check=True)
    return exe


def kind_file(name: str, exe: str, scratch: str, seed: int) -> bytes:
    """The bytes of one of :data:`KIND_FIXTURES`."""
    import subprocess

    from PIL import Image

    how, shape, opts = KIND_FIXTURES[name]
    if how == "lossless":
        h, w, c = shape
        opts = dict(opts)
        image = photo_like(h, w, c, seed).astype(np.float64)
        for _ in range(opts.pop("blur", 0)):  # 3 x 3 means: a smoother photograph
            padded = np.pad(image, ((1, 1), (1, 1), (0, 0)), mode="edge")
            image = sum(padded[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)) / 9
        return encode_lossless(np.round(image).astype(np.uint8), seed=seed, **opts)
    h, w, mode, kw = shape
    kw = dict(kw)
    arr = photo_like(h, w, 4, seed)
    noise = kw.pop("noise", 0)
    if noise:
        rng = np.random.default_rng(seed)
        arr = np.clip(arr + rng.normal(0, noise, arr.shape), 0, 255).astype(np.uint8)
    image = Image.fromarray(arr[..., 0]) if mode == "L" else (
        Image.fromarray(arr[..., :3]) if mode == "RGB"
        else Image.frombytes("CMYK", (w, h), arr.tobytes()))
    src, dst = os.path.join(scratch, "in.jpg"), os.path.join(scratch, "out.jpg")
    image.save(src, "JPEG", **kw)
    arith, restart, dac, scans = opts
    subprocess.run([exe, src, dst, str(arith), str(restart), dac, scans], check=True)
    with open(dst, "rb") as f:
        return f.read()


def write_kind_fixtures(folder: str = KINDS_DIR, seed: int = 100) -> dict:
    """Write :data:`KIND_FIXTURES` and their ``digests.json`` (the sha256 of
    Pillow's ``convert("RGB")``, the shape and the port's ``jpeg.info``
    kind); returns the digests."""
    import sys
    import tempfile

    from PIL import Image

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # the repository root
    from deco_tpu_torch.data import jpeg

    os.makedirs(folder, exist_ok=True)
    digests = {}
    with tempfile.TemporaryDirectory() as scratch:
        exe = build_transcoder(scratch)
        for i, name in enumerate(sorted(KIND_FIXTURES)):
            data = kind_file(name, exe, scratch, seed + i)
            with open(os.path.join(folder, name), "wb") as f:
                f.write(data)
            with Image.open(io.BytesIO(data)) as im:
                rgb = np.asarray(im.convert("RGB"))
            digests[name] = {"sha256": rgb_digest(rgb), "shape": list(rgb.shape),
                             "kind": jpeg.info(data)[3]}
    with open(os.path.join(folder, "digests.json"), "w") as f:
        json.dump({"files": digests}, f, indent=1, sort_keys=True)
        f.write("\n")
    return digests


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


# a DC table for lossless differences of every class 0-16: the K.3
# luminance table with codes of 10-14 bits added for classes 12-16
LOSSLESS_TABLE = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0], list(range(17)))


def encode_lossless(image: np.ndarray, predictor: int = 1, pt: int = 0, sampling=None,
                    restart_rows: int = 0, interleaved: bool = True, ids=None, jfif=False,
                    adobe_transform=None, wild: float = 0.0, seed: int = 0,
                    table=None) -> bytes:
    """A lossless JPEG (SOF3) of an (H, W, C) uint8 image with predictor
    1-7 and point transform ``pt``, each component sampled ``sampling``
    [(h, v), ...] (decimated from the full image), a restart every
    ``restart_rows`` MCU rows, one interleaved scan or one scan a component.
    ``wild`` is the share of samples coded with a random difference of any
    class 0-16 instead of the true one: the decoder's 16-bit sums then leave
    the 8-bit range, and every sample after is coded against them. Pillow
    writes no lossless JPEG, and libjpeg-turbo 3 reads it."""
    height, width, n = image.shape
    sampling = sampling or [(1, 1)] * n
    interleaved = interleaved and n > 1  # a scan of one component is never interleaved
    ids = ids or list(range(1, n + 1))
    table = table or (LOSSLESS_TABLE if wild else _STD_DC)
    codes = _codes(*table)
    rng = np.random.default_rng(seed)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    diffs = []
    for c, (h, v) in enumerate(sampling):
        dh, dw = -(-height * v // vmax), -(-width * h // hmax)
        fy, fx = vmax // v, hmax // h
        plane = image[::fy, ::fx, c][:dh, :dw].astype(np.int64) >> pt
        rows = v if interleaved else 1  # sample rows in an MCU row
        first = {r for r in range(dh) if r % rows == 0 and restart_rows
                 and (r // rows) % restart_rows == 0} | {0}
        rec = np.zeros((dh, dw), np.int64)  # the decoder's 16-bit sums
        diff = np.zeros((dh, dw), np.int64)
        for r in range(dh):
            for x in range(dw):
                if r in first:
                    pred = rec[r, x - 1] if x else 1 << (8 - pt - 1)
                elif x == 0:
                    pred = rec[r - 1, 0]
                else:
                    ra, rb, rc = int(rec[r, x - 1]), int(rec[r - 1, x]), int(rec[r - 1, x - 1])
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                d = (int(plane[r, x]) - int(pred)) & 0xFFFF
                if wild and rng.random() < wild:
                    k = int(rng.integers(0, 17))
                    d = 0x8000 if k == 16 else (0 if k == 0 else int(
                        rng.integers(1 << (k - 1), 1 << k)) * int(rng.choice([-1, 1])) & 0xFFFF)
                diff[r, x] = d - 0x10000 if d >= 0x8000 else d
                rec[r, x] = (int(pred) + int(diff[r, x])) & 0xFFFF
        diffs.append(diff)
    bits = _Bits()

    def put(d):
        size = 16 if d == -0x8000 else abs(d).bit_length()
        bits.put(*codes[size])
        if 0 < size < 16:
            bits.put(d if d > 0 else d + (1 << size) - 1, size)

    def restart(k):
        bits.flush()
        bits.out += bytes([0xFF, 0xD0 + k % 8])

    scans = []
    if interleaved:
        k = 0
        for my in range(mcuy):
            if restart_rows and my and my % restart_rows == 0:
                restart(k)
                k += 1
            for mx in range(mcux):
                for diff, (h, v) in zip(diffs, sampling):
                    for y in range(v):
                        for x in range(h):
                            r, col = my * v + y, mx * h + x
                            put(int(diff[r, col]) if r < diff.shape[0] and col < diff.shape[1]
                                else 0)
        bits.flush()
        scans.append((list(range(n)), bytes(bits.out)))
    else:
        for c, diff in enumerate(diffs):
            bits = _Bits()
            k = 0
            for r in range(diff.shape[0]):
                if restart_rows and r and r % restart_rows == 0:
                    restart(k)
                    k += 1
                for d in diff[r]:
                    put(int(d))
            bits.flush()
            scans.append(([c], bytes(bits.out)))

    def segment(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe_transform]))
    sof = struct.pack(">BHHB", 8, height, width, n)
    for cid, (h, v) in zip(ids, sampling):
        sof += bytes([cid, (h << 4) | v, 0])
    out += segment(0xC3, sof)
    out += segment(0xC4, bytes([0]) + bytes(table[0]) + bytes(table[1]))
    if restart_rows and interleaved:
        out += segment(0xDD, struct.pack(">H", restart_rows * mcux))
    for comps, data in scans:
        if restart_rows and not interleaved:
            c = comps[0]
            h, v = sampling[c]
            out += segment(0xDD, struct.pack(">H", restart_rows * -(-width * h // hmax)))
        sos = bytes([len(comps)]) + b"".join(bytes([ids[c], 0]) for c in comps)
        out += segment(0xDA, sos + bytes([predictor, 0, pt])) + data
    return bytes(out + b"\xff\xd9")


if __name__ == "__main__":
    written = write_fixtures()
    for name, d in written["files"].items():
        size = os.path.getsize(os.path.join(HERE, name))
        print(f"{name}: {size} bytes, {d['shape']}, sha256 {d['sha256'][:16]}")
    print("readers:", written["readers"])
    for name, d in write_kind_fixtures().items():
        size = os.path.getsize(os.path.join(KINDS_DIR, name))
        print(f"kinds/{name}: {size} bytes, {d['shape']}, {d['kind']}")
