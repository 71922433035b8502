"""The WebP, GIF, BMP, DIB, ICO, CUR, PNM and QOI fixtures of the port's
decoder tests, and the small encoders that write what Pillow does not.

``python tests/torch_image_fixtures/generate.py`` (from the repository
root) writes the fixture files of this folder from a seed, and
``digests.json``: under ``files`` the sha256 of each file's
``Image.open(f).convert("RGB")`` bytes with its shape and Pillow's mode;
under ``generated`` the same for the files :func:`generated_files` writes
at run time (the 512 x 512 24-bit BMP, P6 PNM and QOI of the decode
timing, which would not fit the folder). Run it where Pillow is installed; the card's host reads
the files and the digests only, and builds the generated ones with numpy.

- WebP (Pillow, over libwebp): lossy at qualities 5-100 and methods 0-6,
  with and without alpha (``alpha_quality``, the filters); lossless on a
  photo, on 2, 3, 4, 16 and 200 colours (pixel bundling and the colour
  index), ``exact`` alpha; VP8X with ICC and EXIF; animations (lossy and
  lossless, frames smaller than the canvas); and a 512 x 512 lossy and
  lossless pair for the decode timing.
- GIF (:func:`encode_gif`, an LZW encoder): global and local colour tables,
  a gray ramp (mode L), no table, interlaced rows, a transparency index, a
  first frame smaller than the screen and one that passes it, clear codes,
  a 2-bit and an 8-bit code size, and Pillow's animated GIF.
- BMP (:func:`encode_bmp`, :func:`rle`): OS/2 core, info, v2-v5 headers;
  1, 4 and 8-bit palettes (short, gray, two-colour); 16-bit 555 and 565;
  24 and 32 bits under every bitfield layout Pillow reads; bottom-up and
  top-down rows; RLE8 and RLE4 with end of line, delta and absolute runs.
- DIB (BMPs without their file header): 1, 8, 24-bit, OS/2 core, v5
  bitfields, RLE8.
- ICO and CUR (:func:`encode_icon`, :func:`icon_bitmap`, and Pillow's ICO
  writer): PNG frames (several sizes, one Pillow resized), bitmap frames of
  1, 4, 8, 24 and 32 bits with their AND masks, the choice between entries
  of one size and several depths (a depth given by the colour count only),
  a cursor directory whose largest entry is not the first, and one whose
  later entry is wider but not taller.
- PNM: P1-P3 plain with comments (one inside a token), P4-P6 raw, maxval
  100, 1000, 4095 and 65535 (mode I), Pf little- and big-endian, and
  Pillow's P0CMYK, PyCMYK, PyRGBA and PyP.
- QOI (Pillow, and :func:`encode_qoi`): RGB and RGBA, and an op stream of
  every op with an index slot never written, a channel count of 5 (RGBA to
  Pillow), a last run past the image and no end marker.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LARGE = 512  # the side of the decode-timing images
SUFFIXES = (".bmp", ".gif", ".webp", ".dib", ".ico", ".cur", ".pbm", ".pgm", ".ppm", ".pfm",
            ".qoi")


def photo_like(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: gradients, blobs and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((h, w, 3))
    for c in range(3):
        f = rng.uniform(0.5, 3.0, 3)
        v = np.sin(x / w * f[0] * np.pi + c) * np.cos(y / h * f[1] * np.pi) + 0.3 * np.sin(
            (x + y) / (w + h) * f[2] * 4 * np.pi)
        for _ in range(3):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.1, 0.4) * min(h, w)
            v += rng.uniform(-1, 1) * (((y - cy) ** 2 + (x - cx) ** 2) < r * r)
        out[..., c] = v
    out = (out - out.min()) / (np.ptp(out) + 1e-9)
    noise = rng.normal(0, 0.02, out.shape)
    return np.clip(np.round((out + noise) * 255), 0, 255).astype(np.uint8)


def indexed(h: int, w: int, colors: int, seed: int) -> np.ndarray:
    """(h, w) indices below ``colors``, in smooth regions."""
    gray = photo_like(h, w, seed)[..., 1].astype(np.int64)
    return (gray * colors // 256).astype(np.uint8)


# --- BMP -----------------------------------------------------------------

def encode_bmp(w: int, h: int, bits: int, rows: bytes, palette: bytes = b"",
               header: int = 40, compression: int = 0, colors: int = 0, masks=(),
               top_down: bool = False, offset=None) -> bytes:
    """A BMP file: the 14-byte file header, an info header of ``header``
    bytes (12: OS/2 core), ``masks`` (bitfields: after a 40-byte header,
    else inside it), the palette and the pixel rows as given."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        hh = -h if top_down else h
        info = struct.pack("<IiiHHIIiiII", header, w, hh, 1, bits, compression, len(rows),
                           2835, 2835, colors, 0)
        body = b"".join(struct.pack("<I", m) for m in masks)
        if header == 40:
            extra = body
        else:
            info += (body + bytes(header - 40))[:header - 40]
            extra = b""
    start = 14 + len(info) + len(extra) + len(palette)
    data = info + extra + palette + rows
    return b"BM" + struct.pack("<IHHI", 14 + len(data), 0, 0,
                               start if offset is None else offset) + data


def bmp_rows(pixels: np.ndarray, bits: int, bottom_up: bool = True) -> bytes:
    """Packed rows, each padded to 4 bytes: (h, w) indices for 1-8 bits,
    (h, w, k) bytes for 16-32 bits."""
    arr = pixels[::-1] if bottom_up else pixels
    h, w = arr.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    out = bytearray()
    for row in arr:
        if bits < 8:
            per = 8 // bits
            vals = np.zeros(-(-w // per) * per, np.uint8)
            vals[:w] = row
            packed = np.zeros(len(vals) // per, np.uint8)
            for k in range(per):
                packed |= vals[k::per] << (8 - bits * (k + 1))
            line = packed.tobytes()
        else:
            line = np.ascontiguousarray(row, np.uint8).tobytes()
        out += line + bytes(stride - len(line))
    return bytes(out)


def rle(indices: np.ndarray, four: bool = False, delta_at=None) -> bytes:
    """RLE8 (or RLE4) rows, bottom-up: runs of equal pixels, absolute runs
    of mixed ones, an end of line after each row, a delta (skip right 2,
    down 1) once at row ``delta_at``, and the end of the bitmap."""
    out = bytearray()
    rows = indices[::-1]
    h, w = rows.shape
    y = 0
    while y < h:
        row = [int(v) for v in rows[y]]
        x = 0
        if delta_at is not None and y == delta_at and w > 4 and y + 1 < h:
            out += bytes([0, 2, 0, 0, 2, 1])  # Pillow reads two bytes, then (right, up)
            x = 2
            y += 1
            row = [int(v) for v in rows[y]]
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                value = row[x] * 17 if four else row[x]
                out += bytes([run, value])
                x += run
                continue
            k = min(w - x, 64)
            lit = row[x:x + k]
            if four:
                k -= k % 2  # Pillow reads count // 2 bytes of two pixels
                lit = lit[:k]
                if k < 3:
                    out += bytes([1, row[x] * 17])
                    x += 1
                    continue
                body = bytes((lit[i] << 4) | lit[i + 1] for i in range(0, k, 2))
            else:
                body = bytes(lit)
            out += bytes([0, k]) + body
            if len(out) % 2:  # runs align to 16-bit words of the file (it starts even)
                out += b"\0"
            x += k
        out += b"\0\0"
        y += 1
    return bytes(out + b"\0\1")


def _palette(colors: int, seed: int, pad: int = 4) -> bytes:
    rng = np.random.default_rng(seed)
    bgr = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
    if pad == 3:
        return bgr.tobytes()
    return np.concatenate([bgr, np.zeros((colors, 1), np.uint8)], 1).tobytes()


def bmp_fixtures() -> dict:
    h, w = 23, 37
    img = photo_like(h, w, 11)
    bgr = img[..., ::-1]
    files = {}
    for bits in (1, 4, 8):
        idx = indexed(h, w, 1 << bits, 12 + bits)
        files[f"bmp_info_{bits}bpp.bmp"] = encode_bmp(
            w, h, bits, bmp_rows(idx, bits), _palette(1 << bits, bits))
    idx = indexed(h, w, 256, 15)
    files["bmp_os2_8bpp.bmp"] = encode_bmp(w, h, 8, bmp_rows(idx, 8), _palette(256, 16, 3),
                                           header=12)
    files["bmp_os2_24bpp.bmp"] = encode_bmp(w, h, 24, bmp_rows(bgr, 24), header=12)
    # 16 colours listed, pixels past them (black in Pillow)
    files["bmp_8bpp_short_palette.bmp"] = encode_bmp(
        w, h, 8, bmp_rows(indexed(h, w, 40, 17), 8), _palette(16, 18), colors=16)
    gray = b"".join(bytes([i, i, i, 0]) for i in range(256))
    files["bmp_8bpp_gray_ramp.bmp"] = encode_bmp(w, h, 8, bmp_rows(idx, 8), gray)
    files["bmp_1bpp_black_white.bmp"] = encode_bmp(
        w, h, 1, bmp_rows(indexed(h, w, 2, 19), 1), bytes([0, 0, 0, 0, 255, 255, 255, 0]))
    v = (img.astype(np.uint16) >> 3)
    p555 = (v[..., 0] << 10) | (v[..., 1] << 5) | v[..., 2]
    files["bmp_16bpp_555.bmp"] = encode_bmp(w, h, 16, bmp_rows(p555.astype("<u2").view(
        np.uint8).reshape(h, w, 2), 16))
    p565 = ((img[..., 0].astype(np.uint16) >> 3) << 11) | ((img[..., 1].astype(np.uint16) >> 2)
                                                          << 5) | (img[..., 2] >> 3)
    files["bmp_16bpp_565_bitfields.bmp"] = encode_bmp(
        w, h, 16, bmp_rows(p565.astype("<u2").view(np.uint8).reshape(h, w, 2), 16),
        compression=3, masks=(0xF800, 0x7E0, 0x1F))
    files["bmp_24bpp.bmp"] = encode_bmp(w, h, 24, bmp_rows(bgr, 24))
    files["bmp_24bpp_top_down.bmp"] = encode_bmp(w, h, 24, bmp_rows(bgr, 24, bottom_up=False),
                                                 top_down=True)
    files["bmp_v5_24bpp.bmp"] = encode_bmp(w, h, 24, bmp_rows(bgr, 24), header=124)
    alpha = photo_like(h, w, 20)[..., :1]
    bgrx = np.concatenate([bgr, alpha], -1)
    files["bmp_32bpp_bgrx.bmp"] = encode_bmp(w, h, 32, bmp_rows(bgrx, 32))
    layouts = {  # name: (masks, the bytes of each pixel from R, G, B, A)
        "bgra_v3": ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), (2, 1, 0, 3), 56),
        "rgba_v4": ((0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0, 1, 2, 3), 108),
        "abgr_v5": ((0xFF000000, 0xFF0000, 0xFF00, 0xFF), (3, 2, 1, 0), 124),
        "xbgr_v2": ((0xFF000000, 0xFF0000, 0xFF00), (3, 2, 1, 0), 52),
        "bgxr_info": ((0xFF000000, 0xFF00, 0xFF), (3, 1, 0, 2), 40),
    }
    rgba = np.concatenate([img, alpha], -1)
    for name, (masks, order, header) in layouts.items():
        px = np.empty_like(rgba)
        for c, at in enumerate(order):
            px[..., at] = rgba[..., c]
        files[f"bmp_32bpp_{name}.bmp"] = encode_bmp(w, h, 32, bmp_rows(px, 32), header=header,
                                                    compression=3, masks=masks)
    idx8 = indexed(h, w, 6, 21)
    files["bmp_rle8.bmp"] = encode_bmp(w, h, 8, rle(idx8, delta_at=5), _palette(256, 22),
                                       compression=1)
    idx4 = indexed(h, w, 5, 23)
    files["bmp_rle4.bmp"] = encode_bmp(w, h, 4, rle(idx4, four=True, delta_at=9),
                                       _palette(16, 24), compression=2)
    files["bmp_rle8_top_down.bmp"] = encode_bmp(w, h, 8, rle(idx8[::-1]), _palette(256, 25),
                                                compression=1, top_down=True)
    return files


def large_bmp() -> bytes:
    """The 512 x 512 24-bit BMP of the decode timing (numpy only)."""
    img = photo_like(LARGE, LARGE, 99)
    return encode_bmp(LARGE, LARGE, 24, bmp_rows(img[..., ::-1], 24))


def large_pnm() -> bytes:
    """The 512 x 512 P6 PNM of the decode timing (numpy only)."""
    return b"P6\n%d %d\n255\n" % (LARGE, LARGE) + photo_like(LARGE, LARGE, 98).tobytes()


def large_qoi() -> bytes:
    """The 512 x 512 QOI of the decode timing (:func:`encode_qoi`)."""
    return encode_qoi(photo_like(LARGE, LARGE, 97))


def generated_files() -> dict:
    """The files built at run time (too large to commit)."""
    return {"bmp_24bpp_512x512.bmp": large_bmp(), "pnm_p6_512x512.ppm": large_pnm(),
            "qoi_512x512.qoi": large_qoi()}


# --- DIB, ICO and CUR ----------------------------------------------------

def dib(bmp: bytes) -> bytes:
    """A BMP without its 14-byte file header: Pillow's DibImageFile."""
    return bmp[14:]


def dib_fixtures() -> dict:
    h, w = 21, 35
    img = photo_like(h, w, 30)
    bgr = img[..., ::-1]
    idx = indexed(h, w, 256, 31)
    rgba = np.concatenate([img, photo_like(h, w, 32)[..., :1]], -1)
    return {
        "dib_1bpp.dib": dib(encode_bmp(w, h, 1, bmp_rows(indexed(h, w, 2, 33), 1),
                                       _palette(2, 34))),
        "dib_8bpp_palette.dib": dib(encode_bmp(w, h, 8, bmp_rows(idx, 8), _palette(256, 35))),
        "dib_24bpp.dib": dib(encode_bmp(w, h, 24, bmp_rows(bgr, 24))),
        "dib_os2_24bpp.dib": dib(encode_bmp(w, h, 24, bmp_rows(bgr, 24), header=12)),
        "dib_32bpp_rgba_v5.dib": dib(encode_bmp(
            w, h, 32, bmp_rows(rgba, 32), header=124, compression=3,
            masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))),
        "dib_rle8.dib": dib(encode_bmp(w, h, 8, rle(indexed(h, w, 7, 36), delta_at=4),
                                       _palette(256, 37), compression=1)),
    }


def icon_bitmap(pixels: np.ndarray, bits: int, palette: bytes = b"", seed: int = 0) -> bytes:
    """An icon's bitmap frame: a DIB of twice the height holding the XOR
    rows (bottom-up), then the AND mask's 1-bit rows."""
    h, w = pixels.shape[:2]
    mask = bmp_rows(indexed(h, w, 2, seed), 1)
    return dib(encode_bmp(w, 2 * h, bits, bmp_rows(pixels, bits) + mask, palette))


def encode_icon(entries, kind: int = 1) -> bytes:
    """An ICO (kind 1) or CUR (kind 2) of entries (width, height, colours,
    bits, payload): the directory, then the payloads in its order."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    body = b""
    start = 6 + 16 * len(entries)
    for w, h, colors, bits, payload in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0, 1, bits, len(payload),
                           start + len(body))
        body += payload
    return out + body


def icon_fixtures() -> dict:
    from PIL import Image

    def save(im, fmt="ICO", **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    big = photo_like(48, 48, 40)
    files = {
        "ico_png_sizes.ico": save(Image.fromarray(big), sizes=[(16, 16), (32, 32), (48, 48)]),
        "ico_png_resized_24x20.ico": save(Image.fromarray(photo_like(20, 24, 41))),
        "ico_pillow_bmp_rgba.ico": save(Image.fromarray(
            np.concatenate([big, photo_like(48, 48, 42)[..., :1]], -1), "RGBA"),
            bitmap_format="bmp", sizes=[(32, 32), (48, 48)]),
    }
    px = photo_like(24, 24, 43)
    idx8, idx4, idx1 = indexed(24, 24, 256, 44), indexed(24, 24, 16, 45), indexed(24, 24, 2, 46)
    rgba = np.concatenate([px[..., ::-1], photo_like(24, 24, 47)[..., :1]], -1)
    frames = {
        1: icon_bitmap(idx1, 1, _palette(2, 48), 1),
        4: icon_bitmap(idx4, 4, _palette(16, 49), 2),
        8: icon_bitmap(idx8, 8, _palette(256, 50), 3),
        24: icon_bitmap(px[..., ::-1], 24, seed=4),
        32: icon_bitmap(rgba, 32, seed=5),
    }
    for bits, frame in frames.items():
        files[f"ico_bmp_{bits}bpp.ico"] = encode_icon([(24, 24, 0, bits, frame)])
    small = icon_bitmap(photo_like(16, 16, 51)[..., ::-1], 24, seed=6)
    # one size in several depths: the lowest depth wins, here 4 bits given
    # by the colour count alone (bits 0, 16 colours)
    files["ico_pick_lowest_depth.ico"] = encode_icon([
        (16, 16, 0, 24, small), (24, 24, 0, 32, frames[32]), (24, 24, 16, 0, frames[4]),
        (24, 24, 0, 8, frames[8])])
    png = save(Image.fromarray(photo_like(32, 32, 52)), "PNG")
    files["ico_bmp_and_png.ico"] = encode_icon([(16, 16, 0, 24, small), (32, 32, 0, 32, png)])
    # cursors: the largest entry is not the first; a later entry wider but
    # not taller is not taken
    files["cur_largest_second.cur"] = encode_icon([(16, 16, 0, 24, small),
                                                   (24, 24, 0, 24, frames[24])], kind=2)
    files["cur_first_kept.cur"] = encode_icon([(24, 24, 0, 8, frames[8]),
                                               (32, 24, 0, 24, frames[24])], kind=2)
    files["cur_32bpp.cur"] = encode_icon([(24, 24, 0, 32, frames[32])], kind=2)
    return files


# --- PNM -----------------------------------------------------------------

def pnm_fixtures() -> dict:
    h, w = 19, 27
    img = photo_like(h, w, 60).astype(np.int64)
    gray = img[..., 1]
    cmyk = np.concatenate([img, photo_like(h, w, 61)[..., :1]], -1).astype(np.int64)

    def plain(values, per_line: int = 12) -> bytes:
        flat = [str(int(v)).encode() for v in np.ravel(values)]
        return b"\n".join(b" ".join(flat[i:i + per_line]) for i in range(0, len(flat), per_line))

    bits = (gray > 127).astype(np.uint8)
    packed = np.packbits(bits, axis=1)
    floats = (gray / 255.0 * 300 - 20).astype(np.float32)
    floats[0, :3] = (np.nan, np.inf, -np.inf)
    return {
        "pnm_p1_plain_comments.pbm": b"P1\n# a comment\n%d %d\n" % (w, h) + b"\n".join(
            b"".join(b"%d" % v for v in row) + (b" # row %d" % i if i % 5 == 0 else b"")
            for i, row in enumerate(bits)),
        "pnm_p2_plain.pgm": b"P2 %d %d 255\n" % (w, h) + plain(gray),
        "pnm_p2_plain_16bit.pgm": b"P2\n%d %d\n# a comment\n60000\n" % (w, h) + plain(
            gray * 60000 // 255),
        "pnm_p3_plain_maxval_1000.ppm": b"P3\n%d %d\n1000\n" % (w, h) + plain(
            img * 1000 // 255, 9),
        "pnm_p4.pbm": b"P4\n%d %d\n" % (w, h) + packed.tobytes(),
        "pnm_p5.pgm": b"P5\n%d %d\n255\n" % (w, h) + gray.astype(np.uint8).tobytes(),
        "pnm_p5_maxval_100.pgm": b"P5 %d %d 100\n" % (w, h) + (gray * 100 // 255).astype(
            np.uint8).tobytes(),
        "pnm_p5_maxval_1000.pgm": b"P5\n%d %d\n1000\n" % (w, h) + (gray * 1000 // 255).astype(
            ">u2").tobytes(),
        "pnm_p5_16bit.pgm": b"P5\n%d %d\n65535\n" % (w, h) + (gray * 257).astype(">u2").tobytes(),
        "pnm_p6.ppm": b"P6\n%d %d\n255\n" % (w, h) + img.astype(np.uint8).tobytes(),
        "pnm_p6_maxval_4095.ppm": b"P6\n%d %d\n4095\n" % (w, h) + (img * 4095 // 255).astype(
            ">u2").tobytes(),
        # a comment inside the maxval token: "25" + "5"
        "pnm_p6_comment_in_token.ppm": b"P6\n%d %d\n25#inside\n5\n" % (w, h) + img.astype(
            np.uint8).tobytes(),
        "pnm_pf_little_endian.pfm": b"Pf\n%d %d\n-1.0\n" % (w, h) + floats[::-1].astype(
            "<f4").tobytes(),
        "pnm_pf_big_endian.pfm": b"Pf\n%d %d\n2.5\n" % (w, h) + floats[::-1].astype(
            ">f4").tobytes(),
        "pnm_p0cmyk.ppm": b"P0CMYK\n%d %d\n255\n" % (w, h) + cmyk.astype(np.uint8).tobytes(),
        "pnm_pycmyk_maxval_7000.ppm": b"PyCMYK %d %d 7000\n" % (w, h) + (
            cmyk * 7000 // 255).astype(">u2").tobytes(),
        "pnm_pyrgba.ppm": b"PyRGBA %d %d 255\n" % (w, h) + cmyk.astype(np.uint8).tobytes(),
        "pnm_pyp.ppm": b"PyP %d %d 255\n" % (w, h) + gray.astype(np.uint8).tobytes(),
    }


# --- QOI -----------------------------------------------------------------

def encode_qoi(pixels: np.ndarray) -> bytes:
    """A QOI file of (h, w, 3 or 4) uint8 pixels (the reference encoder's
    choice of ops), with its end marker."""
    h, w, c = pixels.shape
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, c, 0))
    index = [(0, 0, 0, 0)] * 64
    prev, run = (0, 0, 0, 255), 0
    flat = pixels.reshape(-1, c).tolist()
    for i, p in enumerate(flat):
        px = (p[0], p[1], p[2], p[3] if c == 4 else prev[3])
        if px == prev:
            run += 1
            if run == 62 or i == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        slot = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64
        if index[slot] == px:
            out.append(slot)
        else:
            index[slot] = px
            if px[3] == prev[3]:
                dr, dg, db = ((px[k] - prev[k] + 128) % 256 - 128 for k in range(3))
                if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
                elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7:
                    out += bytes([0x80 | (dg + 32), (dr - dg + 8) << 4 | (db - dg + 8)])
                else:
                    out += bytes([0xFE, *px[:3]])
            else:
                out += bytes([0xFF, *px])
        prev = px
    return bytes(out + b"\0" * 7 + b"\1")


def qoi_fixtures() -> dict:
    from PIL import Image

    def save(im):
        buf = io.BytesIO()
        im.save(buf, "QOI")
        return buf.getvalue()

    img = photo_like(22, 30, 70)
    rgba = np.concatenate([img, photo_like(22, 30, 71)[..., :1]], -1)
    # 4 x 3 pixels of every op: RGBA, RGB, DIFF, LUMA, INDEX of a slot written
    # and of one never written, RUN; a channel byte of 5 (RGBA to Pillow);
    # the last run passes the image and no end marker follows
    ops = bytes([0xFF, 10, 200, 30, 128, 0xFE, 40, 50, 60, 0x40 | 0b111001,
                 0x80 | 40, 0x5A, (10 * 3 + 200 * 5 + 30 * 7 + 128 * 11) % 64, 0x3F,
                 0xC0 | 2, 0xFE, 1, 2, 3, 0xC0 | 9])
    return {"qoi_rgb.qoi": save(Image.fromarray(img)),
            "qoi_rgba.qoi": save(Image.fromarray(rgba, "RGBA")),
            "qoi_encoded_rgb.qoi": encode_qoi(photo_like(17, 13, 72)),
            "qoi_every_op.qoi": b"qoif" + struct.pack(">IIBB", 4, 3, 5, 1) + ops}


# --- GIF -----------------------------------------------------------------

def lzw(indices, min_code: int, clear_every: int = 0) -> bytes:
    """GIF LZW of ``indices`` (codes grow as a decoder expects; a clear code
    after every ``clear_every`` codes), in sub-blocks, with the terminator."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    table = {bytes([i]): i for i in range(clear)}
    nxt, size = eoi + 1, min_code + 1
    codes = [(clear, size)]
    w = b""
    for v in indices:
        c = bytes([int(v)])
        if w + c in table:
            w += c
            continue
        codes.append((table[w], size))
        if nxt < 4096:
            table[w + c] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        if nxt >= 4096 or (clear_every and len(codes) % clear_every == 0):
            codes.append((clear, size))
            table = {bytes([i]): i for i in range(clear)}
            nxt, size = eoi + 1, min_code + 1
        w = c
    if w:
        codes.append((table[w], size))
    codes.append((eoi, size))
    acc = n = 0
    data = bytearray()
    for code, bits in codes:
        acc |= code << n
        n += bits
        while n >= 8:
            data.append(acc & 255)
            acc >>= 8
            n -= 8
    if n:
        data.append(acc & 255)
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out + b"\0")


def _table_bits(table: bytes) -> int:
    return max(1, int(np.ceil(np.log2(max(len(table) // 3, 2)))))


def gif_frame(indices: np.ndarray, x: int = 0, y: int = 0, local: bytes = None,
              interlace: bool = False, transparency=None, min_code: int = 8,
              clear_every: int = 0) -> bytes:
    """An image descriptor with its optional graphic control extension and
    local colour table, and its LZW data."""
    h, w = indices.shape
    out = bytearray()
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\0"
    flags = 0x40 if interlace else 0
    table = b""
    if local is not None:
        bits = _table_bits(local)
        flags |= 0x80 | (bits - 1)
        table = local + bytes(3 * (1 << bits) - len(local))
    order = list(range(h))
    if interlace:
        order = [*range(0, h, 8), *range(4, h, 8), *range(2, h, 4), *range(1, h, 2)]
    out += b"," + struct.pack("<HHHHB", x, y, w, h, flags) + table + bytes([min_code])
    return bytes(out + lzw(indices[order].reshape(-1), min_code, clear_every))


def encode_gif(width: int, height: int, frames, table: bytes = None,
               version: bytes = b"GIF89a", background: int = 0) -> bytes:
    """A GIF of a ``width`` x ``height`` screen, its global colour table and
    ``frames`` (from :func:`gif_frame`)."""
    out = bytearray(version + struct.pack("<HH", width, height))
    if table is not None:
        bits = _table_bits(table)
        out += bytes([0x80 | (bits - 1), background, 0]) + table + bytes(3 * (1 << bits)
                                                                         - len(table))
    else:
        out += bytes([0, background, 0])
    out += b"!\xfe\x0cport fixture\x00"  # a comment extension
    for f in frames:
        out += f
    return bytes(out + b";")


def _gif_table(colors: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, (colors, 3), dtype=np.uint8).tobytes()


def gif_fixtures() -> dict:
    h, w = 29, 41
    files = {}
    files["gif_global_256.gif"] = encode_gif(w, h, [gif_frame(indexed(h, w, 256, 31))],
                                             _gif_table(256, 32))
    files["gif_local_16_interlaced.gif"] = encode_gif(
        w, h, [gif_frame(indexed(h, w, 16, 33), local=_gif_table(16, 34), interlace=True,
                         min_code=4)], _gif_table(4, 35))
    gray = b"".join(bytes([i, i, i]) for i in range(256))
    files["gif_gray_ramp.gif"] = encode_gif(w, h, [gif_frame(indexed(h, w, 256, 36))], gray)
    files["gif_no_table.gif"] = encode_gif(w, h, [gif_frame(indexed(h, w, 256, 37))])
    files["gif_transparency.gif"] = encode_gif(
        w + 9, h + 6, [gif_frame(indexed(h, w, 16, 38), x=4, y=3, transparency=7, min_code=4)],
        _gif_table(16, 39), background=2)
    files["gif_frame_inside_screen.gif"] = encode_gif(
        w + 12, h + 8, [gif_frame(indexed(h, w, 64, 40), x=5, y=2, min_code=6)],
        _gif_table(64, 41), version=b"GIF87a", background=3)
    files["gif_frame_past_screen.gif"] = encode_gif(
        w - 10, h - 7, [gif_frame(indexed(h, w, 8, 42), x=3, y=2, min_code=3)],
        _gif_table(8, 43))
    files["gif_clear_codes_2bit.gif"] = encode_gif(
        w, h, [gif_frame(indexed(h, w, 4, 44), min_code=2, clear_every=37)], _gif_table(4, 45))
    files["gif_short_table.gif"] = encode_gif(  # indices past a 6-entry table
        w, h, [gif_frame(indexed(h, w, 32, 46), min_code=5)], _gif_table(6, 47))
    from PIL import Image

    frames = [Image.fromarray(photo_like(h, w, 48 + k)).quantize(64) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=40, loop=0)
    files["gif_pillow_animated.gif"] = buf.getvalue()
    big = indexed(LARGE, LARGE, 256, 49)
    files[f"gif_{LARGE}x{LARGE}.gif"] = encode_gif(LARGE, LARGE, [gif_frame(big)],
                                                   _gif_table(256, 50))
    return files


# --- WebP ----------------------------------------------------------------

def _chunks(data: bytes) -> list:
    """The (fourcc, payload) chunks of a RIFF WebP."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def encode_animated_webp(width: int, height: int, frames, flags: int = 0x12) -> bytes:
    """An animated WebP of a ``width`` x ``height`` canvas whose frames are
    (x, y, still WebP): each still's image chunks (ALPH, VP8 or VP8L) in an
    ANMF at the even offset (x, y); Pillow's encoder writes no first frame
    smaller than its canvas."""
    body = _chunk(b"VP8X", struct.pack("<I", flags) + (width - 1).to_bytes(3, "little")
                  + (height - 1).to_bytes(3, "little"))
    body += _chunk(b"ANIM", struct.pack("<IH", 0xFF204060, 0))
    for x, y, still in frames:
        image = b"".join(_chunk(c, p) for c, p in _chunks(still)
                         if c in (b"ALPH", b"VP8 ", b"VP8L"))
        info = _chunks(still)[0]
        if info[0] == b"VP8X":
            w = 1 + int.from_bytes(info[1][4:7], "little")
            h = 1 + int.from_bytes(info[1][7:10], "little")
        else:
            from PIL import Image

            with Image.open(io.BytesIO(still)) as im:
                w, h = im.size
        header = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                  + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                  + (100).to_bytes(3, "little") + bytes([0]))
        body += _chunk(b"ANMF", header + image)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def webp_fixtures() -> dict:
    from PIL import Image

    h, w = 48, 61
    img = photo_like(h, w, 61)
    alpha = photo_like(h, w, 62)[..., :1]
    rgba = Image.fromarray(np.concatenate([img, alpha], -1), "RGBA")

    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, "WEBP", **kw)
        return buf.getvalue()

    files = {}
    for q, m in ((5, 0), (40, 2), (75, 4), (90, 6), (100, 3)):
        files[f"webp_lossy_q{q}_m{m}.webp"] = save(Image.fromarray(img), quality=q, method=m)
    files["webp_lossy_odd_17x9.webp"] = save(Image.fromarray(photo_like(9, 17, 63)), quality=70)
    files["webp_lossy_alpha.webp"] = save(rgba, quality=80, alpha_quality=60)
    files["webp_lossy_alpha_q20_m6.webp"] = save(rgba, quality=20, alpha_quality=100, method=6)
    files["webp_lossless_photo.webp"] = save(Image.fromarray(img), lossless=True, quality=80)
    files["webp_lossless_fast.webp"] = save(Image.fromarray(img), lossless=True, quality=0,
                                            method=0)
    for colors in (2, 3, 4, 16, 200):
        pal = np.random.default_rng(colors).integers(0, 256, (colors, 3), dtype=np.uint8)
        files[f"webp_lossless_{colors}_colors.webp"] = save(
            Image.fromarray(pal[indexed(h, w, colors, 64 + colors)]), lossless=True)
    files["webp_lossless_alpha_exact.webp"] = save(rgba, lossless=True, exact=True)
    files["webp_vp8x_icc_exif.webp"] = save(Image.fromarray(img), quality=60,
                                            icc_profile=b"\0" * 40, exif=b"Exif\0\0" + bytes(20))
    frames = [Image.fromarray(photo_like(h, w, 70 + k)) for k in range(3)]
    frames[1] = Image.fromarray(np.asarray(frames[1]) // 2)
    files["webp_animated_lossy.webp"] = save(frames[0], save_all=True, append_images=frames[1:],
                                             quality=70, duration=40)
    files["webp_animated_lossless_rgba.webp"] = save(
        frames[0].convert("RGBA"), save_all=True, append_images=[f.convert("RGBA")
                                                                 for f in frames[1:]],
        lossless=True, duration=40)
    small = [Image.fromarray(photo_like(20 + 4 * k, 24 + 6 * k, 75 + k)) for k in range(2)]
    files["webp_animated_offset_frames.webp"] = encode_animated_webp(
        w, h, [(6, 4, save(small[0], quality=80)),
               (10, 8, save(small[1].convert("RGBA"), lossless=True))])
    big = Image.fromarray(photo_like(LARGE, LARGE, 80))
    files[f"webp_lossy_{LARGE}x{LARGE}.webp"] = save(big, quality=80)
    smooth = (indexed(LARGE, LARGE, 24, 81).astype(np.uint8) * 10)[..., None].repeat(3, -1)
    files[f"webp_lossless_{LARGE}x{LARGE}.webp"] = save(Image.fromarray(smooth), lossless=True)
    return files


def pil_record(data: bytes) -> dict:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        mode = im.mode
        rgb = np.asarray(im.convert("RGB"))
    return {"sha256": hashlib.sha256(rgb.tobytes()).hexdigest(), "shape": list(rgb.shape),
            "mode": mode}


def write_fixtures(folder: str = HERE) -> dict:
    """Writes every fixture and ``digests.json``; returns the digests."""
    files = {**bmp_fixtures(), **gif_fixtures(), **webp_fixtures(), **dib_fixtures(),
             **icon_fixtures(), **pnm_fixtures(), **qoi_fixtures()}
    for name in os.listdir(folder):
        if name.endswith(SUFFIXES) and name not in files:
            os.remove(os.path.join(folder, name))
    out = {"files": {}, "generated": {}}
    for name, data in sorted(files.items()):
        with open(os.path.join(folder, name), "wb") as f:
            f.write(data)
        out["files"][name] = pil_record(data)
    for name, data in sorted(generated_files().items()):
        out["generated"][name] = pil_record(data)
    with open(os.path.join(folder, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


if __name__ == "__main__":
    written = write_fixtures()
    total = 0
    for name, d in written["files"].items():
        size = os.path.getsize(os.path.join(HERE, name))
        total += size
        print(f"{name}: {size} bytes, {d['shape']}, {d['mode']}")
    print(f"{len(written['files'])} files, {total} bytes")
