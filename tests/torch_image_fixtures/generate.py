"""The WebP, GIF and BMP fixtures of the port's decoder tests, and the small
encoders that write what Pillow does not.

``python tests/torch_image_fixtures/generate.py`` (from the repository
root) writes the fixture files of this folder from a seed, and
``digests.json``: under ``files`` the sha256 of each file's
``Image.open(f).convert("RGB")`` bytes with its shape and Pillow's mode;
under ``generated`` the same for the files :func:`generated_files` writes
at run time (the 512 x 512 24-bit BMP of the decode timing, which would not
fit the folder). Run it where Pillow is installed; the card's host reads
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


def generated_files() -> dict:
    """The files built at run time (too large to commit)."""
    return {"bmp_24bpp_512x512.bmp": large_bmp()}


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
    files = {**bmp_fixtures(), **gif_fixtures(), **webp_fixtures()}
    for name in os.listdir(folder):
        if name.endswith((".bmp", ".gif", ".webp")) and name not in files:
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
