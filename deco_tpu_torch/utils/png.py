"""PNG files without PIL: ``zlib``, ``struct`` and the port's C++ pixel decoder.

The port writes its sample images and reads PNG image folders without PIL.
:func:`encode` writes 8-bit RGB with no row filter. :func:`decode` reads
every well-formed PNG and returns what ``np.asarray(Image.open(f).convert(
"RGB"))`` gives, byte for byte: colour types 0, 2, 3, 4 and 6 at bit depths
1, 2, 4, 8 and 16 wherever the standard allows them, Adam7 interlace,
``tRNS`` (which changes no RGB value), ``PLTE`` in truecolour files (a
suggested palette, unread), short palettes (an index past the last entry is
black) and the default image of an APNG (the ``IDAT`` image). The rules
Pillow's modes follow are in ``csrc/png_decode.cpp``.

This module parses the chunks and inflates the image data with ``zlib``; the
per-byte work (the five row filters, Adam7, sub-byte samples, the palette,
the 16-bit rules) runs in ``csrc/png_decode.cpp``, built by the host C++
compiler at first use (``ops/_build.py``) and called through ``ctypes``,
which releases the GIL for the loader's threads. It is C++ because the
Average and Paeth filters depend on the byte just decoded, so Python undoes
them one byte at a time (:func:`unfilter_plain`, kept as the plain version
the tests compare against): ``time_png.py`` read 74-91 ms for the 512 x 512
RGB fixture Pillow wrote (Paeth on 94 of its rows) that way, against
9.2-9.5 ms with this decoder, on one core of an Intel Xeon (family 6 model
207). There is no Python path when the build fails: the decode raises.

Corrupt data raises ``ValueError`` where Pillow raises (its ``OSError``,
``SyntaxError`` or ``ValueError``), so the readers skip it where the JAX
readers skip: a bad checksum in a chunk before the image data, a chunk that
runs off the end of the file, a broken zlib stream (a bad Adler-32 the
inflate reaches included), image data that ends before the image, an
unknown row filter, an invalid header. As in Pillow, the checksums of the
image data and of the chunks after it are not checked, nor is the data
past the last row, and a missing ``IEND`` is no error.

:func:`encode_apng` writes frames as an animated PNG (APNG: ``acTL``,
``fcTL`` and ``fdAT`` chunks; the first frame is the ``IDAT`` image, which
readers without APNG support show), and :func:`decode_apng` reads back the
full-canvas frames that :func:`encode_apng` writes. The frames stay exact,
where a GIF would quantise them to a palette.
"""

from __future__ import annotations

import ctypes
import re
import struct
import threading
import zlib

import numpy as np

from deco_tpu_torch.ops import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> channels, for every pair the standard allows
_CHANNELS = {(d, 0): 1 for d in (1, 2, 4, 8, 16)}
_CHANNELS.update({(d, 3): 1 for d in (1, 2, 4, 8)})
_CHANNELS.update({(8, 2): 3, (16, 2): 3, (8, 4): 2, (16, 4): 2, (8, 6): 4, (16, 6): 4})
# Pillow's chunk handlers raise on these chunks when they are shorter
_MIN_LENGTH = {b"IHDR": 13, b"gAMA": 4, b"sRGB": 1, b"pHYs": 9, b"acTL": 8, b"fcTL": 26,
               b"fdAT": 4}
_CHUNK_TYPE = re.compile(rb"\w\w\w\w")
# Pillow refuses images of more than 2 x Image.MAX_IMAGE_PIXELS pixels
_MAX_PIXELS = 2 * 89478485
_ERRLEN = 256
_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The pixel decoder's library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("png_decode")
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                         ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_char_p, ctypes.c_int]
            lib.png_decode_rgb.restype = ctypes.c_int
            lib.png_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _rgb(image, what: str) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"png.{what}: expected (H, W, 3) uint8, got {image.dtype} {image.shape}")
    return image


def _image_data(image: np.ndarray) -> bytes:
    """The zlib stream of an (H, W, 3) image, filter 0 on every row."""
    h, w, _ = image.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # a leading 0 on each row: filter "None"
    rows[:, 1:] = image.reshape(h, 3 * w)
    return zlib.compress(rows.tobytes())


def _header(h: int, w: int) -> bytes:
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))


def encode(image: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as PNG bytes (filter 0 on every row)."""
    image = _rgb(image, "encode")
    return (SIGNATURE + _header(*image.shape[:2]) + _chunk(b"IDAT", _image_data(image))
            + _chunk(b"IEND", b""))


def encode_apng(frames, delay_ms: int = 100, loops: int = 0) -> bytes:
    """(H, W, 3) uint8 frames of one size as an animated PNG that shows each
    for ``delay_ms`` and plays ``loops`` times (0: forever)."""
    frames = [_rgb(f, "encode_apng") for f in frames]
    if not frames or any(f.shape != frames[0].shape for f in frames):
        raise ValueError("png.encode_apng: needs one or more frames of one size")
    h, w, _ = frames[0].shape
    out = [SIGNATURE, _header(h, w), _chunk(b"acTL", struct.pack(">II", len(frames), loops))]
    seq = 0
    for i, frame in enumerate(frames):
        # full canvas at (0, 0), delay delay_ms / 1000 s, dispose none, blend source
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, delay_ms, 1000,
                                               0, 0)))
        seq += 1
        data = _image_data(frame)
        if i == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_apng(path: str, frames, delay_ms: int = 100, loops: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode_apng(frames, delay_ms, loops))


def write(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(image))


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prior[i]) >> 1)) & 0xFF


def unfilter_plain(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of :func:`unfilter`: rows with filter None, Sub or
    Up undone with numpy; Average and Paeth, whose prediction depends on
    the byte just decoded, byte by byte in Python."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"png: image data holds {data.size} bytes, expected {h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            row = line
        elif kind == 1:  # Sub: a running sum of each channel along the row, mod 256
            row = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64) & 0xFF)
            row = row.astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = line + prior  # uint8 wraps mod 256
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prior.tobytes(), bpp)
            row = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"png: unknown row filter {kind}")
        out[y] = row
        prior = out[y]
    return out


def _check(code: int, err: ctypes.Array) -> None:
    if code:
        raise ValueError(err.value.decode(errors="replace"))


def unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``h`` rows of ``stride`` bytes, each led by
    its filter byte; (h, stride) uint8, in C++."""
    raw = bytes(raw)
    if len(raw) != h * (stride + 1):
        raise ValueError(f"png: image data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load().png_unfilter(raw, len(raw), h, stride, bpp,
                               out.ctypes.data_as(ctypes.c_void_p), err, _ERRLEN), err)
    return out


def _image_bytes(w: int, h: int, depth: int, color: int, interlace: int) -> int:
    """The bytes of inflated data an image needs: each non-empty pass's
    rows, each a filter byte and its packed samples."""
    bits = _CHANNELS[depth, color] * depth
    passes = (((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),))
    total = 0
    for x0, y0, dx, dy in passes:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:
            total += ph * (1 + (pw * bits + 7) // 8)
    return total


def _pixels(compressed: bytes, header: tuple, palette: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an image's zlib stream. Like Pillow, it
    inflates only as far as the image needs, so the data past the last row
    (and a stream that stops there) is not read."""
    w, h, depth, color, interlace = header
    need = _image_bytes(w, h, depth, color, interlace)
    try:
        raw = zlib.decompressobj().decompress(compressed, need)
    except zlib.error as e:
        raise ValueError(f"png: broken image data stream: {e}") from None
    if len(raw) < need:
        raise ValueError(f"png: image data is truncated ({len(raw)} of {need} bytes)")
    n_palette = min(len(palette) // 3, 256)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load().png_decode_rgb(raw, len(raw), w, h, depth, color, interlace,
                                 palette[:3 * n_palette], n_palette,
                                 out.ctypes.data_as(ctypes.c_void_p), err, _ERRLEN), err)
    return out


def _read_header(body: bytes) -> tuple:
    """(width, height, depth, colour type, interlace) of an IHDR body."""
    w, h, depth, color, _, filtering, interlace = struct.unpack(">IIBBBBB", body[:13])
    if filtering:
        raise ValueError(f"png: unknown filter method {filtering}")
    if (depth, color) not in _CHANNELS:
        raise ValueError(f"png: bit depth {depth} is not allowed for colour type {color}")
    if w == 0 or h == 0 or w >= 1 << 31 or h >= 1 << 31:
        raise ValueError(f"png: invalid image size {w} x {h}")
    if w * h > _MAX_PIXELS:
        raise ValueError(f"png: a PNG of {w} x {h} pixels: over Pillow's decompression-bomb "
                         "limit")
    return w, h, depth, color, int(interlace != 0)


def _check_body(kind: bytes, body: bytes, header) -> None:
    """Raise where Pillow's handler of this chunk raises on its length."""
    need = _MIN_LENGTH.get(kind, 0)
    if kind == b"tRNS" and header is not None and header[3] in (0, 2):
        need = 2 if header[3] == 0 else 6
    if len(body) < need:
        raise ValueError(f"png: truncated {kind.decode(errors='replace')} chunk")


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")`` gives
    them (the module docstring lists what that covers)."""
    data = bytes(data)
    if data[:8] != SIGNATURE:
        raise ValueError("png: not a PNG file")
    header, palette, animated = None, b"", False
    pos, n = 8, len(data)
    # the chunks before the image data: each checked, its checksum too
    while True:
        if pos + 8 > n:
            raise ValueError("png: no image data")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if not _CHUNK_TYPE.match(kind):
            raise ValueError(f"png: broken file (chunk type {kind!r})")
        if kind == b"IDAT":
            break
        if kind == b"IEND":
            raise ValueError("png: no image data")
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length or pos + 12 + length > n:
            raise ValueError("png: truncated chunk")
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"png: bad checksum in chunk {kind!r}")
        _check_body(kind, body, header)
        if kind == b"IHDR":
            header = _read_header(body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"acTL":
            # Pillow takes a valid acTL, and a second one turns the animation off
            animated = not animated and 0 < struct.unpack(">I", body[:4])[0] <= 0x80000000
        elif kind == b"fcTL" and header is not None:
            fw, fh, fx, fy = struct.unpack(">IIII", body[4:20])
            if (fw, fh, fx, fy) != (header[0], header[1], 0, 0):
                raise ValueError("png: the first APNG frame does not cover the canvas")
        pos += 12 + length
    if header is None:
        raise ValueError("png: image data before the header")
    # the first run of IDAT chunks: a chunk cut short gives what it holds
    parts = []
    while pos + 8 <= n:
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind != b"IDAT":
            break
        parts.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    image = _pixels(b"".join(parts), header, palette if header[3] == 3 else b"")
    _check_after(data, pos, header, animated)
    return image


def _check_after(data: bytes, pos: int, header: tuple, animated: bool) -> None:
    """The chunks after the image data, as Pillow reads them once the image
    is decoded: no checksum, but a chunk that runs off the end of the file
    or that its handler finds too short raises; a cut chunk header, a
    broken chunk type, ``IEND`` or an animation's next ``fcTL`` ends them."""
    n = len(data)
    while pos + 8 <= n:
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if not _CHUNK_TYPE.match(kind) or kind == b"IEND" or (animated and kind == b"fcTL"):
            return
        if pos + 8 + length > n:
            raise ValueError(f"png: truncated {kind.decode()} chunk")
        _check_body(kind, data[pos + 8:pos + 8 + length], header)
        pos += 12 + length


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def _chunks(data: bytes):
    """(kind, body) of each chunk after the signature."""
    if data[:8] != SIGNATURE:
        raise ValueError("png: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("png: truncated chunk")
        pos += 12 + length
        yield kind, body
        if kind == b"IEND":
            return


def decode_apng(data: bytes) -> tuple[list, list]:
    """An animated PNG from :func:`encode_apng` -> (frames, delays in ms):
    (H, W, 3) uint8 RGB frames that each cover the whole canvas, decoded as
    :func:`decode` decodes the ``IDAT`` image."""
    header, palette, frames, delays, parts = None, b"", [], [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _read_header(body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"fcTL":
            if parts is not None:
                frames.append(parts)
            _, fw, fh, x, y, num, den, _, _ = struct.unpack(">IIIIIHHBB", body)
            if header is None or (fw, fh, x, y) != (header[0], header[1], 0, 0):
                raise ValueError("png: only full-canvas APNG frames are supported")
            delays.append(1000.0 * num / (den or 100))
            parts = []
        elif kind == b"IDAT" and parts is not None:
            parts.append(body)
        elif kind == b"fdAT":
            parts.append(body[4:])  # after the sequence number
    if parts is not None:
        frames.append(parts)
    if header is None or not frames:
        raise ValueError("png: not an animated PNG")
    palette = palette if header[3] == 3 else b""
    return [_pixels(b"".join(p), header, palette) for p in frames], delays


def read_apng(path: str) -> tuple[list, list]:
    with open(path, "rb") as f:
        return decode_apng(f.read())
