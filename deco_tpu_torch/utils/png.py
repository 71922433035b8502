"""PNG files with the standard library: ``zlib`` and ``struct``.

The port writes its sample images and reads PNG image folders without PIL.
:func:`encode` writes 8-bit RGB with no row filter. :func:`decode` reads
8-bit gray, RGB and RGBA non-interlaced files with any of the five row
filters and returns RGB; a well-formed PNG of any other kind raises
:class:`UnsupportedPNG`, and bytes that are not a sound PNG ``ValueError``
(``zlib.error`` for a broken data stream).
:func:`encode_apng` writes frames as an animated PNG (APNG: ``acTL``,
``fcTL`` and ``fdAT`` chunks; the first frame is the ``IDAT`` image, which
readers without APNG support show), and :func:`decode_apng` reads back the
full-canvas frames that :func:`encode_apng` writes. The frames stay exact,
where a GIF would quantise them to a palette.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels; 0 gray, 2 RGB, 6 RGBA
_CHANNELS = {0: 1, 2: 3, 6: 4}


class UnsupportedPNG(ValueError):
    """A PNG that other readers (PIL) take and :func:`decode` does not:
    palette, 16-bit or interlaced images."""


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


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters; (h, stride) uint8. Rows with filter None,
    Sub or Up are undone with numpy; Average and Paeth, whose prediction
    depends on the byte just decoded, byte by byte."""
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


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB. Gray is repeated over the three
    channels and alpha dropped, as PIL's ``convert("RGB")`` does."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise UnsupportedPNG("png: palette images are not supported")
    if header is None or not idat:
        raise ValueError("png: missing IHDR or IDAT")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS or compression or filtering or interlace:
        raise UnsupportedPNG(f"png: unsupported format (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}); 8-bit gray/RGB/RGBA non-interlaced only")
    ch = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if ch == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


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
    8-bit RGB frames that each cover the whole canvas."""
    header, frames, delays, parts = None, [], [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
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
    w, h, depth, color = header[:4]
    if depth != 8 or color != 2:
        raise ValueError("png: decode_apng reads 8-bit RGB only")
    images = [_unfilter(zlib.decompress(b"".join(p)), h, 3 * w, 3).reshape(h, w, 3)
              for p in frames]
    return images, delays


def read_apng(path: str) -> tuple[list, list]:
    with open(path, "rb") as f:
        return decode_apng(f.read())
