"""The port's BMP decoder (``csrc/bmp_decode.cpp``), bound with ``ctypes``.

:func:`decode` gives what ``np.asarray(Image.open(f).convert("RGB"))``
gives in the JAX package, byte for byte, with no PIL: the C++ source
follows Pillow's ``BmpImagePlugin`` (its headers, palettes, raw unpackers
and its Python RLE decoder); :func:`decode_dib` reads a DIB, a BMP without
its file header. What Pillow refuses raises ``ValueError``, so
the readers skip it where the JAX readers skip.
"""

from __future__ import annotations

import numpy as np

from deco_tpu_torch.data.host_decoder import HostDecoder

SIGNATURE = b"BM"
DECODER = HostDecoder("bmp_decode", "bmp")
DIB = HostDecoder("bmp_decode", "dib")
DIB_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)


def is_bmp(data: bytes) -> bool:
    return data[:2] == SIGNATURE


def is_dib(data: bytes) -> bool:
    """Pillow's ``BmpImagePlugin._dib_accept``: a bare info header."""
    return len(data) >= 4 and int.from_bytes(data[:4], "little") in DIB_HEADER_SIZES


def info(data: bytes) -> tuple[int, int, int, bool]:
    """(height, width, bits a pixel, RLE) of a BMP's headers."""
    h, w, bits, rle = DECODER.info(data)
    return h, w, bits, bool(rle)


def decode(data: bytes) -> np.ndarray:
    """A BMP as (H, W, 3) uint8 RGB, equal to Pillow's ``convert("RGB")``."""
    return DECODER.decode(data)


def decode_dib(data: bytes) -> np.ndarray:
    """A DIB (a BMP without its file header, Pillow's ``DibImageFile``) as
    (H, W, 3) uint8 RGB, equal to Pillow's ``convert("RGB")``."""
    return DIB.decode(data)
