"""The port's Windows icon and cursor decoders (``csrc/bmp_decode.cpp``),
bound with ``ctypes``.

:func:`decode` gives what ``np.asarray(Image.open(f).convert("RGB"))``
gives in the JAX package, byte for byte, with no PIL. An icon follows
Pillow's ``IcoImagePlugin``: the entry of the largest area, then of the
lowest colour depth; a PNG frame decoded by :mod:`deco_tpu_torch.utils.png`,
a bitmap frame by the BMP reader with its height halved (the AND mask, or a
32-bit entry's alpha, checked as Pillow reads it and dropped as RGB drops
alpha). A cursor follows ``CurImagePlugin``: the largest cursor, its
height halved. What Pillow refuses raises ``ValueError``, so the readers
skip it where the JAX readers skip.
"""

from __future__ import annotations

import numpy as np

from deco_tpu_torch.data.host_decoder import HostDecoder
from deco_tpu_torch.utils import png

ICO_SIGNATURE = b"\0\0\1\0"
CUR_SIGNATURE = b"\0\0\2\0"
ICO = HostDecoder("bmp_decode", "ico")
CUR = HostDecoder("bmp_decode", "cur")


def is_ico(data: bytes) -> bool:
    return data[:4] == ICO_SIGNATURE


def is_cur(data: bytes) -> bool:
    return data[:4] == CUR_SIGNATURE


def decode(data: bytes) -> np.ndarray:
    """An icon or a cursor as (H, W, 3) uint8 RGB, equal to Pillow's
    ``convert("RGB")``."""
    if is_cur(data):
        return CUR.decode(data)
    png_at = ICO.info(data)[3]
    if png_at:
        return png.decode(bytes(data[png_at:]))
    return ICO.decode(data)
