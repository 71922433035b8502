"""The port's PNM decoder (``csrc/pnm_decode.cpp``), bound with ``ctypes``.

:func:`decode` gives what ``np.asarray(Image.open(f).convert("RGB"))``
gives in the JAX package, byte for byte, with no PIL: the C++ source
follows Pillow's ``PpmImagePlugin`` (P1-P6 plain and raw, Pf, and Pillow's
own P0CMYK and Py* headers; maxval scaling as its ``PpmDecoder`` and
``PpmPlainDecoder`` round; mode I above maxval 255, clipped to RGB as
Pillow converts it). What Pillow refuses raises ``ValueError``, so the
readers skip it where the JAX readers skip.
"""

from __future__ import annotations

import numpy as np

from deco_tpu_torch.data.host_decoder import HostDecoder

DECODER = HostDecoder("pnm_decode", "pnm")


def is_pnm(data: bytes) -> bool:
    """Pillow's ``PpmImagePlugin._accept``."""
    return len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy"


def info(data: bytes) -> tuple[int, int, str, bool]:
    """(height, width, Pillow's mode, plain) of a PNM header."""
    h, w, mode, plain = DECODER.info(data)
    return h, w, {"R": "RGB", "A": "RGBA", "C": "CMYK"}.get(chr(mode), chr(mode)), bool(plain)


def decode(data: bytes) -> np.ndarray:
    """A PNM as (H, W, 3) uint8 RGB, equal to Pillow's ``convert("RGB")``."""
    return DECODER.decode(data)
