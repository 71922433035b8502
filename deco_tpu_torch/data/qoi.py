"""The port's QOI decoder (``csrc/qoi_decode.cpp``), bound with ``ctypes``.

:func:`decode` gives what ``np.asarray(Image.open(f).convert("RGB"))``
gives in the JAX package, byte for byte, with no PIL: the C++ source
follows Pillow's ``QoiImagePlugin`` (its op stream and index, RGBA with
the alpha dropped). What Pillow refuses raises ``ValueError``, so the
readers skip it where the JAX readers skip.
"""

from __future__ import annotations

import numpy as np

from deco_tpu_torch.data.host_decoder import HostDecoder

SIGNATURE = b"qoif"
DECODER = HostDecoder("qoi_decode", "qoi")


def is_qoi(data: bytes) -> bool:
    return data[:4] == SIGNATURE


def info(data: bytes) -> tuple[int, int, int]:
    """(height, width, channels) of a QOI header."""
    h, w, channels, _ = DECODER.info(data)
    return h, w, channels


def decode(data: bytes) -> np.ndarray:
    """A QOI image as (H, W, 3) uint8 RGB, equal to Pillow's ``convert("RGB")``."""
    return DECODER.decode(data)
