"""The port's GIF decoder (``csrc/gif_decode.cpp``), bound with ``ctypes``.

:func:`decode` gives the first frame as
``np.asarray(Image.open(f).convert("RGB"))`` gives it in the JAX package,
byte for byte, with no PIL: the C++ source follows Pillow's
``GifImagePlugin`` (the blocks before the first image, its palette and
canvas rules) and its LZW decoder. What Pillow refuses raises
``ValueError``, so the readers skip it where the JAX readers skip.
"""

from __future__ import annotations

import numpy as np

from deco_tpu_torch.data.host_decoder import HostDecoder

SIGNATURES = (b"GIF87a", b"GIF89a")
DECODER = HostDecoder("gif_decode", "gif")


def is_gif(data: bytes) -> bool:
    return data[:6] in SIGNATURES


def info(data: bytes) -> tuple[int, int, str, bool]:
    """(height, width, mode, interlaced) of a GIF's first frame: the mode is
    Pillow's, "P" or "L" (a gray-ramp colour table, or none)."""
    h, w, paletted, interlaced = DECODER.info(data)
    return h, w, "P" if paletted else "L", bool(interlaced)


def decode(data: bytes) -> np.ndarray:
    """A GIF's first frame as (H, W, 3) uint8 RGB, equal to Pillow's
    ``convert("RGB")``."""
    return DECODER.decode(data)
