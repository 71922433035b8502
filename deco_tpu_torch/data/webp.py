"""The port's WebP decoder (``csrc/webp_decode.cpp``), bound with ``ctypes``.

:func:`decode` gives what ``np.asarray(Image.open(f).convert("RGB"))``
gives in the JAX package, byte for byte, with no PIL and no libwebp.
Pillow opens a WebP through libwebp's ``WebPAnimDecoder``, and the C++
source follows that path: the demuxer's checks of the container, the first
frame on its zeroed canvas, VP8L, VP8 with libwebp's fancy upsampling and
YUV to RGB, and the ALPH chunk as far as it can fail. What Pillow refuses
raises ``ValueError``, so the readers skip it where the JAX readers skip.
"""

from __future__ import annotations

import numpy as np

from deco_tpu_torch.data.host_decoder import HostDecoder

SIGNATURE = b"WEBP"  # at bytes 8-12, after "RIFF" and its size
DECODER = HostDecoder("webp_decode", "webp")


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == SIGNATURE


def info(data: bytes) -> tuple[int, int, int, bool]:
    """(height, width, frames, lossless) of a WebP: its canvas, the number
    of frames and whether the first is VP8L."""
    h, w, frames, lossless = DECODER.info(data)
    return h, w, frames, bool(lossless)


def decode(data: bytes) -> np.ndarray:
    """A WebP's first frame on its canvas as (H, W, 3) uint8 RGB, equal to
    Pillow's ``convert("RGB")``."""
    return DECODER.decode(data)
