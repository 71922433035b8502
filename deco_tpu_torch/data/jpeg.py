"""The port's JPEG decoder (``csrc/jpeg_decode.cpp``), bound with ``ctypes``.

:func:`decode` gives what ``np.asarray(Image.open(f).convert("RGB"))``
gives in the JAX package, byte for byte, with no PIL and no libjpeg: the
C++ source mirrors libjpeg-turbo's defaults (ISLOW IDCT, fancy upsampling,
block smoothing of progressive files, the jdcolor.c tables) and Pillow's
CMYK handling. It reads every kind Pillow reads (:data:`KINDS`): baseline,
extended and progressive Huffman JPEG, arithmetic-coded JPEG, sequential
and progressive, and lossless JPEG. The host C++ compiler builds it at
first use (``ops/_build.py``), here and on the card's host alike.

Corrupt entropy-coded data decodes as libjpeg-turbo decodes it (a bad
Huffman or arithmetic code, a segment cut short, restart markers out of
order). A truncated stream, or one Pillow or libjpeg refuses (samples of
other than 8 bits, hierarchical JPEG, lossless arithmetic coding, a
lossless frame in YCbCr, arithmetic-coded data past what Pillow hands
libjpeg in one go), raises ``ValueError`` where Pillow raises ``OSError``,
so the readers skip it where the JAX readers skip. The decoder keeps no
global state, and ``ctypes`` releases the GIL during a call, so the
loader's threads decode at once.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from deco_tpu_torch.ops import _build

SIGNATURE = b"\xff\xd8\xff"
KINDS = ("baseline", "extended", "progressive", "lossless", "arithmetic",
         "arithmetic-progressive")
_ERRLEN = 256
_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The decoder's library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("jpeg_decode")
            lib.jpeg_info.restype = ctypes.c_int
            lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                                      ctypes.c_int]
            lib.jpeg_decode_rgb.restype = ctypes.c_int
            lib.jpeg_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                            ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def is_jpeg(data: bytes) -> bool:
    return data[:3] == SIGNATURE


def _raise(code: int, err: ctypes.Array) -> None:
    raise ValueError(err.value.decode(errors="replace"))


def info(data: bytes) -> tuple[int, int, int, str]:
    """(height, width, components, kind) of a JPEG's frame header; kind is
    one of :data:`KINDS`."""
    out = (ctypes.c_int * 4)()
    err = ctypes.create_string_buffer(_ERRLEN)
    code = load().jpeg_info(data, len(data), out, err, _ERRLEN)
    if code:
        _raise(code, err)
    return out[0], out[1], out[2], KINDS[out[3]]


def decode(data: bytes) -> np.ndarray:
    """A JPEG as (H, W, 3) uint8 RGB, equal to Pillow's ``convert("RGB")``:
    :func:`info` sizes the array, and the C decode reads the headers once
    more and checks that size."""
    data = bytes(data)
    h, w, _, _ = info(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    code = load().jpeg_decode_rgb(data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                                  out.nbytes, err, _ERRLEN)
    if code:
        _raise(code, err)
    return out

