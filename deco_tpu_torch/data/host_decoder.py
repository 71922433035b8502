"""A host C++ image decoder of ``csrc/`` bound with ``ctypes``: the WebP,
GIF and BMP decoders' shared binding.

Each source exports ``<prefix>_info(data, size, int out[4], err, errlen)``
and ``<prefix>_decode_rgb(data, size, out, out_size, err, errlen)``, both
returning 0, or 1 with a message for bytes Pillow refuses. The library is
built at first use (``ops/_build.py``), and ``ctypes`` releases the GIL
during a call, so the loader's threads decode at once.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from deco_tpu_torch.ops import _build

_ERRLEN = 256


class HostDecoder:
    """``csrc/<source>.cpp``'s ``<prefix>_info`` and ``<prefix>_decode_rgb``."""

    def __init__(self, source: str, prefix: str):
        self.source, self.prefix = source, prefix
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """The decoder's library, built at first use."""
        with self._lock:
            if self._lib is None:
                lib = _build.load(self.source)
                info = getattr(lib, f"{self.prefix}_info")
                info.restype = ctypes.c_int
                info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
                decode = getattr(lib, f"{self.prefix}_decode_rgb")
                decode.restype = ctypes.c_int
                decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
                self._lib = lib
            return self._lib

    def info(self, data: bytes) -> tuple[int, int, int, int]:
        """The four values ``<prefix>_info`` writes, height and width first;
        ``ValueError`` for bytes Pillow refuses."""
        out = (ctypes.c_int * 4)()
        err = ctypes.create_string_buffer(_ERRLEN)
        if getattr(self.load(), f"{self.prefix}_info")(data, len(data), out, err, _ERRLEN):
            raise ValueError(err.value.decode(errors="replace"))
        return out[0], out[1], out[2], out[3]

    def decode(self, data: bytes) -> np.ndarray:
        """The image as (H, W, 3) uint8 RGB: :meth:`info` sizes the array,
        and the C decode reads the headers once more and checks that size."""
        data = bytes(data)
        h, w, _, _ = self.info(data)
        out = np.empty((h, w, 3), np.uint8)
        err = ctypes.create_string_buffer(_ERRLEN)
        if getattr(self.load(), f"{self.prefix}_decode_rgb")(
                data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes, err, _ERRLEN):
            raise ValueError(err.value.decode(errors="replace"))
        return out
