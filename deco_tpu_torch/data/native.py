"""ctypes binding of the native data plane (``native/libdataplane.so``).

The library (``native/dataplane.cpp``, built by ``scripts/build_native.sh``,
which needs g++ and libjpeg) decodes JPEG with libjpeg's ISLOW DCT, as PIL
does, and runs the ADM center crop with a PIL-compatible resampler. This is
the port's own copy of ``deco_tpu/data/native.py``; it is the port's only
JPEG decoder, so a JPEG read without the library raises with the build
command.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libdataplane.so")
BUILD_COMMAND = "bash scripts/build_native.sh"
_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The data-plane library; raises when it is not built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(LIB_PATH):
            raise RuntimeError(f"reading JPEG needs {LIB_PATH}: build it with `{BUILD_COMMAND}` "
                               "(g++ and libjpeg)")
        lib = ctypes.CDLL(LIB_PATH)
        lib.dp_version.restype = ctypes.c_int
        lib.dp_version.argtypes = []
        if lib.dp_version() != 1:
            raise RuntimeError(f"{LIB_PATH}: unexpected data-plane version {lib.dp_version()}")
        lib.dp_decode_jpeg_adm.restype = ctypes.c_int
        lib.dp_decode_jpeg_adm.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                           ctypes.c_void_p]
        lib.dp_resize.restype = ctypes.c_int
        lib.dp_resize.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def decode_jpeg_adm(jpeg_bytes: bytes, resolution: int) -> np.ndarray:
    """One JPEG -> (resolution, resolution, 3) uint8 through the ADM center crop."""
    lib = load()
    out = np.empty((resolution, resolution, 3), np.uint8)
    rc = lib.dp_decode_jpeg_adm(jpeg_bytes, len(jpeg_bytes), resolution,
                                out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"dp_decode_jpeg_adm failed with code {rc} "
                         "(1: not a decodable RGB/gray JPEG, 2: smaller than the resolution)")
    return out
