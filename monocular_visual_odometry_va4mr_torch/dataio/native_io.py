"""ctypes bindings of the native PNG decoder (port of ``dataio/native_io.py``).

The library is the port's own ``csrc/mvo_io.cpp``, built with ``g++`` at
first use into ``build/torch_kernels/`` (``_build.build_host``): a minimal
PNG decoder and a C++ worker pool that decodes frames ahead of the device
loop.  There is no fallback: a library that does not build raises, and the
port never loads the JAX package's prebuilt ``native/libmvo_io.so``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import _build

_MAX_PIXELS = 4096 * 4096
_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_INT_P = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("mvo_io")
    lib.mvo_decode_png.restype = ctypes.c_int
    lib.mvo_decode_png.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_int,
                                   _INT_P, _INT_P]
    lib.mvo_open_sequence.restype = ctypes.c_void_p
    lib.mvo_open_sequence.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
    lib.mvo_next_frame.restype = ctypes.c_int
    lib.mvo_next_frame.argtypes = [ctypes.c_void_p, _FLOAT_P, ctypes.c_int,
                                   _INT_P, _INT_P]
    lib.mvo_close_sequence.restype = None
    lib.mvo_close_sequence.argtypes = [ctypes.c_void_p]
    return lib


def decode_png(path: str) -> Optional[np.ndarray]:
    """Decode one PNG to an (H, W) float32 gray image in [0, 255]; None for
    a file the decoder does not support (palette, interlaced, other bit
    depths) or cannot read."""
    buf = np.empty(_MAX_PIXELS, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = _lib().mvo_decode_png(str(path).encode(),
                               buf.ctypes.data_as(_FLOAT_P), _MAX_PIXELS,
                               ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class PrefetchingReader:
    """Ordered iterator over decoded frames: ``num_threads`` C++ workers
    decode up to ``prefetch`` frames ahead of the consumer.  ``close()``
    (also at the end of a ``with`` block) stops the workers, halfway through
    the stream too."""

    def __init__(self, paths: List[str], num_threads: int = 4,
                 prefetch: int = 8):
        if num_threads < 1 or prefetch < 1:
            raise ValueError(f"num_threads={num_threads} and "
                             f"prefetch={prefetch} must be >= 1")
        self._lib = _lib()
        arr = (ctypes.c_char_p * len(paths))(*[str(p).encode()
                                               for p in paths])
        self._handle = self._lib.mvo_open_sequence(arr, len(paths),
                                                   num_threads, prefetch)
        self._n = len(paths)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        buf = np.empty(_MAX_PIXELS, np.float32)
        w, h = ctypes.c_int(), ctypes.c_int()
        for i in range(self._n):
            if not self._handle:
                raise IOError("the reader is closed")
            rc = self._lib.mvo_next_frame(self._handle,
                                          buf.ctypes.data_as(_FLOAT_P),
                                          _MAX_PIXELS, ctypes.byref(w),
                                          ctypes.byref(h))
            if rc != 0:
                raise IOError(f"native decode failed at frame {i}")
            yield i, buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle:
            self._lib.mvo_close_sequence(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
