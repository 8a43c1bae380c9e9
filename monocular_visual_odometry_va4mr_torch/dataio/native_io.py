"""ctypes bindings of the native PNG decoder (port of ``dataio/native_io.py``),
and a writer of the 8-bit gray PNGs it reads.

The library is the port's own ``csrc/mvo_io.cpp``, built with ``g++`` at
first use into ``build/torch_kernels/`` (``_build.build_host``): a minimal
PNG decoder and a C++ worker pool that decodes frames ahead of the device
loop.  There is no fallback: a library that does not build raises, and the
port never loads the JAX package's prebuilt ``native/libmvo_io.so``.

The writer (:func:`png_gray`, :func:`write_png`, :func:`write_kitti`) is
numpy and ``zlib`` only, so frames reach disk in the KITTI layout without
cv2.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import os
import struct
import zlib
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


# --- writer ------------------------------------------------------------------

def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def png_gray(img: np.ndarray) -> bytes:
    """8-bit gray PNG bytes of (H, W) uint8 ``img``.  Row y takes filter
    y % 5 (None, Sub, Up, Average, Paeth), so a decode runs every
    reconstruction path."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected a 2-D uint8 image, got {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    f = np.arange(H) % 5
    pred = np.stack([np.zeros_like(x), a, b, (a + b) // 2, paeth])
    rows = np.empty((H, W + 1), np.uint8)
    rows[:, 0] = f
    rows[:, 1:] = (x - pred[f, np.arange(H)]) & 0xFF
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """``img`` as an 8-bit gray PNG at ``path``, written to a temporary file
    of this process and renamed over ``path``: a reader sees the whole file
    or none."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(png_gray(img))
    os.replace(tmp, path)


def kitti_paths(root: str, sequence: str = "05") -> Tuple[str, str]:
    """(image directory, poses file) of a KITTI-layout root."""
    return (os.path.join(root, sequence, "image_0"),
            os.path.join(root, "poses", f"{sequence}.txt"))


def write_poses(path: str, poses_WC: np.ndarray) -> None:
    """(N, 4, 4) camera-to-world poses as KITTI's rows of 12 (the 3x4 top)."""
    np.savetxt(path, np.asarray(poses_WC)[:, :3, :].reshape(
        len(poses_WC), 12))


def write_kitti(root: str, u8, poses_WC: np.ndarray,
                sequence: str = "05") -> None:
    """``u8`` frames as ``<seq>/image_0/{i:06d}.png`` and their poses as
    ``poses/<seq>.txt``: the KITTI layout ``datasets.load_kitti`` reads.
    The PNGs are encoded by a thread per core (``zlib`` releases the GIL)."""
    img_dir, pose_file = kitti_paths(root, sequence)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.dirname(pose_file), exist_ok=True)
    write_poses(pose_file, poses_WC)

    def one(i):
        write_png(os.path.join(img_dir, f"{i:06d}.png"), u8[i])

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(one, range(len(u8))))
