"""Builds the package's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled into
``build/torch_kernels/<name>-<hash>.so`` at the root of the checkout (a
directory ``.gitignore`` lists), then loaded with ``ctypes``.  The hash
covers the source and the flags, so an edited kernel is rebuilt and a stale
library is never loaded.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# -fmad=false: no contraction of a*b+c into one FMA, so the kernel rounds
# every product and sum as the plain PyTorch twin does, op by op.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built from source at first use")
    return path


def build(name: str, src: Path = None):
    """Compile ``csrc/<name>.cu`` (or the source ``src``) unless an
    up-to-date library exists.

    Returns (library path, compiler log, seconds spent compiling)."""
    src = Path(src) if src is not None else CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, proc.stdout + proc.stderr, seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, loaded once per process."""
    lib, _, _ = build(name)
    return ctypes.CDLL(str(lib))


def bind(lib: ctypes.CDLL, name: str, argtypes: tuple):
    """``<name>_launch`` of ``lib`` with its ctypes signature set: it returns
    the launch's ``cudaError_t`` as a C int."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def entry(name: str, argtypes: tuple):
    """The entry point of ``csrc/<name>.cu``, built, loaded and bound once
    per process."""
    return bind(load(name), name, argtypes)
