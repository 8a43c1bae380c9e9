"""PyTorch / CUDA port of the monocular visual-odometry framework.

The JAX package ``monocular_visual_odometry_va4mr_tpu`` is the reference this
port is held against; the layout mirrors it (``core/``, ``ops/``,
``backend/``, ``pipeline/``, ``dataio/``, ``evalx/``, ``viz/``,
``parallel/``), so every module's counterpart sits at the same path.  Plain
tensor code is PyTorch; each Pallas kernel of the reference is a
hand-written CUDA kernel for Hopper, built with ``nvcc`` at first use:
``ops/klt_pallas2.py::_klt2_kernel`` as ``csrc/klt_lk.cu`` and
``ops/klt_pallas.py::_klt_kernel`` as ``csrc/klt_v1.cu``.  The native PNG
decoder is host C++, ``csrc/mvo_io.cpp``, built with ``g++`` at first use.

This package imports ``torch`` and never ``jax``.  Entry points run on
``cuda`` unless asked otherwise.
"""
import torch as _torch

__version__ = "0.1.0"

# The geometry (8-point normal matrices, triangulation normal equations,
# Schur-complement BA) relies on full float32 accumulation; TF32 keeps about
# three decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
