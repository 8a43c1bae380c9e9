"""Closed-form small-matrix helpers (port of ``core/linalg.py``).

Batched 2x2 / 3x3 inverses in adjugate form: pure elementwise arithmetic over
any leading batch shape, used by every small solve on the hot path.
``constant`` gives a small constant tensor on a device, made there once and
kept, so a captured step (``pipeline/vo.py``) reads it and copies nothing
from the host.
"""
from __future__ import annotations

import numpy as np
import torch

_CONSTANTS = {}


def constant(values, device) -> torch.Tensor:
    """The float32 tensor of the nested list ``values`` on ``device``, made
    at the first call for these values and device and the same tensor at
    every later one.  Callers never write to it."""
    a = np.asarray(values, np.float32)
    device = torch.device("cpu" if device is None else device)
    key = (a.shape, a.tobytes(), device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.from_numpy(a).to(device)
    return _CONSTANTS[key]


def _safe_det(det: torch.Tensor) -> torch.Tensor:
    return torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)


def inv2(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2x2 inverse."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = _safe_det(a * d - b * c)
    row0 = torch.stack([d, -b], -1)
    row1 = torch.stack([-c, a], -1)
    return torch.stack([row0, row1], -2) / det[..., None, None]


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = _safe_det(a * A + b * B + c * C)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def solve3(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve via the closed-form inverse."""
    return torch.einsum("...ij,...j->...i", inv3(M), b)
