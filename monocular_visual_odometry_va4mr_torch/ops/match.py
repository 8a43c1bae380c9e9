"""Brute-force descriptor matching with Lowe's ratio test (port of
``ops/match.py``).

The squared-distance matrix is one matmul in the reference's expanded form
|a|^2 - 2 a.b^T + |b|^2 (not ``torch.cdist``, whose float32 rounding
differs).  The two nearest neighbours are those of ``lax.top_k(-d2, 2)``
with its tie order (the lowest index first): the argmin, then the minimum
with that one column masked.  Any leading batch shape is accepted, so the
loop verifier matches a chunk of keyframe pairs in one call.
"""
from __future__ import annotations

import torch

_BIG = 1e12


def match_ratio(desc0: torch.Tensor, valid0: torch.Tensor,
                desc1: torch.Tensor, valid1: torch.Tensor, *,
                ratio: float = 0.8, cross_check: bool = False):
    """(..., N0, D), (..., N0), (..., N1, D), (..., N1) -> (idx1 (..., N0)
    int64, ok (..., N0) bool): for each valid row of desc0, its
    ratio-test-passing nearest neighbour in desc1."""
    d2 = (torch.sum(desc0 ** 2, -1, keepdim=True)
          - 2.0 * desc0 @ desc1.transpose(-1, -2)
          + torch.sum(desc1 ** 2, -1)[..., None, :])
    d2 = torch.where(valid1[..., None, :], d2, _BIG)

    idx1 = torch.argmin(d2, -1)
    best = torch.gather(d2, -1, idx1[..., None])[..., 0]
    first = torch.arange(d2.shape[-1], device=d2.device) == idx1[..., None]
    second = torch.amin(torch.where(first, torch.inf, d2), -1)

    ok = valid0 & (best < ratio * ratio * second) & (best < _BIG)
    if cross_check:
        d2b = torch.where(valid0[..., :, None], d2, _BIG)
        back = torch.argmin(d2b, -2)  # (..., N1)
        rows = torch.arange(d2.shape[-2], device=d2.device)
        ok = ok & (torch.gather(back, -1, idx1) == rows)
    return idx1, ok
