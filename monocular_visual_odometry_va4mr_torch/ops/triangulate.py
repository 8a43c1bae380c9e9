"""Batched two-view triangulation and promotion gates (port of
``ops/triangulate.py``): DLT normal equations solved in closed form, the
baseline-angle gate and the two-view depth gate.
"""
from __future__ import annotations

import torch

from ..core import linalg
from ..core.camera import Camera, projection_matrix


def triangulate_dlt(P0: torch.Tensor, P1: torch.Tensor, uv0: torch.Tensor,
                    uv1: torch.Tensor) -> torch.Tensor:
    """DLT triangulation with w = 1: (..., 3, 4) projections and (..., 2)
    pixel observations -> (..., 3) world points."""
    rows = torch.stack(
        [
            uv0[..., 0, None] * P0[..., 2, :] - P0[..., 0, :],
            uv0[..., 1, None] * P0[..., 2, :] - P0[..., 1, :],
            uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        ],
        -2,
    )  # (..., 4, 4)
    norm = torch.linalg.vector_norm(rows, dim=-1, keepdim=True)
    rows = rows / torch.clamp(norm, min=1e-12)
    M = rows[..., :3]
    a = rows[..., 3]
    N = linalg.einsum("...ki,...kj->...ij", M, M)
    b = -linalg.einsum("...ki,...k->...i", M, a)
    return linalg.solve3(N, b)


def bearing_angle_deg(cam: Camera, uv0, uv1, R0_CW, R1_CW) -> torch.Tensor:
    """Angle in degrees between the two viewing rays, compared in the world
    frame: d_i = R_i_CW^T K^-1 hom(uv_i).  R0_CW (..., 3, 3), R1_CW (3, 3)."""
    r0 = cam.backproject(uv0)
    r1 = cam.backproject(uv1)
    d0 = linalg.einsum("...ji,...j->...i", R0_CW, r0)
    d1 = linalg.einsum("ji,...j->...i", R1_CW, r1)
    cos = torch.sum(d0 * d1, -1) / (
        torch.linalg.vector_norm(d0, dim=-1)
        * torch.linalg.vector_norm(d1, dim=-1) + 1e-12)
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def depth_gate(X, T0_CW, T1_CW, min_dist: float,
               max_dist: float) -> torch.Tensor:
    """z in (min_dist, max_dist) in both camera frames."""
    z0 = linalg.einsum("...j,...j->...", T0_CW[..., 2, :3], X) + T0_CW[..., 2, 3]
    z1 = linalg.matmul(X, T1_CW[2, :3]) + T1_CW[2, 3]
    return (z0 > min_dist) & (z0 < max_dist) & (z1 > min_dist) & (z1 < max_dist)


def triangulate_candidates(
    cam: Camera,
    uv_first: torch.Tensor,  # (M, 2)
    uv_cur: torch.Tensor,  # (M, 2)
    T_CW_first: torch.Tensor,  # (M, 4, 4)
    T_CW_cur: torch.Tensor,  # (4, 4)
    valid: torch.Tensor,  # (M,) bool
    age: torch.Tensor,  # (M,) int frames since first observation
    *,
    min_baseline_frames: int,
    min_baseline_angle_deg: float,
    min_dist: float,
    max_dist: float,
    enforce_age: bool = True,
):
    """Triangulate and gate a whole candidate table.

    Returns X (M, 3), promote (M,) bool, keep (M,) bool."""
    old_enough = (age > min_baseline_frames if enforce_age
                  else torch.ones_like(valid))
    angle = bearing_angle_deg(cam, uv_first, uv_cur, T_CW_first[:, :3, :3],
                              T_CW_cur[:3, :3])
    angle_ok = angle >= min_baseline_angle_deg
    P_first = projection_matrix(cam, T_CW_first)
    P_cur = projection_matrix(cam, T_CW_cur)
    X = triangulate_dlt(P_first, P_cur.expand_as(P_first), uv_first, uv_cur)
    depth_ok = depth_gate(X, T_CW_first, T_CW_cur, min_dist, max_dist)
    promote = valid & old_enough & angle_ok & depth_ok
    keep = valid & ~promote
    return X, promote, keep
