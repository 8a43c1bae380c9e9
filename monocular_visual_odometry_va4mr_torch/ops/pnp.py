"""P3P + RANSAC + Gauss-Newton pose from 2D-3D correspondences (port of
``ops/pnp.py``): Grunert's P3P with ALL four quartic roots scored, a
closed-form 3-point Kabsch, masked GN refinement on the inliers, and the
guard that keeps the refinement only if no inlier is lost.

The reference ``vmap``s over the hypothesis bank; here the bank is a
leading batch axis.  The bank itself, ``(idx, hyp_ok)``, is an argument
(see ``ops/ransac.py``).
"""
from __future__ import annotations

import torch

from ..core import lie, linalg
from ..core.camera import Camera
from . import polysolve


def _p3p_grunert(X: torch.Tensor, rays: torch.Tensor):
    """Grunert's P3P for a batch of minimal samples.

    Args:
      X: (B, 3, 3) world points per sample.
      rays: (B, 3, 3) unit bearing vectors in the camera frame.

    Returns T_CW (B, 4, 4, 4), one pose per quartic root, and ok (B, 4)."""
    X1, X2, X3 = X[:, 0], X[:, 1], X[:, 2]
    q1, q2, q3 = rays[:, 0], rays[:, 1], rays[:, 2]
    norm = torch.linalg.vector_norm
    a = norm(X2 - X3, dim=-1)
    b = norm(X1 - X3, dim=-1)
    c = norm(X1 - X2, dim=-1)
    cos_alpha = torch.sum(q2 * q3, -1)
    cos_beta = torch.sum(q1 * q3, -1)
    cos_gamma = torch.sum(q1 * q2, -1)

    a2, b2, c2 = a * a, b * b, c * c
    amc = (a2 - c2) / b2
    apc = (a2 + c2) / b2
    bmc = (b2 - c2) / b2
    bma = (b2 - a2) / b2

    A4 = (amc - 1.0) ** 2 - 4.0 * (c2 / b2) * cos_alpha ** 2
    A3 = 4.0 * (
        amc * (1.0 - amc) * cos_beta
        - (1.0 - apc) * cos_alpha * cos_gamma
        + 2.0 * (c2 / b2) * cos_alpha ** 2 * cos_beta
    )
    A2 = 2.0 * (
        amc ** 2
        - 1.0
        + 2.0 * amc ** 2 * cos_beta ** 2
        + 2.0 * bmc * cos_alpha ** 2
        - 4.0 * apc * cos_alpha * cos_beta * cos_gamma
        + 2.0 * bma * cos_gamma ** 2
    )
    A1 = 4.0 * (
        -amc * (1.0 + amc) * cos_beta
        + 2.0 * (a2 / b2) * cos_gamma ** 2 * cos_beta
        - (1.0 - apc) * cos_alpha * cos_gamma
    )
    A0 = (1.0 + amc) ** 2 - 4.0 * (a2 / b2) * cos_gamma ** 2

    A4_safe = torch.where(A4.abs() < 1e-12, torch.full_like(A4, 1e-12), A4)
    v, is_real = polysolve.quartic_roots(A3 / A4_safe, A2 / A4_safe,
                                         A1 / A4_safe, A0 / A4_safe)  # (B, 4)

    # Per-sample scalars broadcast over the 4 roots.
    amc_, cb, cg, ca = (t[:, None] for t in (amc, cos_beta, cos_gamma,
                                             cos_alpha))
    b2_, a2_, c2_ = b2[:, None], a2[:, None], c2[:, None]
    u = ((-1.0 + amc_) * v * v - 2.0 * amc_ * cb * v + 1.0 + amc_) / (
        2.0 * (cg - v * ca))
    s1_sq = b2_ / (1.0 + v * v - 2.0 * v * cb)
    s1 = torch.sqrt(torch.clamp(s1_sq, min=1e-12))
    ok = (v > 0) & (u > 0) & (s1_sq > 1e-12)

    # Newton-polish the distances on the law-of-cosines system (3 steps).
    s = torch.stack([s1, u * s1, v * s1], -1)  # (B, 4, 3)
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(3):
        s1n, s2n, s3n = s[..., 0], s[..., 1], s[..., 2]
        f = torch.stack([
            s2n * s2n + s3n * s3n - 2 * s2n * s3n * ca - a2_,
            s1n * s1n + s3n * s3n - 2 * s1n * s3n * cb - b2_,
            s1n * s1n + s2n * s2n - 2 * s1n * s2n * cg - c2_,
        ], -1)
        z = torch.zeros_like(s1n)
        J = 2.0 * torch.stack([
            torch.stack([z, s2n - s3n * ca, s3n - s2n * ca], -1),
            torch.stack([s1n - s3n * cb, z, s3n - s1n * cb], -1),
            torch.stack([s1n - s2n * cg, s2n - s1n * cg, z], -1),
        ], -2)
        J = J + 1e-9 * eye3
        s_new = s - linalg.solve3(J, f)
        s = torch.where(torch.isfinite(s_new).all(-1, keepdim=True), s_new, s)

    Y = s[..., :, None] * rays[:, None]  # (B, 4, 3, 3) camera-frame points
    R, t = _rigid_from_3pts(X[:, None].expand_as(Y), Y)
    # Built out of place, so the body runs under torch.func.vmap.
    return lie.rt_to_matrix(R, t), ok & is_real


def _rigid_from_3pts(X: torch.Tensor, Y: torch.Tensor):
    """Rigid transform with Y_i ~= R X_i + t from 3 point pairs (..., 3, 3),
    by aligning orthonormal frames built on each triad."""

    def frame(P):
        e1 = P[..., 1, :] - P[..., 0, :]
        e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1,
                                                       keepdim=True), min=1e-12)
        v2 = P[..., 2, :] - P[..., 0, :]
        e2 = v2 - torch.sum(v2 * e1, -1, keepdim=True) * e1
        e2 = e2 / torch.clamp(torch.linalg.vector_norm(e2, dim=-1,
                                                       keepdim=True), min=1e-12)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        return torch.stack([e1, e2, e3], -1)  # columns

    Fx = frame(X)
    Fy = frame(Y)
    R = linalg.matmul(Fy, Fx.transpose(-1, -2))
    t = Y[..., 0, :] - linalg.einsum("...ij,...j->...i", R, X[..., 0, :])
    return R, t


def reprojection_errors(T_CW: torch.Tensor, cam: Camera, X: torch.Tensor,
                        uv: torch.Tensor) -> torch.Tensor:
    """Pixel reprojection error (..., N) of world points (N, 3) under
    extrinsics (..., 4, 4); points behind the camera get +inf."""
    Xc = X @ T_CW[..., :3, :3].transpose(-1, -2) + T_CW[..., None, :3, 3]
    z = Xc[..., 2]
    err = torch.linalg.vector_norm(cam.project(Xc) - uv, dim=-1)
    return torch.where(z > 1e-6, err, torch.full_like(err, float("inf")))


def refine_pose_gn(T_CW: torch.Tensor, cam: Camera, X: torch.Tensor,
                   uv: torch.Tensor, w: torch.Tensor,
                   iters: int = 5) -> torch.Tensor:
    """Masked Gauss-Newton on reprojection error, left-multiplicative se(3)
    increments, analytic 2x6 Jacobians."""
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    T = T_CW
    for _ in range(iters):
        Xc = linalg.matmul(X, T[:3, :3].T) + T[:3, 3]
        x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
        z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        iz = 1.0 / z
        iz2 = iz * iz
        u_err = cam.fx * x * iz + cam.cx - uv[:, 0]
        v_err = cam.fy * y * iz + cam.cy - uv[:, 1]
        zero = torch.zeros_like(z)
        Jp = torch.stack([
            torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
            torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
        ], 1)  # (N, 2, 3)
        hatX = lie.hat(Xc)
        Jx = torch.cat([eye3.expand_as(hatX), -hatX], -1)  # (N, 3, 6)
        J = linalg.matmul(Jp, Jx)
        r = torch.stack([u_err, v_err], 1)
        Jw = J * w[:, None, None]
        H = linalg.einsum("nij,nik->jk", Jw, J) + 1e-6 * eye6
        g = linalg.einsum("nij,ni->j", Jw, r)
        # A singular system gives non-finite values, as in the reference,
        # instead of raising.
        xi = -linalg.solve(H, g)
        T = linalg.matmul(lie.se3_exp(xi), T)
    return T


def solve_pnp_ransac(
    cam: Camera,
    X: torch.Tensor,  # (N, 3) world points
    uv: torch.Tensor,  # (N, 2) pixel observations
    valid: torch.Tensor,  # (N,) bool
    idx: torch.Tensor,  # (I, 3) minimal sets (ops/ransac.py)
    hyp_ok: torch.Tensor,  # (I,) bool
    *,
    reproj_threshold_px: float = 8.0,
    refine_iters: int = 5,
    min_points: int = 8,
):
    """PnP-RANSAC over a given bank. Returns (T_CW (4,4), inliers (N,), ok)."""
    rays = cam.backproject(uv)
    rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)

    Ts, oks = _p3p_grunert(X[idx], rays[idx])  # (I, 4, 4, 4), (I, 4)
    Ts = Ts.reshape(-1, 4, 4)
    oks = (oks & hyp_ok[:, None]).reshape(-1)

    inl = (reprojection_errors(Ts, cam, X, uv) < reproj_threshold_px) & valid
    scores = torch.where(oks, inl.sum(-1), torch.full_like(oks, -1,
                                                           dtype=torch.int64))
    best = torch.argmax(scores).view(1)  # first maximum, as jnp.argmax
    # index_select, not Ts[best]: a 0-d index is read on the host.
    T_best = Ts.index_select(0, best)[0]
    found = scores.index_select(0, best)[0] >= max(min_points // 2, 4)

    inl = (reprojection_errors(T_best, cam, X, uv) < reproj_threshold_px) & valid
    T_ref = refine_pose_gn(T_best, cam, X, uv, inl.to(torch.float32),
                           iters=refine_iters)
    inl_ref = (reprojection_errors(T_ref, cam, X, uv)
               < reproj_threshold_px) & valid
    # Keep the refinement only if it did not lose inliers.
    better = inl_ref.sum() >= inl.sum()
    T_out = torch.where(better, T_ref, T_best)
    inl_out = torch.where(better, inl_ref, inl)
    ok = found & (inl_out.sum() >= min_points)
    return T_out, inl_out, ok
