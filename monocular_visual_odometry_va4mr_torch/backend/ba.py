"""Sliding-window bundle adjustment with Schur-complement Gauss-Newton
(port of ``backend/ba.py``).

A window of W extrinsics (W, 4, 4) and L landmarks (L, 3) with a dense
observation grid (W, L, 2) + mask (W, L).  Each iteration builds the
Jacobian blocks with einsums, inverts the 3x3 landmark blocks in closed
form, Schur-reduces to the 6W x 6W camera system with the first ``n_fixed``
poses frozen (``n_fixed=2`` pins both the rigid and the monocular scale
gauge), solves and back-substitutes.  Huber weights on the pixel residual.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import lie
from ..core.camera import Camera
from ..core.linalg import einsum, inv3, matmul, solve, total


class BAWindow(NamedTuple):
    T_CW: torch.Tensor  # (W, 4, 4) keyframe extrinsics
    lm_xyz: torch.Tensor  # (L, 3) landmarks
    obs_uv: torch.Tensor  # (W, L, 2) pixel observations
    obs_mask: torch.Tensor  # (W, L) bool


def _residuals_and_jacobians(window: BAWindow, cam: Camera, huber_px: float):
    """Residuals r (W,L,2), camera Jacobians Jc (W,L,2,6), point Jacobians
    Jp (W,L,2,3) and robust weights w (W,L)."""
    R = window.T_CW[:, :3, :3]
    t = window.T_CW[:, :3, 3]
    Xc = einsum("wij,lj->wli", R, window.lm_xyz) + t[:, None, :]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    r = torch.stack([u, v], -1) - window.obs_uv

    zeros = torch.zeros_like(z)
    Jproj = torch.stack([
        torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], -1),
        torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], -1),
    ], -2)  # (W,L,2,3)
    hatX = lie.hat(Xc)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand_as(hatX)
    Jxi = torch.cat([eye, -hatX], -1)  # (W,L,3,6)
    Jc = matmul(Jproj, Jxi)
    Jp = einsum("wlab,wbc->wlac", Jproj, R)

    # Invalid (masked, behind-camera or non-finite) observations are
    # hard-zeroed: dead slots can hold Inf/NaN and 0 * NaN poisons the sums.
    finite = (torch.isfinite(Xc).all(-1)
              & torch.isfinite(window.obs_uv).all(-1))
    valid = window.obs_mask & (z > 1e-3) & finite
    r = torch.where(valid[..., None], r, torch.zeros_like(r))
    Jc = torch.where(valid[..., None, None], Jc, torch.zeros_like(Jc))
    Jp = torch.where(valid[..., None, None], Jp, torch.zeros_like(Jp))
    rnorm = torch.linalg.vector_norm(r, dim=-1)
    huber = torch.where(rnorm <= huber_px, torch.ones_like(rnorm),
                        huber_px / torch.clamp(rnorm, min=1e-9))
    w = torch.where(valid, huber, torch.zeros_like(huber))
    return r, Jc, Jp, w


def build_normal_blocks(window: BAWindow, cam: Camera, *,
                        huber_px: float = 3.0, damping: float = 1e-4,
                        camera_damping: Optional[float] = None):
    """Returns (S (W,W,6,6), rhs (W,6), Hpp_inv (L,3,3), Hcp (W,L,6,3),
    b_p (L,3), cost ()).  ``camera_damping`` (``damping`` when None) goes on
    the diagonal of S: a landmark shard that is summed with others adds it
    on one shard only (``parallel/ba_sharded.py``)."""
    if camera_damping is None:
        camera_damping = damping
    r, Jc, Jp, w = _residuals_and_jacobians(window, cam, huber_px)
    # core.linalg's contractions: they round alike alone and in a batch.
    Hcc = einsum("wl,wlai,wlaj->wij", w, Jc, Jc)
    Hpp = einsum("wl,wlai,wlaj->lij", w, Jp, Jp)
    Hcp = einsum("wl,wlai,wlaj->wlij", w, Jc, Jp)
    b_c = einsum("wl,wlai,wla->wi", w, Jc, r)
    b_p = einsum("wl,wlai,wla->li", w, Jp, r)

    dev, dt = r.device, r.dtype
    Hpp_inv = inv3(Hpp + damping * torch.eye(3, dtype=dt, device=dev))
    HcpHpi = einsum("wlij,ljk->wlik", Hcp, Hpp_inv)
    S = -einsum("wlik,vljk->wvij", HcpHpi, Hcp)
    W_ = window.T_CW.shape[0]
    ar = torch.arange(W_, device=dev)
    S[ar, ar] = S[ar, ar] + Hcc + camera_damping * torch.eye(6, dtype=dt,
                                                              device=dev)
    rhs = b_c - einsum("wlik,lk->wi", HcpHpi, b_p)
    cost = 0.5 * total(w * torch.sum(r * r, -1), (0, 1))
    return S, rhs, Hpp_inv, Hcp, b_p, cost


def solve_camera_system(S: torch.Tensor, rhs: torch.Tensor,
                        n_fixed: int = 2) -> torch.Tensor:
    """Solve the reduced camera system with the first ``n_fixed`` poses
    frozen."""
    W = rhs.shape[0]
    S = S.clone()
    # fill_, not ``= 0.0``: no scalar tensor made on the host inside the
    # captured step.
    S[:n_fixed].fill_(0.0)
    S[:, :n_fixed].fill_(0.0)
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    for i in range(n_fixed):
        S[i, i] = eye6
    rhs = rhs.clone()
    rhs[:n_fixed].fill_(0.0)
    S_mat = S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    # A singular system gives non-finite values (as in the reference)
    # instead of raising; the accept guard rejects them.
    delta = solve(S_mat, -rhs.reshape(-1))
    return delta.reshape(W, 6)


def apply_updates(window: BAWindow, delta_c, Hpp_inv, Hcp, b_p) -> BAWindow:
    """Back-substitute landmarks and retract pose updates."""
    HcpT_dc = einsum("wlij,wi->lj", Hcp, delta_c)
    delta_p = einsum("lij,lj->li", Hpp_inv, -b_p - HcpT_dc)
    T = matmul(lie.se3_exp(delta_c), window.T_CW)
    return window._replace(T_CW=T, lm_xyz=window.lm_xyz + delta_p)


def run_ba(window: BAWindow, cam: Camera, *, iters: int = 5,
           huber_px: float = 3.0, damping: float = 1e-4, n_fixed: int = 2):
    """``iters`` Gauss-Newton iterations; returns (window, costs (iters,))."""
    costs = []
    for _ in range(iters):
        S, rhs, Hpp_inv, Hcp, b_p, cost = build_normal_blocks(
            window, cam, huber_px=huber_px, damping=damping)
        delta_c = solve_camera_system(S, rhs, n_fixed=n_fixed)
        window = apply_updates(window, delta_c, Hpp_inv, Hcp, b_p)
        costs.append(cost)
    return window, torch.stack(costs)


def reprojection_rms(window: BAWindow, cam: Camera) -> torch.Tensor:
    r, _, _, w = _residuals_and_jacobians(window, cam, huber_px=1e9)
    mask = w > 0
    n = torch.clamp(mask.sum(), min=1)
    return torch.sqrt(total(torch.where(mask, torch.sum(r * r, -1),
                                        torch.zeros_like(w)), (0, 1)) / n)
