"""SO(3) / SE(3) / Sim(3) operations (port of ``core/lie.py``).

Where the JAX functions act on single elements and are ``vmap``ped, these
take any leading batch shape: ``hat`` (..., 3) -> (..., 3, 3), ``se3_exp``
(..., 6) -> (..., 4, 4), ``sim3_log`` (..., 4, 4) -> (..., 7).  Matrices are
assembled with ``cat``/``stack``, never written in place, so forward-mode
autodiff runs through every function (the pose graph differentiates them at
xi = 0).  The Taylor guards and safe
denominators near the singularities are the reference's.
"""
from __future__ import annotations

import math

import torch

from .linalg import einsum, matmul, solve

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _homogeneous(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) [[A, t], [0, 1]]."""
    top = torch.cat([A, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])],
                       -1)
    return torch.cat([top, bottom], -2)


def _exp_coeffs(theta2: torch.Tensor):
    """sin(t)/t, (1-cos(t))/t^2 and (t-sin(t))/t^3 with the reference's
    Taylor guards (``lie.so3_exp`` / ``lie.se3_exp``)."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS),
                    0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta))
                    / (theta2 * theta + _EPS * _EPS),
                    1.0 / 6.0 - theta2 / 120.0)
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation (..., 3, 3) (Rodrigues)."""
    a, b, _ = _exp_coeffs(torch.sum(w * w, -1))
    W = hat(w)
    return (_eye(3, w) + a[..., None, None] * W
            + b[..., None, None] * (matmul(W, W)))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3), robust near 0 and pi and
    differentiable (theta from atan2; safe denominators).  The near-pi
    branch picks the largest column of R + I by a one-hot product, so no
    index leaves the device."""
    w_asym = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    s = torch.sqrt(torch.sum(w_asym * w_asym, -1) + _EPS * _EPS)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.atan2(s, c)
    s_safe = torch.clamp(s, min=_EPS)
    scale = torch.where(theta < 1e-4, 1.0 + theta * theta / 6.0,
                        theta / s_safe)
    w_generic = w_asym * scale[..., None]
    B = R + _eye(3, R)
    k = torch.argmax(torch.diagonal(B, dim1=-2, dim2=-1), -1)
    onehot = (torch.arange(3, device=R.device) == k[..., None]).to(R.dtype)
    col = torch.sum(B * onehot[..., None, :], -1)  # B[:, k]
    axis = col / torch.clamp(torch.linalg.vector_norm(col, dim=-1),
                             min=_EPS)[..., None]
    sign = torch.where(torch.sum(axis * w_asym, -1) < 0.0, -1.0, 1.0)
    w_pi = (sign * theta)[..., None] * axis
    return torch.where((theta > math.pi - 1e-3)[..., None], w_pi, w_generic)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist (..., 6) = (v, w) -> homogeneous transform (..., 4, 4);
    the rotation block is the reference's ``so3_exp`` (Rodrigues)."""
    v, w = xi[..., :3], xi[..., 3:]
    a, b, c = _exp_coeffs(torch.sum(w * w, -1))
    W = hat(w)
    WW = matmul(W, W)
    eye = _eye(3, xi)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    return _homogeneous(R, einsum("...ij,...j->...i", V, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform (..., 4, 4) -> twist (..., 6) = (v, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    half_theta = 0.5 * theta
    # V^-1 = I - W/2 + (1/theta^2)(1 - theta sin / (2 (1-cos))) W^2
    theta2_safe = torch.clamp(theta2, min=_EPS)
    cot_term = torch.where(
        theta2 > 1e-8,
        (1.0 - half_theta * torch.cos(half_theta)
         / torch.clamp(torch.sin(half_theta), min=_EPS)) / theta2_safe,
        1.0 / 12.0 + theta2 / 720.0)
    V_inv = _eye(3, T) - 0.5 * W + cot_term[..., None, None] * (matmul(W, W))
    v = einsum("...ij,...j->...i", V_inv, t)
    return torch.cat([v, w], -1)


def rt_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) or (3, 1) -> (..., 4, 4) homogeneous transform."""
    return _homogeneous(R, t.reshape(R.shape[:-1]))


def matrix_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def invert_rt(R: torch.Tensor, t: torch.Tensor):
    """Rigid-transform inverse ``(R, t) -> (R^T, -R^T t)``."""
    Rinv = R.transpose(-1, -2)
    return Rinv, -einsum("...ij,...j->...i", Rinv, t)


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous (..., 4, 4) rigid-transform inverse."""
    return _homogeneous(*invert_rt(T[..., :3, :3], T[..., :3, 3]))


# ---------------------------------------------------------------------------
# Sim(3): similarity transforms [[s*R, t], [0, 1]], tangent xi = (v, w,
# sigma), exp(xi) = [[e^sigma * so3_exp(w), W(w, sigma) v], [0, 1]] (Sophus
# convention), as in the reference.  The Sim(3) pose graph
# (backend/posegraph_sim3.py) linearizes at xi = 0, so every branch keeps the
# reference's Taylor guard and safe denominator.
# ---------------------------------------------------------------------------


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no ``cbrt``)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The (..., 3, 3) matrix W with t = W v in sim3_exp (Sophus calcW)."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    Om = hat(w)
    s = torch.exp(sigma)
    sig2 = sigma * sigma
    one = torch.ones_like(sigma)

    small_sig = torch.abs(sigma) < 1e-4
    small_th = theta < 1e-4
    sig_safe = torch.where(small_sig, one, sigma)
    sig2_safe = torch.where(small_sig, one, sig2)
    th_safe = torch.where(small_th, one, theta)
    th2_safe = torch.where(small_th, one, theta2)
    c_den = theta2 + sig2
    c_safe = torch.where(c_den < 1e-10, one, c_den)

    C = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0,
                    (s - 1.0) / sig_safe)

    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    A_gen = (a_ * sigma + (1.0 - b_) * theta) / (th_safe * c_safe)
    A_sig = ((sigma - 1.0) * s + 1.0) / sig2_safe  # sigma != 0, theta -> 0
    A_small = torch.where(small_th, 0.5 + sigma / 3.0,
                          (1.0 - torch.cos(theta)) / th2_safe)
    A = torch.where(small_sig, A_small, torch.where(small_th, A_sig, A_gen))

    B_gen = (C - ((b_ - 1.0) * sigma + a_ * theta) / c_safe) / th2_safe
    B_sig = (s * (0.5 * sig2 - sigma + 1.0) - 1.0) / (sig2_safe * sig_safe)
    B_small = torch.where(small_th, 1.0 / 6.0 + sigma / 8.0,
                          (theta - torch.sin(theta)) / (th2_safe * th_safe))
    B = torch.where(small_sig, B_small, torch.where(small_th, B_sig, B_gen))

    return (C[..., None, None] * _eye(3, w) + A[..., None, None] * Om
            + B[..., None, None] * (matmul(Om, Om)))


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) tangent (..., 7) = (v, w, sigma) -> similarity (..., 4, 4)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    sR = torch.exp(sigma)[..., None, None] * so3_exp(w)
    t = einsum("...ij,...j->...i", _sim3_W(w, sigma), v)
    return _homogeneous(sR, t)


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Similarity (..., 4, 4) -> tangent (..., 7) = (v, w, sigma)."""
    sR = S[..., :3, :3]
    # det(sR) = s^3: differentiable scale extraction, exact for any s > 0.
    s = _cbrt(torch.linalg.det(sR))
    sigma = torch.log(s)
    w = so3_log(sR / s[..., None, None])
    # solve_ex (``linalg.solve``): torch.linalg.solve's bits without its
    # check of the factorisation on the host, which no capture can hold.
    v = solve(_sim3_W(w, sigma), S[..., :3, 3])
    return torch.cat([v, w, sigma[..., None]], -1)


def sim3_from_rt_s(R: torch.Tensor, t: torch.Tensor, s) -> torch.Tensor:
    """(R, t, s) -> [[s*R, t], [0, 1]]."""
    return _homogeneous(s * R, t.reshape(R.shape[:-1]))


def invert_sim3(S: torch.Tensor) -> torch.Tensor:
    """Similarity inverse: [[sR, t]]^-1 = [[(1/s)R^T, -(1/s)R^T t]]."""
    sR = S[..., :3, :3]
    s2 = torch.sum(sR[..., 0, :] * sR[..., 0, :], -1)  # |s*R row|^2 = s^2
    Rts = sR.transpose(-1, -2) / s2[..., None, None]  # = R^T / s
    return _homogeneous(Rts, -einsum("...ij,...j->...i", Rts,
                                           S[..., :3, 3]))


def sim3_to_se3(S: torch.Tensor) -> torch.Tensor:
    """Camera pose from a Sim(3) node: [[sR, t]] -> [[R, t/s]] (the
    Strasdat convention)."""
    sR = S[..., :3, :3]
    s = _cbrt(torch.linalg.det(sR))
    return _homogeneous(sR / s[..., None, None], S[..., :3, 3] / s[..., None])
