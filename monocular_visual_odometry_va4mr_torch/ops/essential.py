"""Essential-matrix RANSAC and relative-pose recovery (port of
``ops/essential.py``): Hartley 8-point, Sampson distance, Gauss-Newton
refinement on the essential manifold, the 5-point bank with the top-8
cheirality rescoring, and ``recover_pose``.

The bank ``(idx, samp_ok)`` is an argument (``ops/ransac.py``).  ``eigh``
and SVD bases and signs may differ from the reference's; every function
here is invariant to them in its (R, t), which is what the tests compare.

Every function runs under ``torch.func.vmap`` (the loop verifier,
``pipeline/posegraph_runner.py``, batches a chunk of keyframe pairs so):
nothing is written in place into a tensor made inside, no index is read on
the host, and the products are ``core.linalg``'s, which on the CPU round
alike alone and in a batch.
"""
from __future__ import annotations

import math

import torch

from ..core.camera import Camera
from ..core.linalg import constant, einsum, matmul
from ..core.slots import stable_top_k
from . import essential5, ransac, triangulate

_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _hartley_normalize(pts: torch.Tensor, w: torch.Tensor):
    """Similarity-normalize (..., N, 2) points with weights (..., N).

    Returns (normalized pts, (..., 3, 3) transform with x_n = T hom(x))."""
    wsum = torch.clamp(torch.sum(w, -1), min=1.0)
    mean = torch.sum(pts * w[..., None], -2) / wsum[..., None]
    centered = pts - mean[..., None, :]
    rms = torch.sqrt(torch.sum(torch.sum(centered ** 2, -1) * w, -1)
                     / wsum) + 1e-12
    s = math.sqrt(2.0) / rms
    z, one = torch.zeros_like(s), torch.ones_like(s)
    tx, ty = (-s[..., None] * mean).unbind(-1)
    T = torch.stack([torch.stack([s, z, tx], -1),
                     torch.stack([z, s, ty], -1),
                     torch.stack([z, z, one], -1)], -2)
    return centered * s[..., None, None], T


def _eight_point(x0: torch.Tensor, x1: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point on normalized coords (N, 2) with weights (..., N).

    Returns E (..., 3, 3), convention x1^T E x0 = 0."""
    x0n, T0 = _hartley_normalize(x0.expand(w.shape + (2,)), w)
    x1n, T1 = _hartley_normalize(x1.expand(w.shape + (2,)), w)
    u0, v0 = x0n[..., 0], x0n[..., 1]
    u1, v1 = x1n[..., 0], x1n[..., 1]
    ones = torch.ones_like(u0)
    A = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0,
                     ones], -1)
    AtA = einsum("...ni,...nj->...ij", A * w[..., None], A)
    _, vecs = torch.linalg.eigh(AtA)
    F = vecs[..., :, 0].reshape(w.shape[:-1] + (3, 3))
    F = matmul(matmul(T1.transpose(-1, -2), F), T0)
    return project_to_essential(F)


def _svd3_rotations(E: torch.Tensor):
    """U, s, V of (..., 3, 3) via eigh of E^T E, with det(U) = det(V) = +1."""
    EtE = matmul(E.transpose(-1, -2), E)
    _, V = torch.linalg.eigh(EtE)
    V = torch.flip(V, [-1])  # descending
    s = torch.sqrt(torch.clamp(torch.diagonal(
        matmul(matmul(V.transpose(-1, -2), EtE), V), dim1=-2, dim2=-1),
        min=0.0))
    u0 = matmul(E, V[..., :, 0:1])[..., 0] / torch.clamp(s[..., 0:1],
                                                         min=1e-12)
    u1 = matmul(E, V[..., :, 1:2])[..., 0] / torch.clamp(s[..., 1:2],
                                                         min=1e-12)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    U = torch.stack([u0, u1, u2], -1)
    V = torch.cat([V[..., :2], V[..., 2:] * torch.sign(
        torch.linalg.det(V))[..., None, None]], -1)
    U = torch.cat([U[..., :2], U[..., 2:] * torch.sign(
        torch.linalg.det(U))[..., None, None]], -1)
    return U, s, V


def project_to_essential(F: torch.Tensor) -> torch.Tensor:
    U, s, V = _svd3_rotations(F)
    sigma = 0.5 * (s[..., 0] + s[..., 1])
    z = torch.zeros_like(sigma)
    S = torch.stack([torch.stack([sigma, z, z], -1),
                     torch.stack([z, sigma, z], -1),
                     torch.stack([z, z, z], -1)], -2)
    return matmul(matmul(U, S), V.transpose(-1, -2))


def sampson_distance_sq(F: torch.Tensor, uv0: torch.Tensor,
                        uv1: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance (..., N) of (N, 2) pixel correspondences
    under fundamental matrices F (..., 3, 3)."""
    x0 = torch.cat([uv0, torch.ones_like(uv0[..., :1])], -1)
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], -1)
    Fx0 = x0 @ F.transpose(-1, -2)
    Ftx1 = x1 @ F
    num = torch.sum(x1 * Fx0, -1) ** 2
    den = (Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2
           + Ftx1[..., 1] ** 2)
    return num / torch.clamp(den, min=1e-12)


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    th2 = torch.sum(w * w)
    th = torch.sqrt(th2 + 1e-24)
    K = _hat(w / th)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    Rbig = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * matmul(K, K)
    Rsmall = eye + _hat(w)
    return torch.where(th2 > 1e-12, Rbig, Rsmall)


def refine_essential_gn(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                        w: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Gauss-Newton refinement of E = [t]x R on the essential manifold
    (5 dof), minimizing the weighted Sampson error in normalized coords."""
    dev, dt = E.device, E.dtype
    U, _, V = _svd3_rotations(E)
    Wm = constant(_W, dev)
    R0 = matmul(matmul(U, Wm), V.T)
    t0 = U[:, 2]
    a = torch.where(t0[0].abs() < 0.9, constant([1.0, 0.0, 0.0], dev),
                    constant([0.0, 1.0, 0.0], dev))
    b1 = torch.linalg.cross(t0, a, dim=-1)
    b1 = b1 / torch.linalg.vector_norm(b1)
    b2 = torch.linalg.cross(t0, b1, dim=-1)
    Bm = torch.stack([b1, b2], 1)
    h0 = torch.cat([x0, torch.ones_like(x0[:, :1])], -1)
    h1 = torch.cat([x1, torch.ones_like(x1[:, :1])], -1)

    def model(params):
        R = matmul(_so3_exp(params[:3]), R0)
        t = t0 + matmul(Bm, params[3:])
        t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
        return matmul(_hat(t), R)

    def sampson(params):
        Em = model(params)
        Ex0 = matmul(h0, Em.T)
        Etx1 = matmul(h1, Em)
        num = torch.sum(h1 * Ex0, -1)
        den = torch.sqrt(Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2
                         + Etx1[:, 1] ** 2 + 1e-18)
        return (num / den) * w

    params = torch.zeros(5, dtype=dt, device=dev)
    eye5 = torch.eye(5, dtype=dt, device=dev)
    for _ in range(iters):
        r = sampson(params)
        J = torch.func.jacfwd(sampson)(params)  # (N, 5)
        JtJ, Jtr = matmul(J.T, J), matmul(J.T, r)
        step = torch.linalg.solve_ex(JtJ + 1e-9 * eye5, Jtr)[0]
        new_params = params - step
        params = torch.where(torch.isfinite(new_params).all(), new_params,
                             params)
    E_ref = model(params)
    return E_ref / torch.clamp(torch.linalg.vector_norm(E_ref), min=1e-12)


def find_essential_ransac(
    cam: Camera,
    uv0: torch.Tensor,  # (N, 2) pixels, first view
    uv1: torch.Tensor,  # (N, 2) pixels, second view
    valid: torch.Tensor,  # (N,) bool
    idx: torch.Tensor,  # (I, 5) or (I, 8) minimal sets
    samp_ok: torch.Tensor,  # (I,) bool
    *,
    threshold_px: float = 1.0,
    solver: str = "5point",
):
    """RANSAC essential matrix over a given bank. Returns (E, inliers, ok).

    Convention x1^T E x0 = 0 in normalized coords."""
    dev = uv0.device
    Kinv = cam.inv_matrix(dev)
    x0 = cam.normalize(uv0)
    x1 = cam.normalize(uv1)

    if solver == "5point":
        Es, e_ok = essential5.five_point_essentials(x0[idx], x1[idx])
        Es = Es.reshape(-1, 3, 3)
        hyp_ok = (e_ok & samp_ok[:, None]).reshape(-1)
    elif solver == "8point":
        w = torch.zeros(idx.shape[0], uv0.shape[0], dtype=torch.float32,
                        device=dev).scatter(1, idx, 1.0)
        Es = _eight_point(x0, x1, w)
        hyp_ok = samp_ok
    else:
        raise ValueError(f"unknown essential solver: {solver!r}")

    Fs = matmul(matmul(Kinv.T, Es), Kinv)
    inl_all = (sampson_distance_sq(Fs, uv0, uv1) < threshold_px ** 2) & valid
    scores = inl_all.sum(-1)
    best, _, any_ok = ransac.best_hypothesis(scores, hyp_ok)

    if solver == "5point":
        # Planar two-fold ambiguity: rescore the top-8 Sampson candidates by
        # positive-depth votes and keep the physical member of the pair.
        masked = torch.where(hyp_ok, scores, torch.full_like(scores, -1))
        _, top_idx = stable_top_k(masked, 8)
        _, _, votes = recover_pose(Es[top_idx], cam, uv0, uv1,
                                   inl_all[top_idx])
        votes = torch.where(masked[top_idx] >= 0, votes,
                            torch.full_like(votes, -1))
        best = top_idx.index_select(0, torch.argmax(votes).view(1))

    # index_select, not a 0-d index: nothing is read on the host.
    best = best.view(1)
    inl = inl_all.index_select(0, best)[0]
    if solver == "5point":
        E = refine_essential_gn(Es.index_select(0, best)[0], x0, x1,
                                inl.to(torch.float32))
    else:
        E = _eight_point(x0, x1, inl.to(torch.float32))
    F = matmul(matmul(Kinv.T, E), Kinv)
    inl = (sampson_distance_sq(F, uv0, uv1) < threshold_px ** 2) & valid
    return E, inl, any_ok


def recover_pose(E: torch.Tensor, cam: Camera, uv0: torch.Tensor,
                 uv1: torch.Tensor, mask: torch.Tensor):
    """Cheirality-disambiguated relative pose, batched over E (..., 3, 3)
    with masks (..., N): x_cam1 = R x_cam0 + t, |t| = 1, chosen among the
    four factorizations by the positive-depth vote.

    Returns (R (..., 3, 3), t (..., 3), votes (...))."""
    dev, dt = E.device, E.dtype
    U, _, V = _svd3_rotations(E)
    Wm = constant(_W, dev)
    Vt = V.transpose(-1, -2)
    Ra = matmul(matmul(U, Wm), Vt)
    Rb = matmul(matmul(U, Wm.T), Vt)
    t = U[..., :, 2]
    Rs = torch.stack([Ra, Ra, Rb, Rb], -3)  # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], -2)  # (..., 4, 3)

    Kmat = cam.matrix(dev)
    N = uv0.shape[0]
    P0 = matmul(Kmat, torch.eye(3, 4, dtype=dt, device=dev))
    P1 = matmul(Kmat, torch.cat([Rs, ts[..., None]], -1))  # (..., 4, 3, 4)
    X = triangulate.triangulate_dlt(
        P0.expand(Rs.shape[:-2] + (N, 3, 4)),
        P1[..., None, :, :].expand(Rs.shape[:-2] + (N, 3, 4)), uv0, uv1)
    z0 = X[..., 2]
    z1 = einsum("...nj,...j->...n", X, Rs[..., 2, :]) + ts[..., 2:3]
    good = ((z0 > 0) & (z1 > 0) & (z0 < 50.0) & (z1 < 50.0)
            & mask[..., None, :])
    votes = good.sum(-1)  # (..., 4)
    k = torch.argmax(votes, -1)
    R = torch.gather(Rs, -3, k[..., None, None, None].expand(
        k.shape + (1, 3, 3)))[..., 0, :, :]
    tt = torch.gather(ts, -2, k[..., None, None].expand(k.shape + (1, 3)))[
        ..., 0, :]
    v = torch.gather(votes, -1, k[..., None])[..., 0]
    return R, tt, v
