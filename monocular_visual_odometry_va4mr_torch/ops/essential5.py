"""Nister 5-point minimal essential-matrix solver, branchless (port of
``ops/essential5.py``), batched over a leading sample axis.

1. The 4-dim nullspace of the 5x9 epipolar constraints (SVD) gives
   E = x*E1 + y*E2 + z*E3 + E4.
2. det(E) = 0 and the trace constraints give a 10x20 cubic system, built by
   dict algebra over exponent tuples on (B,) coefficient tensors.
3. Gauss-Jordan with partial pivoting leaves B(z), whose determinant is the
   degree-10 polynomial in z.
4. Real roots: tan-spaced sign sweep (257 points), 30 bisections, 3 Newton
   polishes.
5. Back-substitution for (x, y) from the best-conditioned cross product of
   rows of B(z): up to 10 essential matrices per sample.

The nullspace basis from an SVD is not unique (torch and JAX may return
different bases and signs), so the solution SET matches the reference, not
its order or sign; callers compare (R, t), not ordered intermediates.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]

Poly = Dict[Tuple[int, int, int], torch.Tensor]


def _pmul(a: Poly, b: Poly) -> Poly:
    out: Poly = {}
    for ea, ca in a.items():
        for eb, cb in b.items():
            e = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
            term = ca * cb
            out[e] = out[e] + term if e in out else term
    return out


def _padd(a: Poly, b: Poly, sb: float = 1.0) -> Poly:
    out = dict(a)
    for e, c in b.items():
        out[e] = out[e] + sb * c if e in out else sb * c
    return out


def _coeff_row(p: Poly, like: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(like)
    return torch.stack([p.get(m, zero) for m in _MONOMIALS], -1)


def _constraint_matrix(E1, E2, E3, E4) -> torch.Tensor:
    """(B, 10, 20) cubic-constraint coefficients for
    E = x*E1 + y*E2 + z*E3 + E4 (each (B, 3, 3))."""
    Ep = [[{(1, 0, 0): E1[:, i, j], (0, 1, 0): E2[:, i, j],
            (0, 0, 1): E3[:, i, j], (0, 0, 0): E4[:, i, j]}
           for j in range(3)] for i in range(3)]

    def minor(r0, r1, c0, c1):
        return _padd(_pmul(Ep[r0][c0], Ep[r1][c1]),
                     _pmul(Ep[r0][c1], Ep[r1][c0]), -1.0)

    detE = _padd(
        _padd(_pmul(Ep[0][0], minor(1, 2, 1, 2)),
              _pmul(Ep[0][1], minor(1, 2, 0, 2)), -1.0),
        _pmul(Ep[0][2], minor(1, 2, 0, 1)))

    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc: Poly = {}
            for k in range(3):
                acc = _padd(acc, _pmul(Ep[i][k], Ep[j][k]))
            EEt[i][j] = acc
    tr: Poly = {}
    for i in range(3):
        tr = _padd(tr, EEt[i][i])

    like = E1[:, 0, 0]
    rows = [_coeff_row(detE, like)]
    for i in range(3):
        for j in range(3):
            acc: Poly = {}
            for k in range(3):
                acc = _padd(acc, _pmul(EEt[i][k], Ep[k][j]))
            acc = {e: 2.0 * c for e, c in acc.items()}
            acc = _padd(acc, _pmul(tr, Ep[i][j]), -1.0)
            rows.append(_coeff_row(acc, like))
    return torch.stack(rows, -2)


def _gauss_jordan10(A: torch.Tensor) -> torch.Tensor:
    """Reduce the first 10 columns of (B, 10, 20) A to the identity
    (partial pivoting, branchless)."""
    B = A.shape[0]
    ar = torch.arange(B, device=A.device)
    row_ids = torch.arange(10, device=A.device)
    A = A.clone()
    for i in range(10):
        col = A[:, :, i].abs()
        col = torch.where(row_ids < i, torch.full_like(col, -1.0), col)
        p = torch.argmax(col, 1)
        rowi = A[:, i].clone()
        rowp = A[ar, p].clone()
        A[:, i] = rowp
        A[ar, p] = rowi
        piv = A[:, i, i]
        inv = torch.where(piv.abs() > 1e-20, 1.0 / piv, torch.zeros_like(piv))
        A[:, i] = A[:, i] * inv[:, None]
        fac = torch.where(row_ids == i, 0.0, A[:, :, i])
        A = A - fac[:, :, None] * A[:, i][:, None, :]
    return A


def _poly_mul1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of polys (..., na), (..., nb), lowest power first."""
    na, nb = a.shape[-1], b.shape[-1]
    out = [torch.zeros_like(a[..., 0]) for _ in range(na + nb - 1)]
    for i in range(na):
        for j in range(nb):
            out[i + j] = out[i + j] + a[..., i] * b[..., j]
    return torch.stack(out, -1)


def _psub(a, b):
    n = max(a.shape[-1], b.shape[-1])
    a = torch.nn.functional.pad(a, (0, n - a.shape[-1]))
    b = torch.nn.functional.pad(b, (0, n - b.shape[-1]))
    return a - b


def _degree10_poly(A: torch.Tensor):
    """B(z) and det(B) (degree 10) from the reduced (B, 10, 20) system.

    Returns (p (B, 11) lowest-first, (Bx (B,3,4), By (B,3,4), B1 (B,3,5)))."""
    t = A[:, 4:10, 10:20]

    def krow(ta, tb):
        bx = torch.stack([ta[:, 2], ta[:, 1] - tb[:, 2], ta[:, 0] - tb[:, 1],
                          -tb[:, 0]], -1)
        by = torch.stack([ta[:, 5], ta[:, 4] - tb[:, 5], ta[:, 3] - tb[:, 4],
                          -tb[:, 3]], -1)
        b1 = torch.stack([ta[:, 9], ta[:, 8] - tb[:, 9], ta[:, 7] - tb[:, 8],
                          ta[:, 6] - tb[:, 7], -tb[:, 6]], -1)
        return bx, by, b1

    k = krow(t[:, 0], t[:, 1])
    l = krow(t[:, 2], t[:, 3])
    m = krow(t[:, 4], t[:, 5])
    Bx = torch.stack([k[0], l[0], m[0]], 1)
    By = torch.stack([k[1], l[1], m[1]], 1)
    B1 = torch.stack([k[2], l[2], m[2]], 1)

    def m2(p, q, r, s):  # p*s - q*r
        return _psub(_poly_mul1(p, s), _poly_mul1(q, r))

    det = _psub(
        _poly_mul1(Bx[:, 0], m2(By[:, 1], B1[:, 1], By[:, 2], B1[:, 2])),
        _poly_mul1(By[:, 0], m2(Bx[:, 1], B1[:, 1], Bx[:, 2], B1[:, 2])),
    )
    last = _poly_mul1(B1[:, 0], m2(Bx[:, 1], By[:, 1], Bx[:, 2], By[:, 2]))
    n = det.shape[-1]
    det = det + torch.nn.functional.pad(last, (0, max(0, n - last.shape[-1])))[..., :n]
    return det[..., :11], (Bx, By, B1)


def _poly_eval(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Horner, coefficients lowest-first; p (..., D), z broadcast to (...)."""
    acc = torch.zeros_like(z) + p[..., -1]
    for i in range(p.shape[-1] - 2, -1, -1):
        acc = acc * z + p[..., i]
    return acc


def _real_roots10(p: torch.Tensor, n_grid: int = 257, n_bisect: int = 30):
    """Up to 10 real roots of (B, 11) degree-10 polys.

    Returns (roots (B, 10), valid (B, 10))."""
    scale = p.abs().amax(-1, keepdim=True) + 1e-30
    p = p / scale
    dp = p[:, 1:] * torch.arange(1, 11, dtype=p.dtype, device=p.device)

    theta = torch.linspace(-math.pi / 2 + 6e-3, math.pi / 2 - 6e-3, n_grid,
                           dtype=p.dtype, device=p.device)
    zs = torch.tan(theta) * 3.0  # dense near 0, reaches |z| ~ 500
    vals = _poly_eval(p[:, None, :], zs[None, :])  # (B, n_grid)
    sign = torch.where(vals >= 0, 1.0, -1.0)
    change = (sign[:, :-1] * sign[:, 1:]) < 0  # (B, n_grid-1)

    order = torch.argsort((~change).to(torch.int32), dim=1, stable=True)
    idx = order[:, :10]
    valid = torch.gather(change, 1, idx)
    lo = zs[idx]
    hi = zs[idx + 1]
    pe = p[:, None, :]
    flo = _poly_eval(pe, lo)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        fmid = _poly_eval(pe, mid)
        go_left = (flo * fmid) <= 0
        hi = torch.where(go_left, mid, hi)
        lo = torch.where(go_left, lo, mid)
        flo = torch.where(go_left, flo, fmid)

    root = 0.5 * (lo + hi)
    dpe = dp[:, None, :]
    for _ in range(3):
        f = _poly_eval(pe, root)
        d = _poly_eval(dpe, root)
        newr = root - f / torch.where(d.abs() > 1e-20, d,
                                      torch.full_like(d, 1e-20))
        ok_step = torch.isfinite(newr) & ((newr - root).abs() < 1.0)
        root = torch.where(ok_step, newr, root)
    return root, valid


def five_point_essentials(x0: torch.Tensor, x1: torch.Tensor):
    """Essential matrices from 5 normalized correspondences per sample.

    x0, x1: (B, 5, 2), convention x1^T E x0 = 0.
    Returns (Es (B, 10, 3, 3), valid (B, 10))."""
    u0, v0 = x0[..., 0], x0[..., 1]
    u1, v1 = x1[..., 0], x1[..., 1]
    ones = torch.ones_like(u0)
    Q = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0, ones],
                    -1)  # (B, 5, 9)
    # Nullspace by SVD of Q, not eigh(Q^T Q), which squares the condition.
    _, _, Vt = torch.linalg.svd(Q, full_matrices=True)
    B = Q.shape[0]
    E1 = Vt[:, 8].reshape(B, 3, 3)
    E2 = Vt[:, 7].reshape(B, 3, 3)
    E3 = Vt[:, 6].reshape(B, 3, 3)
    E4 = Vt[:, 5].reshape(B, 3, 3)

    A = _gauss_jordan10(_constraint_matrix(E1, E2, E3, E4))
    p10, (Bx, By, B1) = _degree10_poly(A)
    z, rvalid = _real_roots10(p10)  # (B, 10)

    zz = z[:, :, None]
    bx = _poly_eval(Bx[:, None], zz)  # (B, 10, 3)
    by = _poly_eval(By[:, None], zz)
    b1 = _poly_eval(B1[:, None], zz)
    Bm = torch.stack([bx, by, b1], -1)  # (B, 10, 3, 3), rows k/l/m
    cross = torch.linalg.cross
    ns = torch.stack([cross(Bm[..., 0, :], Bm[..., 1, :], dim=-1),
                      cross(Bm[..., 0, :], Bm[..., 2, :], dim=-1),
                      cross(Bm[..., 1, :], Bm[..., 2, :], dim=-1)], -2)
    best = torch.argmax(ns[..., 2].abs(), -1)  # (B, 10)
    n = torch.gather(ns, 2, best[..., None, None].expand(B, 10, 1, 3))[:, :, 0]
    n2 = n[..., 2]
    w = torch.where(n2.abs() > 1e-20, 1.0 / n2, torch.zeros_like(n2))
    x = n[..., 0] * w
    y = n[..., 1] * w
    E = (x[..., None, None] * E1[:, None] + y[..., None, None] * E2[:, None]
         + z[..., None, None] * E3[:, None] + E4[:, None])
    nrm = torch.sqrt(torch.sum(E * E, (-1, -2)))
    E = E / torch.where(nrm > 1e-20, nrm, torch.ones_like(nrm))[..., None, None]
    ok = rvalid & (n2.abs() > 1e-12) & torch.isfinite(x) & torch.isfinite(y)
    return E, ok
