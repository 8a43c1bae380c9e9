"""Closed-form cubic / quartic roots on real tensors (port of
``ops/polysolve.py``): Cardano / trigonometric cubic, Ferrari quartic with
hand-rolled complex arithmetic on (re, im) pairs, two Newton polishes.
Elementwise over any batch shape.

The complex square root and the cube root are ``core.linalg``'s
``csqrt`` and ``cbrt``: their batch-invariant forms give each problem of a
batch what it gets alone (``torch.func.vmap``).
"""
from __future__ import annotations

import torch

from ..core.linalg import cbrt, csqrt

_EPS = 1e-12


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi + _EPS
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def cubic_real_root(a2, a1, a0):
    """One real root of ``t^3 + a2 t^2 + a1 t + a0``."""
    p = a1 - a2 * a2 / 3.0
    q = 2.0 * a2 ** 3 / 27.0 - a2 * a1 / 3.0 + a0
    shift = -a2 / 3.0
    disc = (q * q) / 4.0 + (p ** 3) / 27.0

    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_cardano = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq)

    p_safe = torch.clamp(p, max=-_EPS)
    m = 2.0 * torch.sqrt(-p_safe / 3.0)
    arg = torch.clamp(3.0 * q / (p_safe * m), -1.0, 1.0)
    root_trig = m * torch.cos(torch.arccos(arg) / 3.0)
    return torch.where(disc >= 0.0, root_cardano, root_trig) + shift


def quartic_roots(a3, a2, a1, a0, real_tol: float = 1e-4):
    """All four roots of ``x^4 + a3 x^3 + a2 x^2 + a1 x + a0``.

    Returns (roots (..., 4) real parts, is_real (..., 4) bool)."""
    sh = a3 / 4.0
    p = a2 - 3.0 * a3 * a3 / 8.0
    q = a1 - a3 * a2 / 2.0 + a3 ** 3 / 8.0
    r = a0 - a3 * a1 / 4.0 + a3 * a3 * a2 / 16.0 - 3.0 * a3 ** 4 / 256.0

    m = cubic_real_root(p, (p * p - 4.0 * r) / 4.0, -q * q / 8.0)
    ar, ai = csqrt(2.0 * m, torch.zeros_like(m))
    br, bi = _cdiv(q, torch.zeros_like(q), 2.0 * ar, 2.0 * ai)
    half_p_m = p / 2.0 + m

    def quad_roots(Br, Bi, Cr, Ci):
        dr, di = _cmul(Br, Bi, Br, Bi)
        dr = dr - 4.0 * Cr
        di = di - 4.0 * Ci
        sr, si = csqrt(dr, di)
        return ((-Br + sr) / 2.0, (-Bi + si) / 2.0), (
            (-Br - sr) / 2.0, (-Bi - si) / 2.0)

    (y1r, y1i), (y2r, y2i) = quad_roots(-ar, -ai, half_p_m + br, bi)
    (y3r, y3i), (y4r, y4i) = quad_roots(ar, ai, half_p_m - br, -bi)

    # Biquadratic fallback when alpha ~ 0 (q ~ 0).
    alpha_small = (ar * ar + ai * ai) < 1e-10
    s2r, s2i = csqrt(p * p - 4.0 * r, torch.zeros_like(p))
    z1r, z1i = (-p + s2r) / 2.0, s2i / 2.0
    z2r, z2i = (-p - s2r) / 2.0, -s2i / 2.0
    b1r, b1i = csqrt(z1r, z1i)
    b2r, b2i = csqrt(z2r, z2i)
    y1r = torch.where(alpha_small, b1r, y1r)
    y1i = torch.where(alpha_small, b1i, y1i)
    y2r = torch.where(alpha_small, -b1r, y2r)
    y2i = torch.where(alpha_small, -b1i, y2i)
    y3r = torch.where(alpha_small, b2r, y3r)
    y3i = torch.where(alpha_small, b2i, y3i)
    y4r = torch.where(alpha_small, -b2r, y4r)
    y4i = torch.where(alpha_small, -b2i, y4i)

    roots_r = torch.stack([y1r, y2r, y3r, y4r], -1) - sh[..., None]
    roots_i = torch.stack([y1i, y2i, y3i, y4i], -1)
    is_real = torch.abs(roots_i) < real_tol * (1.0 + torch.abs(roots_r))

    c3, c2, c1, c0 = (a[..., None] for a in (a3, a2, a1, a0))

    def _newton(x):
        f = (((x + c3) * x + c2) * x + c1) * x + c0
        df = ((4.0 * x + 3.0 * c3) * x + 2.0 * c2) * x + c1
        return x - f / torch.where(torch.abs(df) < _EPS,
                                   torch.full_like(df, _EPS), df)

    polished = _newton(_newton(roots_r))
    roots_r = torch.where(is_real & torch.isfinite(polished), polished,
                          roots_r)
    return roots_r, is_real

