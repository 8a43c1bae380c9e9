"""Pyramidal Lucas-Kanade feature tracking batched over a fixed feature table
(port of ``ops/klt.py``, the gather tracker behind ``klt.backend="xla"``).

Plain tensor code: every window read is one (win+1) x (win+1) block per
feature, gathered with a clamped start, and the sub-pixel window is a 4-term
blend of that block (the whole window shares one fractional offset).  The
gradient matrix comes from the template (previous) frame, computed once per
level; iterations re-read only the current frame's block.  A fixed
iteration count with a masked epsilon freeze, as the reference.

Status: a track fails if the point leaves the image, the gradient matrix is
degenerate (min eigenvalue below ``min_eig_threshold``) at the finest level,
or the final photometric residual is large.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.config import KLTConfig
from . import image as imops


def _extract_blocks(img: torch.Tensor, starts_yx: torch.Tensor, size: int):
    """One (size, size) block per row of ``starts_yx`` (N, 2) [y, x] int,
    starts clamped so every block lies inside the image."""
    H, W = img.shape
    y = starts_yx[:, 0].clamp(0, H - size)
    x = starts_yx[:, 1].clamp(0, W - size)
    ar = torch.arange(size, device=img.device)
    return img[(y[:, None] + ar)[:, :, None], (x[:, None] + ar)[:, None, :]]


def _blend(block: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
           win: int) -> torch.Tensor:
    """Sub-pixel (win, win) window from a (win+1, win+1) block; fx/fy are
    per-feature scalars."""
    fx = fx[:, None, None]
    fy = fy[:, None, None]
    return (block[:, :win, :win] * (1 - fx) * (1 - fy)
            + block[:, :win, 1:] * fx * (1 - fy)
            + block[:, 1:, :win] * (1 - fx) * fy
            + block[:, 1:, 1:] * fx * fy)


def _starts(pts: torch.Tensor, r: int, pad: int) -> Tuple[torch.Tensor, ...]:
    """Integer block starts [y, x] in padded coordinates and the fractional
    offset [x, y] of (N, 2) [x, y] positions.  A NaN position starts at 0,
    as the reference's float -> int conversion gives."""
    base = torch.floor(pts)
    frac = pts - base
    starts = torch.nan_to_num(base.flip(1) - r + pad).to(torch.int64)
    return starts, frac


def _pad_edge(img: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


def _track_level_batch(prev_img, next_img, prev_gx, prev_gy, pts_l, guess,
                       win, num_iters, eps, min_eig_threshold):
    """One pyramid level of LK for the whole feature table."""
    H, W = prev_img.shape
    r = (win - 1) // 2
    size = win + 1
    # Edge-replicate padding so near-border windows sample replicated pixels
    # instead of being shifted wholesale by the block clamp.
    pad = r + 1
    prev_p = _pad_edge(prev_img, pad)
    next_p = _pad_edge(next_img, pad)
    gx_p = _pad_edge(prev_gx, pad)
    gy_p = _pad_edge(prev_gy, pad)

    starts, frac = _starts(pts_l, r, pad)
    fx, fy = frac[:, 0], frac[:, 1]
    T = _blend(_extract_blocks(prev_p, starts, size), fx, fy, win)
    Ix = _blend(_extract_blocks(gx_p, starts, size), fx, fy, win)
    Iy = _blend(_extract_blocks(gy_p, starts, size), fx, fy, win)

    gxx = (Ix * Ix).sum((1, 2))
    gxy = (Ix * Iy).sum((1, 2))
    gyy = (Iy * Iy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det,
                                                 min=0.0)))
    eig_ok = (min_eig / (win * win)) > min_eig_threshold
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det,
                          torch.zeros_like(det))

    g = guess
    frozen = torch.zeros(pts_l.shape[0], dtype=torch.bool,
                         device=pts_l.device)
    for _ in range(num_iters):
        qstarts, qfrac = _starts(pts_l + g, r, pad)
        cur = _blend(_extract_blocks(next_p, qstarts, size), qfrac[:, 0],
                     qfrac[:, 1], win)
        diff = cur - T
        b0 = (diff * Ix).sum((1, 2))
        b1 = (diff * Iy).sum((1, 2))
        d0 = -(gyy * b0 - gxy * b1) * inv_det
        d1 = -(-gxy * b0 + gxx * b1) * inv_det
        d = torch.stack([d0, d1], -1)
        step_small = (d * d).sum(-1) < eps * eps
        g = torch.where(frozen[:, None], g, g + d)
        frozen = frozen | step_small

    p1 = pts_l + g
    inb = ((p1[:, 0] >= r) & (p1[:, 0] <= W - 1 - r)
           & (p1[:, 1] >= r) & (p1[:, 1] <= H - 1 - r))
    return g, eig_ok, inb, T


def track_features(
    prev_pyr: Tuple[torch.Tensor, ...],
    next_pyr: Tuple[torch.Tensor, ...],
    pts: torch.Tensor,  # (N, 2) f32 positions in the previous frame
    valid: torch.Tensor,  # (N,) bool
    *,
    window: int = 15,
    num_iters: int = 20,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
    max_residual: float = 20.0,
):
    """Track a fixed-capacity table of features from prev to next frame.

    Returns (new_pts (N, 2), tracked (N,) bool, residual (N,) f32).  Invalid
    input slots come back invalid."""
    L = len(prev_pyr)
    N = pts.shape[0]
    grads = [imops.central_gradients(p) for p in prev_pyr]

    flow = torch.zeros_like(pts)
    ok = torch.ones(N, dtype=torch.bool, device=pts.device)
    template0 = None
    for lvl in range(L - 1, -1, -1):
        scale = 0.5 ** lvl
        flow = flow * 2.0
        gx, gy = grads[lvl]
        flow, eig_ok, inb, T0 = _track_level_batch(
            prev_pyr[lvl], next_pyr[lvl], gx, gy, pts * scale, flow,
            window, num_iters, eps, min_eig_threshold)
        if lvl == 0:
            # Eigenvalue and bounds decide the status only at the finest
            # level (coarse levels clamp), as cv2 does.
            ok = ok & eig_ok & inb
            template0 = T0

    new_pts = pts + flow

    # Final photometric residual at full resolution (occlusion guard).
    r = (window - 1) // 2
    pad = r + 1
    qstarts, qfrac = _starts(new_pts, r, pad)
    cur = _blend(_extract_blocks(_pad_edge(next_pyr[0], pad), qstarts,
                                 window + 1),
                 qfrac[:, 0], qfrac[:, 1], window)
    resid = (cur - template0).abs().mean((1, 2))
    ok = ok & (resid < max_residual)
    return new_pts, ok & valid, resid



def track_features_config(prev_pyr, next_pyr, pts, valid, cfg: KLTConfig):
    """``track_features`` with the knobs of a ``KLTConfig``."""
    return track_features(
        prev_pyr, next_pyr, pts, valid, window=cfg.window,
        num_iters=cfg.num_iters, eps=cfg.eps,
        min_eig_threshold=cfg.min_eig_threshold,
        max_residual=cfg.max_residual)
