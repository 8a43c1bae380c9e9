"""DoG SIFT detector + descriptor (port of ``ops/sift.py``).

The reference's design, in torch ops: a Gaussian scale space with a 2x
bilinearly upsampled first octave (cv2's firstOctave=-1), 3x3x3 DoG extrema
with an edge test, one Newton step of subpixel refinement, a 36-bin
orientation histogram with one secondary peak, and a 4x4x8 trilinear
descriptor sampled from the Gaussian level nearest each keypoint's scale.
Output shapes are fixed: ``max_features`` rows with a validity mask.

Where the port departs from the reference's code (not its results):
  * the orientation and descriptor stage samples, for each keypoint, only
    the level it keeps (the reference computes all ``s`` levels for every
    keypoint and gathers one): the same arithmetic on the same samples;
  * the histogram and descriptor sums are ``scatter_add_`` on the CPU, in
    the reference's order; on a CUDA device, where ``scatter_add_`` adds in
    atomic order (two calls on one image could differ, and an argmax
    between two near-equal bins flip an orientation), they are sums in a
    fixed order (``_fixed_order``): the histogram a one-hot (K, 289, 36)
    summed over the samples, the descriptor a one-hot over its 8
    orientation bins gathered by spatial cell (each cell takes 128 of the
    2048 corner-sample terms) and summed;
  * the per-octave top-k over the DoG stack is ``torch.topk``, whose order
    among equal scores is not ``lax.top_k``'s; only rows of score 0 (never
    valid) tie in practice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import linalg
from ..core.linalg import kept
from ..core.slots import stable_top_k
from . import image as imops


class SiftFeatures(NamedTuple):
    uv: torch.Tensor  # (K, 2) full-resolution pixel coords (x, y)
    scale: torch.Tensor  # (K,) sigma in full-res pixels
    orientation: torch.Tensor  # (K,) radians
    score: torch.Tensor  # (K,) |DoG| contrast
    desc: torch.Tensor  # (K, 128) L2-normalized descriptors
    valid: torch.Tensor  # (K,) bool


def upsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling with half-pixel centres and clamped edges
    (``jax.image.resize(img, (2H, 2W), "linear")``)."""
    H, W = img.shape
    return F.interpolate(img[None, None], size=(2 * H, 2 * W),
                         mode="bilinear", align_corners=False)[0, 0]


def _scale_space(img: torch.Tensor, num_octaves: int, s: int, sigma0: float,
                 first_octave: int = 0):
    """Gaussian pyramid: per octave, s+3 levels with sigma0 * 2^(l/s)."""
    if first_octave == -1:
        img = upsample2x(img)
        base_blur = 1.0
        num_octaves += 1
    else:
        base_blur = 0.5
    octaves = []
    base = imops.gaussian_blur(
        img, math.sqrt(max(sigma0 ** 2 - base_blur ** 2, 0.01)))
    k = 2.0 ** (1.0 / s)
    for _ in range(num_octaves):
        levels = [base]
        sig_prev = sigma0
        for lv in range(1, s + 3):
            sig_total = sigma0 * (k ** lv)
            sig_extra = math.sqrt(sig_total ** 2 - sig_prev ** 2)
            levels.append(imops.gaussian_blur(levels[-1], sig_extra))
            sig_prev = sig_total
        octaves.append(levels)
        base = levels[s][::2, ::2].contiguous()  # next octave at 2*sigma0
    return octaves


def extrema3(stack: torch.Tensor):
    """3x3x3 max and min of an (L, H, W) stack with -inf / +inf outside it
    (``lax.reduce_window`` with "SAME" padding)."""
    x = stack[None, None]
    mx = F.max_pool3d(x, 3, stride=1, padding=1)[0, 0]
    mn = -F.max_pool3d(-x, 3, stride=1, padding=1)[0, 0]
    return mx, mn


def _octave_extrema(dogs, s: int, contrast_thr: float, edge_thr: float,
                    per_octave: int):
    """Refined extrema of one octave's DoG stack (s+2 planes (H, W)).

    Returns fixed-size (per_octave, ...) candidates: xy (x, y), refined
    level, score and validity."""
    H, W = dogs[0].shape
    stack = torch.stack(dogs)  # (L, H, W)
    L = stack.shape[0]

    mx, mn = extrema3(stack)
    prelim = 0.5 * contrast_thr / s
    is_ext = ((stack >= mx) | (stack <= mn)) & (torch.abs(stack) > prelim)

    # Spatial Hessian edge test (rolls wrap; the 8 px border hides it).
    dxx = torch.roll(stack, -1, 2) + torch.roll(stack, 1, 2) - 2 * stack
    dyy = torch.roll(stack, -1, 1) + torch.roll(stack, 1, 1) - 2 * stack
    dxy = 0.25 * (
        torch.roll(torch.roll(stack, -1, 1), -1, 2)
        + torch.roll(torch.roll(stack, 1, 1), 1, 2)
        - torch.roll(torch.roll(stack, -1, 1), 1, 2)
        - torch.roll(torch.roll(stack, 1, 1), -1, 2)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr / torch.where(det > 0, det, 1.0)
                           < (edge_thr + 1.0) ** 2 / edge_thr)

    # Only interior levels / pixels can be keypoints.
    border = 8
    dev = stack.device
    lvl_ok = (torch.arange(L, device=dev) >= 1) & (
        torch.arange(L, device=dev) <= L - 2)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    interior = (lvl_ok[:, None, None]
                & ((ys >= border) & (ys < H - border))[None, :, None]
                & ((xs >= border) & (xs < W - border))[None, None, :])
    cand = is_ext & edge_ok & interior

    score = torch.where(cand, torch.abs(stack), 0.0)
    flat = score.reshape(-1)
    k = min(per_octave, flat.shape[0])
    top_vals, top_idx = torch.topk(flat, k)
    lvl = top_idx // (H * W)
    rem = top_idx % (H * W)
    y = rem // W
    x = rem % W

    # One Newton step of subpixel refinement: offset = -H3^-1 g.  Rows of
    # score 0 may sit anywhere; clamping keeps their neighbour reads in
    # bounds (they are never valid).
    l0 = lvl.clamp(1, L - 2)
    y0 = y.clamp(1, H - 2)
    x0 = x.clamp(1, W - 2)

    def at(a, dl, dy, dx):
        return a[l0 + dl, y0 + dy, x0 + dx]

    g = torch.stack([
        0.5 * (at(stack, 0, 0, 1) - at(stack, 0, 0, -1)),
        0.5 * (at(stack, 0, 1, 0) - at(stack, 0, -1, 0)),
        0.5 * (at(stack, 1, 0, 0) - at(stack, -1, 0, 0)),
    ], -1)
    hxx = at(dxx, 0, 0, 0)
    hyy = at(dyy, 0, 0, 0)
    hxy = at(dxy, 0, 0, 0)
    c = at(stack, 0, 0, 0)
    hss = at(stack, 1, 0, 0) + at(stack, -1, 0, 0) - 2 * c
    hxs = 0.25 * (at(stack, 1, 0, 1) - at(stack, 1, 0, -1)
                  - at(stack, -1, 0, 1) + at(stack, -1, 0, -1))
    hys = 0.25 * (at(stack, 1, 1, 0) - at(stack, 1, -1, 0)
                  - at(stack, -1, 1, 0) + at(stack, -1, -1, 0))
    H3 = torch.stack([torch.stack([hxx, hxy, hxs], -1),
                      torch.stack([hxy, hyy, hys], -1),
                      torch.stack([hxs, hys, hss], -1)], -2)
    eye = torch.eye(3, dtype=stack.dtype, device=dev)
    off = -linalg.solve3(H3 + 1e-6 * eye, g)
    off = torch.clamp(off, -0.6, 0.6)
    contrast = c + 0.5 * torch.sum(g * off, -1)
    valid = (top_vals > 0) & (torch.abs(contrast) >= contrast_thr / s)

    xy = torch.stack([x + off[:, 0], y + off[:, 1]], -1)
    level_f = lvl.to(torch.float32) + off[:, 2]
    return xy, level_f, torch.abs(contrast), valid


def _sample_levels(planes: torch.Tensor, li: torch.Tensor,
                   uv: torch.Tensor) -> torch.Tensor:
    """``imops.bilinear_sample`` of plane ``li[k]`` of an (L, H, W) stack at
    the (K, P, 2) coordinates of row k."""
    _, H, W = planes.shape
    x = uv[..., 0].clamp(0.0, W - 1.000001)
    y = uv[..., 1].clamp(0.0, H - 1.000001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.nan_to_num(x0).to(torch.int64)
    y0i = torch.nan_to_num(y0).to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    lv = li[:, None]
    return (planes[lv, y0i, x0i] * (1 - fx) * (1 - fy)
            + planes[lv, y0i, x1i] * fx * (1 - fy)
            + planes[lv, y1i, x0i] * (1 - fx) * fy
            + planes[lv, y1i, x1i] * fx * fy)


def _peak_theta(hist: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Parabolic peak interpolation of (K, 36) histograms around bins b."""
    def bin_(i):
        return torch.gather(hist, 1, (i % 36)[:, None])[:, 0]

    c0, c1, c2 = bin_(b - 1), bin_(b), bin_(b + 1)
    denom = c0 - 2 * c1 + c2
    off = torch.where(torch.abs(denom) > 1e-9, 0.5 * (c0 - c2) / denom, 0.0)
    return ((b + off) / 36.0) * 2 * math.pi - math.pi


def _fixed_order(t: torch.Tensor) -> bool:
    """Whether the binned sums take their fixed-order form: off the CPU,
    where ``scatter_add_`` adds in atomic order."""
    return t.device.type != "cpu"


def _one_hot_sum(bins: torch.Tensor, values: torch.Tensor, n: int,
                 dim: int) -> torch.Tensor:
    """Sum of ``values`` into ``n`` bins by ``bins`` (same shape), over
    dimension ``dim``: a one-hot of the bins, a trailing axis of ``n``,
    summed by ``torch.sum``, whose order is fixed by the shape."""
    hot = bins[..., None] == torch.arange(n, device=bins.device)
    return torch.where(hot, values[..., None], 0.0).sum(dim)


def _orientations(mag, ang, li, xy, sig):
    """Dominant and secondary orientation (theta1, theta2, has2) of each
    keypoint from a 36-bin histogram over 17x17 samples."""
    grid = imops.window_coords(17, xy.device)  # (289, 2) in [-8, 8]
    coords = xy[:, None, :] + grid[None] * (0.75 * sig)[:, None, None]
    m = _sample_levels(mag, li, coords)
    a = _sample_levels(ang, li, coords)
    w = torch.exp(-torch.sum((grid * 0.75) ** 2, -1) / (2 * (1.5 ** 2)))
    bins = torch.remainder(
        torch.floor((a / (2 * math.pi) + 0.5) * 36).to(torch.int64), 36)
    if _fixed_order(m):
        hist = _one_hot_sum(bins, m * w, 36, 1)
    else:
        hist = torch.zeros((xy.shape[0], 36), dtype=m.dtype, device=m.device)
        hist.scatter_add_(1, bins, m * w)
    # Smooth the circular histogram twice.
    for _ in range(2):
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    b = torch.argmax(hist, 1)
    theta1 = _peak_theta(hist, b)
    # Secondary: the largest OTHER local max >= 0.8x the dominant peak.
    is_peak = (hist > torch.roll(hist, 1, 1)) & (hist >= torch.roll(hist, -1,
                                                                    1))
    not_b = torch.arange(36, device=hist.device)[None] != b[:, None]
    others = torch.where(is_peak & not_b, hist, -torch.inf)
    b2 = torch.argmax(others, 1)
    peak = torch.gather(hist, 1, b[:, None])[:, 0]
    has2 = torch.gather(others, 1, b2[:, None])[:, 0] >= 0.8 * peak
    return theta1, _peak_theta(hist, b2), has2


def _descriptors(mag, ang, li, xy, sig, theta):
    """4x4x8 descriptors of 16x16 samples in each keypoint's rotated frame,
    trilinearly binned, normalized, clipped at 0.2 and renormalized."""
    D = 16
    dgrid = imops.window_coords(D, xy.device)  # (256, 2) in [-7.5, 7.5]
    c, s_ = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s_], -1),
                       torch.stack([s_, c], -1)], -2)  # (K, 2, 2)
    coords = xy[:, None, :] + (dgrid @ rot.transpose(-1, -2)) * (
        0.4 * sig)[:, None, None]
    m = _sample_levels(mag, li, coords)
    a = _sample_levels(ang, li, coords) - theta[:, None]
    w = torch.exp(-torch.sum(dgrid ** 2, -1) / (2 * (0.5 * D) ** 2))
    mw = m * w

    cx0, cy0, cx, cy = _cell_coords(dgrid)
    ob = (a / (2 * math.pi) + 1.5) * 8.0  # orientation in bins (mod 8)
    ob0 = torch.floor(ob)
    io, val = [], []
    for dxc in (0, 1):
        for dyc in (0, 1):
            for dob in (0, 1):
                wx = 1 - (cx - cx0) if dxc == 0 else cx - cx0
                wy = 1 - (cy - cy0) if dyc == 0 else cy - cy0
                wo = 1 - (ob - ob0) if dob == 0 else ob - ob0
                io.append(torch.remainder(ob0.to(torch.int64) + dob, 8))
                inside = ((cx0 + dxc >= 0) & (cx0 + dxc <= 3)
                          & (cy0 + dyc >= 0) & (cy0 + dyc <= 3))
                val.append(torch.where(inside, mw * wx * wy * wo, 0.0))
    io, val = torch.cat(io, 1), torch.cat(val, 1)  # corner-major
    K = xy.shape[0]
    if _fixed_order(m):
        # Each spatial cell's 128 terms in corner-major order, one-hot over
        # the orientation bins, summed.
        cells = kept(("sift_cells",), m.device, _cell_terms)  # (16, 128)
        desc = _one_hot_sum(io[:, cells], val[:, cells], 8, 2).reshape(K, 128)
    else:
        # One scatter, the updates in the reference's order (corner-major).
        cell = kept(("sift_cell",), m.device, _term_cells)  # (2048,)
        desc = torch.zeros((K, 128), dtype=m.dtype, device=m.device)
        desc.scatter_add_(1, cell[None] * 8 + io, val)
    v = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1),
                           min=1e-9)[:, None]
    v = torch.clamp(v, 0.0, 0.2)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=1),
                           min=1e-9)[:, None]


def _cell_coords(dgrid: torch.Tensor):
    """Floor and value of the descriptor's cell coordinates (x, y) of each
    sample of the 16x16 grid ``dgrid``, in [-0.5, 3.5]."""
    cell = (dgrid + 8.0) / 4.0 - 0.5
    cx, cy = cell[:, 0], cell[:, 1]
    return torch.floor(cx), torch.floor(cy), cx, cy


def _term_cells() -> torch.Tensor:
    """The spatial cell (iy * 4 + ix, the 8 corners' clamped cells) of each
    of the descriptor's 2048 terms, corner-major as ``_descriptors`` lays
    them out: the same for every keypoint."""
    cx0, cy0, _, _ = _cell_coords(imops.window_coords(16))
    return torch.cat([
        torch.clamp(cy0 + dyc, 0, 3).to(torch.int64) * 4
        + torch.clamp(cx0 + dxc, 0, 3).to(torch.int64)
        for dxc in (0, 1) for dyc in (0, 1) for dob in (0, 1)])


def _cell_terms() -> torch.Tensor:
    """(16, 128): the terms of each spatial cell (``_term_cells``), in
    corner-major order."""
    return torch.argsort(_term_cells(), stable=True).reshape(16, 128)


def _orientation_and_descriptor(levels, xy, level_f, sigma_lvl, s):
    """Orientations and descriptors of one octave's keypoints, each from the
    interior Gaussian level nearest its refined DoG level."""
    li = torch.clamp(torch.round(level_f).to(torch.int64), 1, s) - 1
    mags, angs = [], []
    for g in levels[1:s + 1]:
        gx, gy = imops.central_gradients(g)
        mags.append(torch.sqrt(gx * gx + gy * gy))
        angs.append(torch.atan2(gy, gx))
    mag, ang = torch.stack(mags), torch.stack(angs)
    theta1, theta2, has2 = _orientations(mag, ang, li, xy, sigma_lvl)
    desc1 = _descriptors(mag, ang, li, xy, sigma_lvl, theta1)
    desc2 = _descriptors(mag, ang, li, xy, sigma_lvl, theta2)
    return theta1, theta2, has2, desc1, desc2


def detect_and_compute(
    img: torch.Tensor,
    *,
    max_features: int = 2048,
    num_octaves: int = 4,
    scales_per_octave: int = 3,
    contrast_threshold: float = 0.04,
    edge_threshold: float = 10.0,
    sigma: float = 1.6,
    first_octave: int = -1,
) -> SiftFeatures:
    """SIFT keypoints + descriptors of an (H, W) image in [0, 255], on the
    image's device, with fixed output shapes."""
    if first_octave not in (-1, 0):
        raise ValueError(f"first_octave must be -1 or 0, got {first_octave}")
    img = img.to(torch.float32) / 255.0
    s = scales_per_octave
    octaves = _scale_space(img, num_octaves, s, sigma, first_octave)

    per_octave = max_features // 2
    parts = []
    for o, levels in enumerate(octaves):
        dogs = [levels[i + 1] - levels[i] for i in range(len(levels) - 1)]
        xy, level_f, score, valid = _octave_extrema(
            dogs, s, contrast_threshold, edge_threshold, per_octave)
        sigma_lvl = sigma * (2.0 ** (level_f / s))  # octave pixels
        theta, theta2, has2, desc, desc2 = _orientation_and_descriptor(
            levels, xy, level_f, sigma_lvl, s)
        factor = float(2 ** (o + first_octave))
        parts.append((xy * factor, sigma_lvl * factor, theta, score, desc,
                      valid))
        # Secondary-orientation keypoints (same location, scale and score,
        # an epsilon lower so the top-k prefers dominant orientations).
        parts.append((xy * factor, sigma_lvl * factor, theta2,
                      torch.where(has2, score * (1.0 - 1e-6), 0.0), desc2,
                      valid & has2))

    uv, scale, theta, score, desc, valid = (torch.cat(p) for p in zip(*parts))
    masked = torch.where(valid, score, -1.0)
    top_vals, top_idx = stable_top_k(masked, max_features)
    return SiftFeatures(uv=uv[top_idx], scale=scale[top_idx],
                        orientation=theta[top_idx], score=top_vals,
                        desc=desc[top_idx], valid=top_vals > 0)
