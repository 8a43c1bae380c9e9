"""Shi-Tomasi / Harris corners with grid-cell NMS (port of
``ops/corners.py``): min-eigenvalue score, 3x3 local max, quality threshold,
a border, one best corner per ``cell`` x ``cell`` block and a global top-k.

Tie order is explicit: ``lax.top_k`` puts the lower index first among equal
scores and ``torch.topk`` promises no order, so the top-k here is a STABLE
descending sort (equal scores keep ascending index order).  The per-cell
argmax takes the first maximum in both frameworks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.config import DetectorConfig
from ..core.slots import stable_top_k
from . import image as imops


def corner_score(img: torch.Tensor, block_size: int = 3,
                 use_harris: bool = False,
                 harris_k: float = 0.04) -> torch.Tensor:
    """Min-eigenvalue (Shi-Tomasi) or Harris response map, (H, W) f32."""
    gx, gy = imops.sobel_gradients(img)
    a = imops.box_filter(gx * gx, block_size, normalize=True)
    b = imops.box_filter(gx * gy, block_size, normalize=True)
    c = imops.box_filter(gy * gy, block_size, normalize=True)
    if use_harris:
        det = a * c - b * b
        tr = a + c
        return det - harris_k * tr * tr
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    return half_tr - torch.sqrt(half_diff * half_diff + b * b)


def _local_max_3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 local maxima; ties keep the pixel (cv2's dilate-compare)."""
    m = score
    for dy, dx in ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1),
                   (1, 0), (1, 1)):
        m = torch.maximum(m, imops._shift(score, dy, dx))
    return score >= m


def detect_corners(
    img: torch.Tensor,
    *,
    max_corners: int = 1400,
    quality_level: float = 0.1,
    cell: int = 10,
    block_size: int = 3,
    use_harris: bool = False,
    harris_k: float = 0.04,
    border: int = 4,
):
    """Up to ``max_corners`` corners of an (H, W) image.

    Returns uv (max_corners, 2) f32 [x, y] in descending score order,
    score (max_corners,) f32 and valid (max_corners,) bool."""
    H, W = img.shape
    dev = img.device
    score = corner_score(img.to(torch.float32), block_size, use_harris,
                         harris_k)
    is_max = _local_max_3x3(score)
    qmax = torch.max(score)
    ok = is_max & (score > quality_level * qmax) & (score > 0.0)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ok = ok & (xs >= border) & (xs < W - border) & (ys >= border) & (
        ys < H - border)

    neg = torch.finfo(score.dtype).min
    masked = torch.where(ok, score, torch.full_like(score, neg))

    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    padded = F.pad(masked, (0, Wp - W, 0, Hp - H), value=neg)
    cells = padded.reshape(Hp // cell, cell, Wp // cell, cell).permute(
        0, 2, 1, 3).reshape(Hp // cell, Wp // cell, cell * cell)
    cell_best, cell_arg = torch.max(cells, dim=-1)

    flat_scores = cell_best.reshape(-1)
    k = min(max_corners, flat_scores.shape[0])
    top_vals, top_idx = stable_top_k(flat_scores, k)

    n_cx = Wp // cell
    cy = top_idx // n_cx
    cx = top_idx % n_cx
    inner = cell_arg.reshape(-1)[top_idx]
    y = cy * cell + inner // cell
    x = cx * cell + inner % cell

    uv = torch.stack([x, y], -1).to(torch.float32)
    valid = top_vals > neg
    if k < max_corners:
        pad = max_corners - k
        uv = F.pad(uv, (0, 0, 0, pad))
        top_vals = F.pad(top_vals, (0, pad), value=neg)
        valid = F.pad(valid, (0, pad))
    return uv, top_vals, valid


def detect_corners_config(img: torch.Tensor, cfg: DetectorConfig,
                          border: int = 4):
    """``detect_corners`` with the knobs of a ``DetectorConfig``."""
    return detect_corners(
        img, max_corners=cfg.max_corners, quality_level=cfg.quality_level,
        cell=int(cfg.min_dist), block_size=cfg.block_size,
        use_harris=cfg.use_harris, harris_k=cfg.harris_k, border=border)
