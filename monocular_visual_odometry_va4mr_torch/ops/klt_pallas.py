"""The dense coarse-flow prior and the v1 single-level LK tracker (port of
``ops/klt_pallas.py``).

``coarse_flow_volume`` and ``sample_map_onehot`` are plain tensor code; the
KLT chain of ``ops/klt_pallas2.py`` uses them too.

``klt_v1`` is the kernel wrapper of the v1 tracker (``klt.backend="pallas"``).
On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/klt_v1.cu``, which replaces the TPU kernel
``ops/klt_pallas.py::_klt_kernel``, or raises; on a CPU tensor, and only
there, it runs ``klt_v1_plain``, a plain PyTorch version of the same function
batched over features.  ``klt_v1.launches`` counts kernel launches.  Like
``klt_pallas2.klt_lk`` it takes one problem or a batch of B in one launch,
through the custom op ``mvo::klt_v1`` whose vmap rule (``fold_vmap``) folds
a ``torch.func.vmap``'s batch into the launch's.

What v1 computes per feature, in the reference's float32 order: a 48x256
slab of the edge-padded planes (PAD=16) whose base is 8-row / 128-lane
aligned below min(template, prediction); the template window (15x15) and its
central-difference gradients at the template's sub-pixel phase; up to
``num_iters`` Gauss-Newton updates (update, then freeze once |delta| < eps)
of the offset g from the prediction q, the search window's integer origin
clipped to the slab and blended at the unclipped phase; the gates in-image,
in-slab, min-eig, residual and valid.  No +-8 px drift guard and no clip of
the input positions, unlike ``klt_pallas2``.

The reference kernel rolls its 24 template rows and its 256 slab columns
circularly, so row -1 of the template's upward gradient reads slab row
``yi + 23`` when the template's slab row ``yi`` is a multiple of 8, and
column -1 of its leftward gradient reads slab column 255 when ``xi == 0``.
The port reads those same rows and columns (``klt_v1_plain``), so its result
is the reference's on every feature.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _build

COARSE_LEVEL = 4  # 1/16 resolution for the prior volume
COARSE_RANGE = 10  # +-10 coarse px -> +-160 full-res px motion coverage

# --- geometry of the v1 tracker (reference klt_pallas.py:42-45, :155) ---
WIN = 15
R = (WIN - 1) // 2
ROWS = 48  # slab rows
LANES = 256  # slab lanes
SLAB_PAD = 16  # the planes are edge-padded by 16 px top/left
TEMPLATE_ROWS = 24  # slab rows the template's gradients are rolled within
BF = 8  # features per reference program: N must be a multiple of it
META_COLS = 5  # [py, px, qy, qx, valid]
OUT_COLS = 5  # [x, y, ok, resid, min_eig]


def _box_sum_zero_pad(x: torch.Tensor, win: int) -> torch.Tensor:
    """win x win box sum over the last two axes with zero padding: a column
    pass, then a row pass, each summing its taps in order."""
    r = win // 2
    H, W = x.shape[-2:]
    xp = F.pad(x, (0, 0, r, r))
    acc = xp[..., 0:H, :]
    for d in range(1, win):
        acc = acc + xp[..., d:d + H, :]
    xp = F.pad(acc, (r, r, 0, 0))
    acc = xp[..., :, 0:W]
    for d in range(1, win):
        acc = acc + xp[..., :, d:d + W]
    return acc


def coarse_flow_volume(i0: torch.Tensor, i1: torch.Tensor,
                       rng: int = COARSE_RANGE, win: int = 5) -> torch.Tensor:
    """Dense integer flow at the input resolution via an SSD cost volume.

    Returns flow (H, W, 2) f32 in pixels of the input images: the FIRST
    argmin over the (2*rng+1)^2 shifts of the win x win box-summed squared
    difference, refined by a 1-D parabola per axis clipped to +-0.5.
    """
    H, W = i0.shape
    D = 2 * rng + 1
    pad = rng + 1
    i1p = F.pad(i1[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    # All (2*rng+1)^2 shifted views at once: [a, b, y, x] = i1 at
    # (y + a - rng, x + b - rng), edge-clamped; a is the dy-major index.
    c = pad - rng
    shifted = i1p[c:c + H + 2 * rng, c:c + W + 2 * rng].unfold(
        0, H, 1).unfold(1, W, 1)  # (D, D, H, W)
    diffs = ((shifted - i0) ** 2).reshape(D * D, H, W)
    costs = _box_sum_zero_pad(diffs, win)

    best = torch.argmin(costs, dim=0)  # first minimum, as jnp.argmin
    by = best // D
    bx = best % D

    def take(idx):
        return torch.gather(costs, 0, idx.clamp(0, D * D - 1)[None])[0]

    c0 = take(best)
    cxm = take(torch.where(bx > 0, best - 1, best))
    cxp = take(torch.where(bx < D - 1, best + 1, best))
    cym = take(torch.where(by > 0, best - D, best))
    cyp = take(torch.where(by < D - 1, best + D, best))

    def parab(cm, c, cp):
        denom = cm - 2 * c + cp
        off = torch.where(denom.abs() > 1e-6, 0.5 * (cm - cp) / denom,
                          torch.zeros_like(denom))
        return off.clamp(-0.5, 0.5)

    fx = (bx - rng).to(torch.float32) + parab(cxm, c0, cxp)
    fy = (by - rng).to(torch.float32) + parab(cym, c0, cyp)
    return torch.stack([fx, fy], -1)


def sample_map_onehot(fmap: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample a small (h, w, C) map at (N, 2) [x, y] positions.

    The reference selects the four corners with one-hot matmuls; an exact
    gather gives the same values.  The clip to w-1.001 / h-1.001 keeps
    x0+1 / y0+1 inside the map; a NaN position reads corner 0 and comes
    back NaN through its weights."""
    h, w, _ = fmap.shape
    x = pts[:, 0].clamp(0.0, w - 1.001)
    y = pts[:, 1].clamp(0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    xi = torch.nan_to_num(x0).to(torch.int64)
    yi = torch.nan_to_num(y0).to(torch.int64)
    v00 = fmap[yi, xi]
    v01 = fmap[yi, xi + 1]
    v10 = fmap[yi + 1, xi]
    v11 = fmap[yi + 1, xi + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


# ---------------------------------------------------------------------------
# v1 LK: plain version, kernel wrapper, tracker
# ---------------------------------------------------------------------------

def _ring(idx, ring):
    """Indices read circularly within a per-feature block: ``ring`` = (base
    (..., N), period) maps ``idx`` to base + (idx - base) mod period; None
    keeps them."""
    if ring is None:
        return idx
    base, period = ring
    base = base.to(torch.int64)[..., None]
    return base + torch.remainder(idx - base, period)


def sample_patches(img, oy, ox, fy, fx, n, row_ring=None, col_ring=None):
    """n x n bilinear patches with integer corners (oy, ox) + (i, j) and
    per-feature weights (fy, fx), reads clamped to the image.

    ``row_ring`` / ``col_ring``: (base, period) of a block of rows / columns
    that the reads wrap around in, as a reference kernel's circular roll of
    its slab does (``_ring``); the wrapped index is then clamped.

    (..., N) origins and weights on (..., H, W) planes -> (..., N, n, n), in
    the reference's operation order: one problem, or a batch of them on a
    leading axis."""
    H, W = img.shape[-2:]
    ar = torch.arange(n + 1, device=img.device)
    rows = _ring(oy.to(torch.int64)[..., None] + ar, row_ring).clamp(0, H - 1)
    cols = _ring(ox.to(torch.int64)[..., None] + ar, col_ring).clamp(0, W - 1)
    at = rows[..., :, None] * W + cols[..., None, :]  # (..., N, n+1, n+1)
    lead = at.shape[:-3]
    P = torch.gather(img.reshape(lead + (H * W,)), -1,
                     at.reshape(lead + (-1,))).reshape(at.shape)
    t, t01 = P[..., :-1, :-1], P[..., :-1, 1:]
    t10, t11 = P[..., 1:, :-1], P[..., 1:, 1:]
    fx = fx[..., None, None]
    fy = fy[..., None, None]
    return (t * (1 - fx) * (1 - fy) + t01 * fx * (1 - fy)
            + t10 * (1 - fx) * fy + t11 * fx * fy)


def padded_shape(H: int, W: int) -> Tuple[int, int]:
    """The reference's padded plane size: 8-row / 128-lane aligned, at least
    one slab (klt_pallas.py:400-403)."""
    Hp = max(-(-(H + 2 * SLAB_PAD) // 8) * 8, ROWS)
    Wp = max(-(-(W + 2 * SLAB_PAD) // 128) * 128, LANES)
    return Hp, Wp


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int64 with NaN -> 0 and values clamped to +-1e8 (the
    reference's float->int32 conversion gives 0 for NaN and saturates)."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-1e8, 1e8)
    return torch.floor(x).to(torch.int64)


def slab_geometry(meta: torch.Tensor, H: int, W: int):
    """Per feature: the slab base (y0, x0) in padded coordinates and the
    template's slab-relative origin (yi, xi) after the clip, with ``sub =
    yi % 8`` the row offset whose value 0 exposes the reference's template
    row wrap.  Returns (y0, x0, yi, xi), int64 (..., N)."""
    Hp, Wp = padded_shape(H, W)
    py, px, qy, qx = meta[..., 0], meta[..., 1], meta[..., 2], meta[..., 3]
    y0 = (torch.div(_floor_int(torch.minimum(py, qy)) + SLAB_PAD - 12, 8,
                    rounding_mode="floor") * 8).clamp(0, Hp - ROWS)
    x0 = (torch.div(_floor_int(torch.minimum(px, qx)) + SLAB_PAD - 96, 128,
                    rounding_mode="floor") * 128).clamp(0, Wp - LANES)
    ty = (py - R) - (y0.to(torch.float32) - SLAB_PAD)
    tx = (px - R) - (x0.to(torch.float32) - SLAB_PAD)
    yi = _floor_int(ty).clamp(0, ROWS - WIN - 2)
    xi = _floor_int(tx).clamp(0, LANES - WIN - 2)
    return y0, x0, yi, xi


def _register(s: torch.Tensor, base: torch.Tensor, hi: int):
    """Slab-relative window origin ``s`` -> (image row/col of the clipped
    integer origin, phase of the unclipped one)."""
    i = _floor_int(s).clamp(0, hi)
    return base - SLAB_PAD + i, s - torch.floor(s)


def klt_v1_plain(tmpl, srch, meta, *, num_iters, eps, min_eig_threshold,
                 max_residual):
    """Plain PyTorch version of the kernel: same inputs, same output, for
    one problem or a batch on a leading axis ((B, H, W) planes, (B, N, 5)
    meta -> (B, N, 5)); each problem of a batch rounds as it does alone."""
    H, W = tmpl.shape[-2:]
    py, px, qy, qx, vf = meta.unbind(-1)
    y0, x0, yi, _ = slab_geometry(meta, H, W)
    y0f = y0.to(torch.float32) - SLAB_PAD
    x0f = x0.to(torch.float32) - SLAB_PAD
    hi_y, hi_x = ROWS - WIN - 2, LANES - WIN - 2

    oy, fy = _register((py - R) - y0f, y0, hi_y)
    ox, fx = _register((px - R) - x0f, x0, hi_x)
    # Template on a 17x17 grid: the window plus the one-pixel ring the
    # central differences read.  The reference loads TEMPLATE_ROWS slab rows
    # from the 8-aligned row at or above the template's slab row yi, then
    # rolls them up by yi % 8 and left by xi, circularly over those rows and
    # the slab's LANES columns (klt_pallas.py:202-207, :248-251).  So grid
    # row -1, which only the upward gradient of window row 0 reads, is slab
    # row yi + 23 when yi % 8 == 0, and grid column -1, which only the
    # leftward gradient of window column 0 reads, is slab column 255 when
    # xi == 0 (a template more than 8 px left of the image); every other
    # read lies inside both rings.
    rows8 = y0 - SLAB_PAD + torch.div(yi, 8, rounding_mode="floor") * 8
    Tb = sample_patches(tmpl, oy - 1, ox - 1, fy, fx, WIN + 2,
                        row_ring=(rows8, TEMPLATE_ROWS),
                        col_ring=(x0 - SLAB_PAD, LANES))
    WT = Tb[..., 1:-1, 1:-1]
    Ix = 0.5 * (Tb[..., 1:-1, 2:] - Tb[..., 1:-1, :-2])
    Iy = 0.5 * (Tb[..., 2:, 1:-1] - Tb[..., :-2, 1:-1])
    gxx = (Ix * Ix).sum((-2, -1))
    gxy = (Ix * Iy).sum((-2, -1))
    gyy = (Iy * Iy).sum((-2, -1))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det,
                                                 min=0.0)))
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det,
                          torch.zeros_like(det))

    def search(gy, gx):
        sy = ((qy + gy) - R) - y0f
        sx = ((qx + gx) - R) - x0f
        wy, ay = _register(sy, y0, hi_y)
        wx, ax = _register(sx, x0, hi_x)
        return sample_patches(srch, wy, wx, ay, ax, WIN), sy, sx

    gx = torch.zeros_like(qx)
    gy = torch.zeros_like(qy)
    frozen = torch.zeros(meta.shape[:-1], dtype=torch.bool,
                         device=meta.device)
    for _ in range(num_iters):
        diff = search(gy, gx)[0] - WT
        b0 = (diff * Ix).sum((-2, -1))
        b1 = (diff * Iy).sum((-2, -1))
        d0 = -(gyy * b0 - gxy * b1) * inv_det
        d1 = -(-gxy * b0 + gxx * b1) * inv_det
        gx = torch.where(frozen, gx, gx + d0)
        gy = torch.where(frozen, gy, gy + d1)
        frozen = frozen | ((d0 * d0 + d1 * d1) < eps * eps)

    cur, sy, sx = search(gy, gx)
    resid = (cur - WT).abs().sum((-2, -1)) / (WIN * WIN)
    new_x = qx + gx
    new_y = qy + gy
    inb = ((new_x >= R) & (new_x <= W - 1 - R)
           & (new_y >= R) & (new_y <= H - 1 - R))
    in_slab = ((sx >= 0) & (sx < LANES - WIN - 1)
               & (sy >= 0) & (sy < ROWS - WIN - 1))
    eig_ok = (min_eig / (WIN * WIN)) > min_eig_threshold
    ok = inb & in_slab & eig_ok & (resid < max_residual) & (vf > 0.5)
    return torch.stack([new_x, new_y, ok.to(torch.float32), resid, min_eig],
                       -1)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# klt_v1_launch(tmpl, srch, B, H, W, Hp, Wp, meta, n, num_iters, eps2,
#               min_eig_thr, max_resid, out, stream)
LAUNCH_ARGTYPES = (_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _F, _F, _F, _P,
                   _P)


def _entry():
    return _build.entry("klt_v1", LAUNCH_ARGTYPES)


def fold_vmap(op, info, in_dims, tensors, scalars):
    """The vmap rule of a kernel op whose tensors carry a leading batch axis
    (``mvo::klt_v1``, ``mvo::klt_lk``): each tensor's vmapped dimension (an
    unbatched tensor expanded) is folded into that axis, so the whole batch
    is ONE call of the op, one launch on the card.  Returns (output, 0)."""
    S = info.batch_size
    lead = [t.movedim(d, 0) if d is not None else t.expand(S, *t.shape)
            for t, d in zip(tensors, in_dims)]
    B = lead[0].shape[1]
    out = op(*(t.reshape(S * B, *t.shape[2:]).contiguous() for t in lead),
             *scalars)
    return out.view(S, B, *out.shape[1:]), 0


@torch.library.custom_op("mvo::klt_v1", mutates_args=())
def _klt_v1_op(tmpl: torch.Tensor, srch: torch.Tensor, meta: torch.Tensor,
               num_iters: int, eps: float, min_eig_threshold: float,
               max_residual: float) -> torch.Tensor:
    """(B, H, W) planes, (B, N, 5) meta -> (B, N, 5): one launch of the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if tmpl.device.type == "cpu":
        return klt_v1_plain(tmpl, srch, meta, num_iters=num_iters, eps=eps,
                            min_eig_threshold=min_eig_threshold,
                            max_residual=max_residual)
    if tmpl.device.type != "cuda":
        raise ValueError(
            f"klt_v1 runs on CUDA or CPU tensors; got {tmpl.device}")
    for name, t in (("tmpl", tmpl), ("srch", srch), ("meta", meta)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, W = tmpl.shape
    N = meta.shape[1]
    Hp, Wp = padded_shape(H, W)
    out = torch.empty((B, N, OUT_COLS), dtype=torch.float32,
                      device=tmpl.device)
    with torch.cuda.device(tmpl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(tmpl.data_ptr(), srch.data_ptr(), B, H, W, Hp, Wp,
                       meta.data_ptr(), N, num_iters, eps * eps,
                       min_eig_threshold, max_residual, out.data_ptr(), stream)
    klt_v1.launches += 1
    if err != 0:
        raise RuntimeError(f"klt_v1 kernel launch failed: CUDA error {err}")
    return out


@_klt_v1_op.register_fake
def _(tmpl, srch, meta, *scalars):
    return meta.new_empty(meta.shape[:-1] + (OUT_COLS,))


@_klt_v1_op.register_vmap
def _(info, in_dims, tmpl, srch, meta, *scalars):
    return fold_vmap(_klt_v1_op, info, in_dims, (tmpl, srch, meta), scalars)


def klt_v1(tmpl: torch.Tensor, srch: torch.Tensor, meta: torch.Tensor, *,
           num_iters: int, eps: float, min_eig_threshold: float,
           max_residual: float) -> torch.Tensor:
    """v1 LK for N features: template plane ``tmpl``, search plane ``srch``;
    or for a batch of B such problems in one launch.

    Args:
      tmpl, srch: (H, W) float32 planes on one device, or (B, H, W).
      meta: (N, 5) float32 [py, px, qy, qx, valid]: template position,
        predicted position in the search plane, valid flag (> 0.5); (B, N,
        5) for a batch.  N must be a multiple of 8 (the reference silently
        drops the remainder).

    Returns (N, 5) float32 [x, y, ok, resid, min_eig], or (B, N, 5).  Under
    ``torch.func.vmap`` the vmap's batch joins the launch's."""
    if tmpl.dim() not in (2, 3) or srch.shape != tmpl.shape:
        raise ValueError(f"planes must be (H, W) or (B, H, W) of one shape; "
                         f"got {tuple(tmpl.shape)} and {tuple(srch.shape)}")
    lead = tuple(tmpl.shape[:-2])
    N = meta.shape[-2] if meta.dim() == len(lead) + 2 else -1
    if meta.shape != lead + (N, META_COLS):
        raise ValueError(f"meta must be {lead + ('N', META_COLS)}; got "
                         f"{tuple(meta.shape)}")
    if N % BF:
        raise ValueError(f"the v1 tracker takes N % {BF} == 0 features; got "
                         f"N={N} (pad the table)")
    for name, t in (("tmpl", tmpl), ("srch", srch), ("meta", meta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if t.device != tmpl.device:
            raise ValueError(f"{name} is on {t.device}, tmpl on {tmpl.device}")
    if tmpl.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"klt_v1 runs on CUDA or CPU tensors; got {tmpl.device}")
    if num_iters < 0:
        raise ValueError(f"num_iters must be >= 0; got {num_iters}")
    # Contiguity is checked where the kernel launches (a copy here would
    # hide a caller's layout); under vmap the op's rule lays the batch out.
    args = [t if lead else t[None] for t in (tmpl, srch, meta)]
    out = _klt_v1_op(*args, num_iters, eps, min_eig_threshold, max_residual)
    return out if lead else out[0]


klt_v1.launches = 0


def track_features_pallas(
    prev_pyr: Tuple[torch.Tensor, ...],
    next_pyr: Tuple[torch.Tensor, ...],
    pts: torch.Tensor,  # (N, 2) [x, y] positions in the previous frame
    valid: torch.Tensor,  # (N,) bool
    *,
    num_iters: int = 10,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
    max_residual: float = 20.0,
    prior: torch.Tensor = None,
    win: int = 15,
):
    """Track ``pts`` from ``prev_pyr[0]`` to ``next_pyr[0]`` with the v1
    tracker.  N must be a multiple of 8; the window is fixed at 15 (``win``
    is accepted so every tracker takes the same arguments).

    ``prior``: optional (N, 2) flow prior in px of the level-0 planes;
    without it the coarse volume at level ``min(COARSE_LEVEL, len - 1)``
    supplies one.  Returns (new_pts (N, 2), ok (N,), resid (N,))."""
    if win != 15:
        raise ValueError(f"the v1 tracker's window is fixed at 15; got {win}")
    i0, i1 = prev_pyr[0], next_pyr[0]
    H, _ = i0.shape
    if prior is None:
        coarse_prev = prev_pyr[min(COARSE_LEVEL, len(prev_pyr) - 1)]
        coarse_next = next_pyr[min(COARSE_LEVEL, len(next_pyr) - 1)]
        scale = float(round(H / coarse_prev.shape[0]))
        flow_c = coarse_flow_volume(coarse_prev, coarse_next)
        pred = sample_map_onehot(flow_c, pts / scale) * scale
    else:
        pred = prior
    q = pts + pred
    meta = torch.stack([pts[:, 1], pts[:, 0], q[:, 1], q[:, 0],
                        valid.to(torch.float32)], 1).contiguous()
    out = klt_v1(i0.contiguous(), i1.contiguous(), meta, num_iters=num_iters,
                 eps=eps, min_eig_threshold=min_eig_threshold,
                 max_residual=max_residual)
    ok = (out[:, 2] > 0.5) & valid
    return out[:, 0:2], ok, out[:, 3]
