"""KLT on the main path: the LK kernel, its plain twin, and the tracker chain
(port of ``ops/klt_pallas2.py``).

``klt_lk`` is the kernel wrapper.  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/klt_lk.cu`` (which replaces the TPU kernel
``ops/klt_pallas2.py::_klt2_kernel``) or raises; on a CPU tensor, and only
there, it runs ``klt_lk_plain``, a plain PyTorch version of the same function
batched over features.  ``klt_lk.launches`` counts kernel launches.  It takes
one problem or a batch of B (planes (B, H, W)) in one launch, through the
custom op ``mvo::klt_lk``, whose vmap rule folds a ``torch.func.vmap``'s
batch into the launch's: the batched step (``pipeline/vo.py``) launches the
kernel once for all its sequences, as the TPU kernel gets one more grid
axis under ``jax.vmap``.

``track_features_pallas2`` keeps the JAX wrapper's signature (minus
``interpret``) and semantics: NaN sanitising, the clip to [-8, W+8], the
coarse prior or an explicit ``prior``, ``swap_planes`` for the backward pass
(here a plain swap of the two planes), and the in-image gates.
``track_multilevel`` is the /16 prior -> /4 LK -> full-res LK chain.

Where the reference kernel's 32-row search slab wraps (a search reaching
past the slab's last row reads the row 32 above) and where its 4-feature
sums make a runaway search's neighbours NaN, the port reads the true image
and keeps each feature's sums its own (``csrc/klt_lk.cu`` lists the
kernel's rolls).  ``stress_diag.reference_read_lk`` is a plain version
with the reference's readings; with them the port fails ``chip_smoke.py``'s
hard-realism gate on the card, so it keeps this one (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from ..core.linalg import constant
from . import klt_pallas as v1

WIN = 15  # tracking window (reference main.py:36 winSize)
# The reference runs its kernel on images edge-padded by PAD; window origins
# are floored in those padded coordinates.  The port reads the unpadded
# image with clamped coordinates but does the same float32 arithmetic, so
# origins and phases match the reference bit for bit.
PAD = 32
COARSE_LEVEL = v1.COARSE_LEVEL

FEAT_COLS = 8  # [tx, ty, fx, fy, qx, qy, gx0, gy0]
OUT_COLS = 5  # [gx, gy, ok, resid, min_eig]


def klt_lk_plain(tmpl, srch, feat, valid, *, win, num_iters, eps,
                 min_eig_threshold, max_residual):
    """Plain PyTorch twin of the kernel: same inputs, same output, for one
    problem or a batch on a leading axis ((B, H, W) planes, (B, N, 8)
    features -> (B, N, 5)); each problem of a batch rounds as it does
    alone."""
    tx, ty, phx, phy, qx, qy, gx, gy = feat.unbind(-1)
    # Template on a (win+2)^2 grid: the window plus the one-pixel ring the
    # central differences need.
    Tb = v1.sample_patches(tmpl, ty - 1, tx - 1, phy, phx, win + 2)
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

    def sample_window(gy, gx):
        ny = torch.floor(gy).clamp(-8.0, 7.0)
        nx = torch.floor(gx).clamp(-8.0, 7.0)
        return v1.sample_patches(srch, qy + ny, qx + nx, gy - ny, gx - nx, win)

    frozen = torch.zeros_like(valid)
    for _ in range(num_iters):
        diff = sample_window(gy, gx) - WT
        b0 = (diff * Ix).sum((-2, -1))
        b1 = (diff * Iy).sum((-2, -1))
        d0 = -(gyy * b0 - gxy * b1) * inv_det
        d1 = -(-gxy * b0 + gxx * b1) * inv_det
        gx = torch.where(frozen, gx, gx + d0)
        gy = torch.where(frozen, gy, gy + d1)
        frozen = frozen | ((d0 * d0 + d1 * d1) < eps * eps)

    resid = (sample_window(gy, gx) - WT).abs().sum((-2, -1)) / (win * win)
    drift_ok = (gx > -7.99) & (gx < 7.99) & (gy > -7.99) & (gy < 7.99)
    eig_ok = (min_eig / (win * win)) > min_eig_threshold
    ok = drift_ok & eig_ok & (resid < max_residual) & valid
    return torch.stack([gx, gy, ok.to(torch.float32), resid, min_eig], -1)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# klt_lk_launch(tmpl, srch, B, H, W, feat, valid, n, win, num_iters, eps2,
#               min_eig_thr, max_resid, out, stream)
LAUNCH_ARGTYPES = (_P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _F, _F, _F, _P,
                   _P)


def _entry():
    return _build.entry("klt_lk", LAUNCH_ARGTYPES)


@torch.library.custom_op("mvo::klt_lk", mutates_args=())
def _klt_lk_op(tmpl: torch.Tensor, srch: torch.Tensor, feat: torch.Tensor,
               valid: torch.Tensor, win: int, num_iters: int, eps: float,
               min_eig_threshold: float,
               max_residual: float) -> torch.Tensor:
    """(B, H, W) planes, (B, N, 8) features, (B, N) flags -> (B, N, 5): one
    launch of the kernel on CUDA tensors, the plain version on CPU ones."""
    if tmpl.device.type == "cpu":
        return klt_lk_plain(tmpl, srch, feat, valid, win=win,
                            num_iters=num_iters, eps=eps,
                            min_eig_threshold=min_eig_threshold,
                            max_residual=max_residual)
    if tmpl.device.type != "cuda":
        raise ValueError(f"klt_lk runs on CUDA or CPU tensors; got {tmpl.device}")
    for name, t in (("tmpl", tmpl), ("srch", srch), ("feat", feat),
                    ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, W = tmpl.shape
    N = feat.shape[1]
    out = torch.empty((B, N, OUT_COLS), dtype=torch.float32,
                      device=tmpl.device)
    with torch.cuda.device(tmpl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(tmpl.data_ptr(), srch.data_ptr(), B, H, W,
                       feat.data_ptr(), valid.data_ptr(), N, win, num_iters,
                       eps * eps, min_eig_threshold, max_residual,
                       out.data_ptr(), stream)
    klt_lk.launches += 1
    if err != 0:
        raise RuntimeError(f"klt_lk kernel launch failed: CUDA error {err}")
    return out


@_klt_lk_op.register_fake
def _(tmpl, srch, feat, valid, *scalars):
    return feat.new_empty(feat.shape[:-1] + (OUT_COLS,))


@_klt_lk_op.register_vmap
def _(info, in_dims, tmpl, srch, feat, valid, *scalars):
    return v1.fold_vmap(_klt_lk_op, info, in_dims, (tmpl, srch, feat, valid),
                        scalars)


def klt_lk(tmpl: torch.Tensor, srch: torch.Tensor, feat: torch.Tensor,
           valid: torch.Tensor, *, win: int, num_iters: int, eps: float,
           min_eig_threshold: float, max_residual: float) -> torch.Tensor:
    """LK for N features: template plane ``tmpl``, search plane ``srch``;
    or for a batch of B such problems in one launch.

    Args:
      tmpl, srch: (H, W) float32 planes on one device, or (B, H, W).
      feat: (N, 8) float32 [tx, ty, fx, fy, qx, qy, gx0, gy0] - integer
        template origin (window top-left) and phase, integer search origin
        and initial offset; (B, N, 8) for a batch.
      valid: (N,) bool, or (B, N).

    Returns (N, 5) float32 [gx, gy, ok, resid, min_eig], or (B, N, 5).
    Under ``torch.func.vmap`` the vmap's batch joins the launch's."""
    if tmpl.dim() not in (2, 3) or srch.shape != tmpl.shape:
        raise ValueError(f"planes must be (H, W) or (B, H, W) of one shape; "
                         f"got {tuple(tmpl.shape)} and {tuple(srch.shape)}")
    lead = tuple(tmpl.shape[:-2])
    N = feat.shape[-2] if feat.dim() == len(lead) + 2 else -1
    if feat.shape != lead + (N, FEAT_COLS) or valid.shape != lead + (N,):
        raise ValueError(f"feat must be {lead + ('N', FEAT_COLS)} and valid "
                         f"{lead + ('N',)}; got {tuple(feat.shape)} and "
                         f"{tuple(valid.shape)}")
    for name, t, dt in (("tmpl", tmpl, torch.float32),
                        ("srch", srch, torch.float32),
                        ("feat", feat, torch.float32),
                        ("valid", valid, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}; got {t.dtype}")
        if t.device != tmpl.device:
            raise ValueError(f"{name} is on {t.device}, tmpl on {tmpl.device}")
    if tmpl.device.type not in ("cpu", "cuda"):
        raise ValueError(f"klt_lk runs on CUDA or CPU tensors; got {tmpl.device}")
    if win % 2 == 0 or not 5 <= win <= 15:
        raise ValueError(f"win must be odd and in [5, 15]; got {win}")
    if not 0 <= num_iters <= 8:
        raise ValueError(f"num_iters must be in [0, 8]; got {num_iters}")
    # Contiguity is checked where the kernel launches (a copy here would
    # hide a caller's layout); under vmap the op's rule lays the batch out.
    args = [t if lead else t[None] for t in (tmpl, srch, feat, valid)]
    out = _klt_lk_op(*args, win, num_iters, eps, min_eig_threshold,
                     max_residual)
    return out if lead else out[0]


klt_lk.launches = 0


def _origin_and_phase(pts_xy: torch.Tensor, win: int):
    """Window top-left of a (N, 2) [x, y] position: the integer origin and
    the sub-pixel phase, computed in padded coordinates as the reference
    does (``_prep_plane``)."""
    t = pts_xy - (win - 1) / 2.0 + PAD
    tf = torch.floor(t)
    return tf - PAD, t - tf


def track_features_pallas2(
    prev_pyr: Tuple[torch.Tensor, ...],
    next_pyr: Tuple[torch.Tensor, ...],
    pts: torch.Tensor,  # (N, 2) [x, y] positions in the template frame
    valid: torch.Tensor,  # (N,) bool
    *,
    num_iters: int = 8,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
    max_residual: float = 20.0,
    prior: torch.Tensor = None,
    swap_planes: bool = False,
    win: int = WIN,
):
    """Track ``pts`` from ``prev_pyr`` to ``next_pyr`` (full-res planes).

    ``prior``: optional (N, 2) flow prior in px; without it the /16 SSD
    coarse volume supplies one.  ``swap_planes``: track next -> prev (the
    forward-backward check's backward pass).  ``win``: odd, 5..15.

    Returns (new_pts (N, 2), ok (N,), resid (N,))."""
    if win % 2 == 0 or not 5 <= win <= 15:
        raise ValueError(
            f"klt_pallas2 window must be odd and in [5, 15]; got {win}. "
            "Use the 'xla' backend for larger windows.")
    H, W = prev_pyr[0].shape
    # Kept on the device, not copied from the host: the step is captured.
    lim = constant([W + 8.0, H + 8.0], pts.device)

    def sanitize(x):
        x = torch.nan_to_num(x, nan=64.0, posinf=64.0, neginf=64.0)
        return torch.minimum(torch.clamp(x, min=-8.0), lim)

    # Invalid slots may hold garbage or NaN positions.
    pts_s = sanitize(pts)
    tmpl_pyr, srch_pyr = ((next_pyr, prev_pyr) if swap_planes
                          else (prev_pyr, next_pyr))
    if prior is None:
        coarse_t = tmpl_pyr[min(COARSE_LEVEL, len(tmpl_pyr) - 1)]
        coarse_s = srch_pyr[min(COARSE_LEVEL, len(srch_pyr) - 1)]
        scale = float(round(H / coarse_t.shape[0]))
        flow_c = v1.coarse_flow_volume(coarse_t, coarse_s)
        pred = v1.sample_map_onehot(flow_c, pts_s / scale) * scale
    else:
        pred = torch.nan_to_num(prior, nan=0.0, posinf=0.0, neginf=0.0)
    q = sanitize(pts_s + pred)

    p_org, p_ph = _origin_and_phase(pts_s, win)
    q_org, q_ph = _origin_and_phase(q, win)
    feat = torch.cat([p_org, p_ph, q_org, q_ph], 1).contiguous()
    out = klt_lk(tmpl_pyr[0].contiguous(), srch_pyr[0].contiguous(), feat,
                 valid.contiguous(), win=win, num_iters=num_iters, eps=eps,
                 min_eig_threshold=min_eig_threshold,
                 max_residual=max_residual)

    # Tracked position = search origin + g + window half-span, in the
    # reference's padded-coordinate arithmetic.
    new_pts = (q_org + PAD) + out[:, 0:2] + (win - 1) / 2.0 - PAD
    new_x, new_y = new_pts[:, 0], new_pts[:, 1]
    rwin = (win - 1) // 2
    inb = ((new_x >= rwin) & (new_x <= W - 1 - rwin)
           & (new_y >= rwin) & (new_y <= H - 1 - rwin))
    # The template gate reads the UNCLIPPED positions.
    tin = ((pts[:, 0] >= rwin) & (pts[:, 0] <= W - 1 - rwin)
           & (pts[:, 1] >= rwin) & (pts[:, 1] <= H - 1 - rwin))
    ok = (out[:, 2] > 0.5) & inb & tin & valid
    return new_pts, ok, out[:, 3]


def track_multilevel(
    prev_pyr: Tuple[torch.Tensor, ...],
    next_pyr: Tuple[torch.Tensor, ...],
    pts: torch.Tensor,
    valid: torch.Tensor,
    *,
    track_fn=None,
    num_iters: int = 8,
    mid_iters: int = 0,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
    max_residual: float = 20.0,
    win: int = WIN,
):
    """Coarse-to-fine tracking: /16 cost-volume prior -> LK on the /mid
    plane -> LK at full resolution.  ``prev_pyr``/``next_pyr`` carry
    (full, mid, coarse) planes (``ops/image.build_flat_pyramid``).
    ``track_fn`` is the single-level tracker, :func:`track_features_pallas2`
    by default or ``klt_pallas.track_features_pallas``.

    ``mid_iters`` = 0 means the mid pass runs ``num_iters`` iterations, as
    the reference's code does (``klt_pallas2.py:509``); no value turns the
    mid pass off (``KLTConfig.mid_iters``)."""
    full_p, mid_p = prev_pyr[0], prev_pyr[1]
    H, _ = full_p.shape
    mid_scale = float(round(H / mid_p.shape[0]))
    coarse_p, coarse_n = prev_pyr[-1], next_pyr[-1]
    c_scale = float(round(H / coarse_p.shape[0]))

    pts_safe = torch.nan_to_num(pts, nan=0.0, posinf=0.0, neginf=0.0)
    flow_c = v1.coarse_flow_volume(coarse_p, coarse_n)
    pred = v1.sample_map_onehot(flow_c, pts_safe / c_scale) * c_scale

    if track_fn is None:
        track_fn = track_features_pallas2
    kw = dict(eps=eps, min_eig_threshold=min_eig_threshold,
              max_residual=max_residual, win=win)
    p_mid, ok_mid, _ = track_fn(
        (mid_p,), (next_pyr[1],), pts_safe / mid_scale, valid,
        prior=pred / mid_scale, num_iters=mid_iters or num_iters, **kw)
    flow_mid = (p_mid - pts_safe / mid_scale) * mid_scale
    prior_full = torch.where(ok_mid[:, None], flow_mid, pred)
    return track_fn(prev_pyr, next_pyr, pts, valid, prior=prior_full,
                    num_iters=num_iters, **kw)
