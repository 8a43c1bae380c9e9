"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither jax nor the JAX package, so on a machine with a card and
no jax it runs alone:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Tolerances: kernel and plain version compute the same float32 function
(the kernels are built with -fmad=false, so every product and sum is rounded
as the plain version rounds it); only the order of the window sums differs.
Positions of features both accept agree to 1e-3 px, and at least 99% of ok
flags agree (the rest sit within rounding of a gate threshold).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kernel_ab
from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as tv1
from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as tk2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def smooth_image(gen, H, W, passes=2):
    img = torch.rand((1, 1, H, W), generator=gen) * 255.0
    k = torch.ones(1, 1, 5, 5) / 25.0
    for _ in range(passes):
        img = F.conv2d(F.pad(img, (2, 2, 2, 2), mode="replicate"), k)
    return img[0, 0].contiguous()


@pytest.mark.parametrize("win,iters,H,W", [(15, 6, 376, 1241),
                                           (15, 6, 94, 310), (7, 4, 96, 160)])
def test_kernel_matches_twin(cuda, win, iters, H, W):
    gen = torch.Generator().manual_seed(win * 100 + iters)
    tmpl = smooth_image(gen, H, W)
    srch = torch.roll(tmpl, shifts=(1, -2), dims=(0, 1)).contiguous()
    N = 1024
    pts = torch.stack([torch.rand(N, generator=gen) * (W + 16) - 8,
                       torch.rand(N, generator=gen) * (H + 16) - 8], 1)
    q = pts + torch.tensor([-2.0, 1.0]) + torch.randn(N, 2, generator=gen)
    po, pp = tk2._origin_and_phase(pts, win)
    qo, qp = tk2._origin_and_phase(q, win)
    feat = torch.cat([po, pp, qo, qp], 1).contiguous()
    valid = torch.rand(N, generator=gen) < 0.9
    kw = dict(win=win, num_iters=iters, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    args = [t.to(cuda) for t in (tmpl, srch, feat, valid)]
    before = tk2.klt_lk.launches
    out_k = tk2.klt_lk(*args, **kw)
    torch.cuda.synchronize()
    assert tk2.klt_lk.launches == before + 1
    out_p = tk2.klt_lk_plain(*args, **kw)
    ok_k, ok_p = out_k[:, 2] > 0.5, out_p[:, 2] > 0.5
    both = ok_k & ok_p
    assert both.sum() > 100
    assert (ok_k == ok_p).float().mean() >= 0.99
    err = (out_k[both, :2] - out_p[both, :2]).abs().max()
    assert err < 1e-3, float(err)
    # The CPU twin agrees with the card's twin to the same tolerance.
    out_c = tk2.klt_lk(tmpl, srch, feat, valid, **kw)
    both_c = both.cpu() & (out_c[:, 2] > 0.5)
    assert (out_c[both_c, :2] - out_p.cpu()[both_c, :2]).abs().max() < 1e-3


def shifted_pair(gen, H, W, dy, dx, passes=2):
    """A smooth plane and the same plane moved by (dy, dx) whole pixels."""
    tmpl = smooth_image(gen, H, W, passes)
    return tmpl, torch.roll(tmpl, shifts=(dy, dx), dims=(0, 1)).contiguous()


def conditioned(out_p, win):
    """Features whose structure tensor passes the min-eig gate: there the
    Gauss-Newton map is well conditioned, so the kernel's and the plain
    version's sum orders cannot drift apart."""
    return out_p[:, 4] / (win * win) > 1e-4


@pytest.mark.parametrize("win", [5, 7, 15])
@pytest.mark.parametrize("g0", [-9.5, -8.0, -7.25, 6.5, 7.0, 7.75, 8.6])
@pytest.mark.parametrize("iters", [0, 6])
def test_lk_offsets_at_the_clip_limits(cuda, win, g0, iters):
    """Initial offsets g0 at, inside and beyond the clipped range n in
    [-8, 7] (beyond it the blend extrapolates).  With 0 iterations the
    residual is read at g0 itself, in the staged block's first or last rows
    and columns; with 6 the search heads for the true offset in
    [floor(g0), floor(g0) + 1), and reaches it where that lies inside the
    clip (beyond it the extrapolated blend does not model the shift)."""
    gen = torch.Generator().manual_seed(int(win * 100 + g0 * 4 + iters + 50))
    H, W = 120, 200
    tmpl, srch = shifted_pair(gen, H, W, 9, -9)
    N = 256
    pts = torch.stack([torch.rand(N, generator=gen) * (W - 60) + 30,
                       torch.rand(N, generator=gen) * (H - 60) + 30], 1)
    po, pp = tk2._origin_and_phase(pts, win)
    qo, qp = tk2._origin_and_phase(pts + torch.tensor([-9.0, 9.0]), win)
    # The search origin moved by -floor(g0): the true offset is
    # qp + floor(g0); every search starts at g0.
    qo = qo - float(np.floor(g0))
    feat = torch.cat([po, pp, qo, torch.full((N, 2), g0)], 1).contiguous()
    valid = torch.ones(N, dtype=torch.bool)
    kw = dict(win=win, num_iters=iters, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    args = [t.to(cuda) for t in (tmpl, srch, feat, valid)]
    out_k = tk2.klt_lk(*args, **kw)
    torch.cuda.synchronize()
    out_p = tk2.klt_lk_plain(*args, **kw)
    ok_k, ok_p = out_k[:, 2] > 0.5, out_p[:, 2] > 0.5
    assert (ok_k == ok_p).float().mean() >= 0.99
    cond = conditioned(out_p, win)
    assert cond.sum() > 0.5 * N
    err = (out_k[cond, :2] - out_p[cond, :2]).abs().max()
    assert err < 1e-3, float(err)
    if iters == 0:
        assert torch.equal(out_k[:, :2], out_p[:, :2])
        assert torch.allclose(out_k[:, 3], out_p[:, 3], rtol=1e-4, atol=1e-4)
    elif -8 <= np.floor(g0) <= 7:  # converged: the true offsets
        true_g = qp.to(cuda) + float(np.floor(g0))
        assert ((out_p[cond, :2] - true_g[cond]).abs().amax(1) < 0.05
                ).float().mean() > 0.9


@pytest.mark.parametrize("win", [5, 7, 15])
@pytest.mark.parametrize("iters", [0, 6])
def test_lk_windows_at_every_border_and_corner(cuda, win, iters):
    """Template and search windows that touch or cross each border and
    corner of the plane: every staged pixel outside the image is the
    clamped edge pixel, as the plain version reads it."""
    gen = torch.Generator().manual_seed(win * 10 + iters)
    H, W = 94, 310
    tmpl, srch = shifted_pair(gen, H, W, 1, -2)
    xs = torch.tensor([-8.0, -3.3, 0.0, 2.6, W / 2, W - 3.4, W - 1.0, W + 8])
    ys = torch.tensor([-8.0, -2.7, 0.0, 3.1, H / 2, H - 2.2, H - 1.0, H + 8])
    pts = torch.cartesian_prod(xs, ys)  # (64, 2) [x, y]
    pts = torch.cat([pts, pts + torch.rand(pts.shape, generator=gen)], 0)
    q = pts + torch.tensor([-2.0, 1.0]) + torch.randn(pts.shape, generator=gen)
    po, pp = tk2._origin_and_phase(pts, win)
    qo, qp = tk2._origin_and_phase(q, win)
    feat = torch.cat([po, pp, qo, qp], 1).contiguous()
    valid = torch.ones(pts.shape[0], dtype=torch.bool)
    kw = dict(win=win, num_iters=iters, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    args = [t.to(cuda) for t in (tmpl, srch, feat, valid)]
    out_k = tk2.klt_lk(*args, **kw)
    torch.cuda.synchronize()
    out_p = tk2.klt_lk_plain(*args, **kw)
    ok_k, ok_p = out_k[:, 2] > 0.5, out_p[:, 2] > 0.5
    assert (ok_k == ok_p).float().mean() >= 0.99
    both = ok_k & ok_p
    assert both.sum() >= 8
    err = (out_k[both, :2] - out_p[both, :2]).abs().max()
    assert err < 1e-3, float(err)
    if iters == 0:  # the same windows: only the sums' order differs
        assert torch.allclose(out_k[:, 3], out_p[:, 3], rtol=1e-4, atol=1e-4)


def v1_meta(p, q, valid):
    return torch.stack([p[:, 1], p[:, 0], q[:, 1], q[:, 0], valid],
                       1).contiguous()


def test_v1_iterations_that_leave_the_staged_box(cuda):
    """Predictions 9-14 px from the true position on a smoother plane pair:
    the search moves more than the 8 px staged around its first window, so
    later iterations stage a box of their own.  The plain version's offsets
    show that they do."""
    gen = torch.Generator().manual_seed(21)
    H, W = 376, 1241
    tmpl, srch = shifted_pair(gen, H, W, 2, -3, passes=8)
    N = 1024
    pts = torch.stack([torch.rand(N, generator=gen) * (W - 120) + 60,
                       torch.rand(N, generator=gen) * (H - 120) + 60], 1)
    mag = 9.0 + 5.0 * torch.rand(N, 1, generator=gen)
    ang = 2 * np.pi * torch.rand(N, 1, generator=gen)
    miss = mag * torch.cat([torch.cos(ang), torch.sin(ang)], 1)
    q = pts + torch.tensor([-3.0, 2.0]) + miss
    meta = v1_meta(pts, q, torch.ones(N))
    kw = dict(num_iters=10, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    args = [t.to(cuda) for t in (tmpl, srch, meta)]
    out_k = tv1.klt_v1(*args, **kw)
    torch.cuda.synchronize()
    out_p = tv1.klt_v1_plain(*args, **kw)
    moved = (out_p[:, :2] - args[2][:, [3, 2]]).abs().amax(1)
    assert (moved > 9.0).sum() > 50  # windows that left the staged box
    assert_kernel_agrees(out_k, out_p, 50)


def wave_plane(H, W, period, dy=0.0, dx=0.0):
    """A smooth, everywhere well-textured plane of waves ``period`` px
    long, moved by (dy, dx) px."""
    y = torch.arange(H, dtype=torch.float64)[:, None] - dy
    x = torch.arange(W, dtype=torch.float64)[None, :] - dx
    k = 2 * np.pi / period
    img = (128 + 50 * torch.cos(k * x) + 50 * torch.cos(k * y)
           + 20 * torch.sin(2.3 * k * (0.7 * x + 0.4 * y)))
    return img.float().contiguous()


@pytest.mark.parametrize("period,dy,dx", [(200, 12, 40), (240, 14, -48)])
def test_v1_searches_that_leave_the_wide_box(cuda, period, dy, dx):
    """Searches that start 40-50 px from the true position, to the right
    or to the left, on waves long enough for Gauss-Newton to get there in
    steps of tens of pixels: the windows leave the first box, and then the
    wide box staged ahead of them (the plain version's offsets show that
    they do), and most features arrive.  Positions are compared where no
    window origin was clipped to the slab: a clipped window is blended at
    the unclipped phase, so there the result jumps with the offset and any
    difference in the sums' order can grow without bound.  eps = 0: no
    feature freezes, so no freeze decision can fall on the other side of
    the threshold between the two orders."""
    gen = torch.Generator().manual_seed(period + dx)
    H, W = 376, 1241
    tmpl = wave_plane(H, W, period)
    srch = wave_plane(H, W, period, dy, dx)
    N = 512
    pts = torch.stack([torch.rand(N, generator=gen) * (W - 200) + 100,
                       torch.rand(N, generator=gen) * (H - 120) + 60], 1)
    meta = v1_meta(pts, pts, torch.ones(N))
    kw = dict(eps=0.0, min_eig_threshold=1e-4, max_residual=20.0)
    args = [t.to(cuda) for t in (tmpl, srch, meta)]
    out_k = tv1.klt_v1(*args, num_iters=10, **kw)
    torch.cuda.synchronize()

    offsets = [tv1.klt_v1_plain(*args, num_iters=k, **kw)[:, :2]
               - args[2][:, [3, 2]] for k in range(11)]
    left, clipped = kernel_ab.search_boxes(args[2], offsets, H, W)
    assert ((left >= 2) & ~clipped).sum() > 40  # left the wide box too
    out_p = tv1.klt_v1_plain(*args, num_iters=10, **kw)
    arrived = ((out_p[:, :2] - args[2][:, [3, 2]]
                - torch.tensor([dx, dy], device=cuda)).abs().amax(1) < 0.5)
    assert arrived.sum() > 0.5 * N
    ok_k, ok_p = out_k[:, 2] > 0.5, out_p[:, 2] > 0.5
    assert (ok_k == ok_p).float().mean() >= 0.99
    both = ok_k & ok_p & ~clipped
    assert both.sum() > 80
    err = (out_k[both, :2] - out_p[both, :2]).abs().max()
    assert err < 1e-3, float(err)


@pytest.mark.parametrize("side", ["above_left", "below_right"])
def test_v1_predictions_at_the_slab_clip(cuda, side):
    """Predictions 20-40 px above-left or below-right of the template: the
    slab base follows the smaller of the two, so the template's or the
    search window's origin is clipped to the slab and blended at its
    unclipped phase; the NaN slot as in ``test_v1_kernel_matches_plain``."""
    gen = torch.Generator().manual_seed(33 if side == "above_left" else 34)
    H, W = 376, 1241
    tmpl, srch = shifted_pair(gen, H, W, 1, -2)
    N = 512
    pts = torch.stack([torch.rand(N, generator=gen) * (W - 100) + 50,
                       torch.rand(N, generator=gen) * (H - 100) + 50], 1)
    sign = -1.0 if side == "above_left" else 1.0
    q = pts + sign * (20.0 + 20.0 * torch.rand(N, 2, generator=gen))
    meta = v1_meta(pts, q, torch.ones(N))
    meta[5] = float("nan")  # an invalid slot holding garbage
    meta[5, 4] = 0.0
    y0, x0, yi, xi = tv1.slab_geometry(meta, H, W)
    syi = tv1._floor_int((meta[:, 2] - tv1.R) - (y0.float() - tv1.SLAB_PAD))
    sxi = tv1._floor_int((meta[:, 3] - tv1.R) - (x0.float() - tv1.SLAB_PAD))
    hi_y, hi_x = tv1.ROWS - tv1.WIN - 2, tv1.LANES - tv1.WIN - 2
    clipped = ((yi == hi_y) | (xi == hi_x) | (syi < 0) | (syi > hi_y)
               | (sxi < 0) | (sxi > hi_x))
    assert clipped.sum() > 100
    kw = dict(num_iters=6, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    args = [t.to(cuda) for t in (tmpl, srch, meta)]
    out_k = tv1.klt_v1(*args, **kw)
    torch.cuda.synchronize()
    out_p = tv1.klt_v1_plain(*args, **kw)
    ok_k, ok_p = out_k[:, 2] > 0.5, out_p[:, 2] > 0.5
    assert (ok_k == ok_p).float().mean() >= 0.99
    assert out_k[5, 2] == 0.0
    fin = torch.isfinite(out_p[:, 0])
    assert torch.equal(fin, torch.isfinite(out_k[:, 0]))
    cond = fin & conditioned(out_p, tv1.WIN)
    assert cond.sum() > 0.5 * N
    err = (out_k[cond, :2] - out_p[cond, :2]).abs().max()
    assert err < 1e-3, float(err)


def test_wrapper_raises_instead_of_falling_back(cuda):
    img = torch.zeros(64, 96, device=cuda)
    feat = torch.zeros(8, tk2.FEAT_COLS, device=cuda)
    valid = torch.ones(8, dtype=torch.bool, device=cuda)
    kw = dict(win=15, num_iters=4, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    with pytest.raises(ValueError):
        tk2.klt_lk(img.t(), img.t(), feat, valid, **kw)  # not contiguous
    with pytest.raises(ValueError):
        tk2.klt_lk(img, img.cpu(), feat, valid, **kw)  # mixed devices


def test_tracker_on_cuda_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    img0 = smooth_image(gen, 192, 320)
    img1 = torch.roll(img0, shifts=(3, 9), dims=(0, 1)).contiguous()
    pts = torch.stack([torch.rand(256, generator=gen) * 280 + 20,
                       torch.rand(256, generator=gen) * 150 + 20], 1)
    valid = torch.ones(256, dtype=torch.bool)

    def pyr(img):
        mid = img.reshape(48, 4, 80, 4).mean((1, 3))
        return (img, mid, mid.reshape(12, 4, 20, 4).mean((1, 3)))

    kw = dict(num_iters=6, mid_iters=0, win=15)
    pc, okc, _ = tk2.track_multilevel(pyr(img0), pyr(img1), pts, valid, **kw)
    pg, okg, _ = tk2.track_multilevel(
        tuple(p.to(cuda) for p in pyr(img0)),
        tuple(p.to(cuda) for p in pyr(img1)), pts.to(cuda), valid.to(cuda),
        **kw)
    both = okc & okg.cpu()
    assert both.sum() > 150 and (okc == okg.cpu()).float().mean() >= 0.99
    assert (pc[both] - pg.cpu()[both]).abs().max() < 1e-3


def assert_kernel_agrees(out_k, out_p, min_both):
    ok_k, ok_p = out_k[:, 2] > 0.5, out_p[:, 2] > 0.5
    both = ok_k & ok_p
    assert both.sum() > min_both
    assert (ok_k == ok_p).float().mean() >= 0.99
    err = (out_k[both, :2] - out_p[both, :2]).abs().max()
    assert err < 1e-3, float(err)


@pytest.mark.parametrize("iters,H,W", [(6, 376, 1241), (6, 94, 310),
                                       (4, 96, 160)])
def test_v1_kernel_matches_plain(cuda, iters, H, W):
    gen = torch.Generator().manual_seed(iters * 1000 + H)
    tmpl = smooth_image(gen, H, W)
    srch = torch.roll(tmpl, shifts=(1, -2), dims=(0, 1)).contiguous()
    N = 1024
    pts = torch.stack([torch.rand(N, generator=gen) * (W + 16) - 8,
                       torch.rand(N, generator=gen) * (H + 16) - 8], 1)
    # Predictions up to ~30 px off, so slab clips and in-slab gates occur.
    q = pts + torch.tensor([-2.0, 1.0]) + 8 * torch.randn(N, 2, generator=gen)
    valid = (torch.rand(N, generator=gen) < 0.9).float()
    meta = torch.stack([pts[:, 1], pts[:, 0], q[:, 1], q[:, 0], valid],
                       1).contiguous()
    meta[5] = float("nan")  # an invalid slot holding garbage
    meta[5, 4] = 0.0
    kw = dict(num_iters=iters, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    args = [t.to(cuda) for t in (tmpl, srch, meta)]
    before = tv1.klt_v1.launches
    out_k = tv1.klt_v1(*args, **kw)
    torch.cuda.synchronize()
    assert tv1.klt_v1.launches == before + 1
    out_p = tv1.klt_v1_plain(*args, **kw)
    assert_kernel_agrees(out_k, out_p, 100)
    assert out_k[5, 2] == 0.0
    # The CPU plain version agrees with the card's to the same tolerance.
    assert_kernel_agrees(tv1.klt_v1(tmpl, srch, meta, **kw), out_p.cpu(), 100)


def test_v1_wrapper_raises_instead_of_falling_back(cuda):
    img = torch.zeros(64, 96, device=cuda)
    meta = torch.zeros(8, tv1.META_COLS, device=cuda)
    kw = dict(num_iters=4, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    with pytest.raises(ValueError):
        tv1.klt_v1(img.t(), img.t(), meta, **kw)  # not contiguous
    with pytest.raises(ValueError):
        tv1.klt_v1(img, img.cpu(), meta, **kw)  # mixed devices
    with pytest.raises(ValueError):
        tv1.klt_v1(img, img, meta[:4], **kw)  # N % 8 != 0


def test_v1_tracker_chain_on_cuda_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(5)
    img0 = smooth_image(gen, 192, 320)
    img1 = torch.roll(img0, shifts=(3, 9), dims=(0, 1)).contiguous()
    pts = torch.stack([torch.rand(256, generator=gen) * 280 + 20,
                       torch.rand(256, generator=gen) * 150 + 20], 1)
    valid = torch.ones(256, dtype=torch.bool)

    def pyr(img):
        mid = img.reshape(48, 4, 80, 4).mean((1, 3))
        return (img, mid, mid.reshape(12, 4, 20, 4).mean((1, 3)))

    kw = dict(num_iters=6, mid_iters=0, track_fn=tv1.track_features_pallas)
    pc, okc, _ = tk2.track_multilevel(pyr(img0), pyr(img1), pts, valid, **kw)
    pg, okg, _ = tk2.track_multilevel(
        tuple(p.to(cuda) for p in pyr(img0)),
        tuple(p.to(cuda) for p in pyr(img1)), pts.to(cuda), valid.to(cuda),
        **kw)
    both = okc & okg.cpu()
    assert both.sum() > 150 and (okc == okg.cpu()).float().mean() >= 0.99
    assert (pc[both] - pg.cpu()[both]).abs().max() < 1e-3
