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
import bisect
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
import kernel_ab
from monocular_visual_odometry_va4mr_torch.ops import image as timops
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


def test_lk_runaway_searches(cuda):
    """Searches that run away and overflow (every 4th feature, on a part
    of the template plane that is flat but for tiny noise, against a
    textured search plane): kernel and plain version give NaN in the same
    places, and the other features alike.  (The reference would fail the
    3 others of each runaway's group too; the port keeps each feature's
    sums its own, ROADMAP.md Queue 3.)"""
    gen = torch.Generator().manual_seed(5)
    H, W = 120, 160
    tmpl, srch = shifted_pair(gen, H, W, 1, 2)
    tmpl[:, :60] = 100.0 + 0.01 * torch.randn(H, 60, generator=gen)
    N = 256
    pts = torch.stack([torch.rand(N, generator=gen) * 70 + 70,
                       torch.rand(N, generator=gen) * 80 + 20], 1)
    pts[0::4, 0] = torch.rand(N // 4, generator=gen) * 25 + 15
    po, pp = tk2._origin_and_phase(pts, 15)
    qo, qp = tk2._origin_and_phase(pts + torch.tensor([2.0, 1.0]), 15)
    feat = torch.cat([po, pp, qo, qp], 1).contiguous()
    valid = torch.ones(N, dtype=torch.bool)
    kw = dict(win=15, num_iters=8, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    args = [t.to(cuda) for t in (tmpl, srch, feat, valid)]
    out_k = tk2.klt_lk(*args, **kw)
    torch.cuda.synchronize()
    out_p = tk2.klt_lk_plain(*args, **kw)
    assert torch.isnan(out_p[0::4, 0]).sum() > 0.5 * (N // 4)
    assert (out_k[:, 2] == out_p[:, 2]).float().mean() >= 0.99
    for col in (0, 1, 3):
        assert torch.equal(torch.isnan(out_k[:, col]),
                           torch.isnan(out_p[:, col]))
    fin = torch.isfinite(out_p[:, :2]).all(1)
    err = (out_k[fin, :2] - out_p[fin, :2]).abs().max()
    assert err < 1e-3, float(err)


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


def wrap_inputs(gen, H, W, device, N=1024):
    """``chip_smoke.bench_inputs``' tuple on a smooth plane: (template
    pyramid, search pyramid, positions, valid, prior, iterations)."""
    tmpl = smooth_image(gen, H, W).to(device)
    pts = torch.stack([torch.rand(N, generator=gen) * W,
                       torch.rand(N, generator=gen) * H], 1).to(device)
    valid = (torch.rand(N, generator=gen) < 0.9).to(device)
    return (tmpl,), (tmpl,), pts, valid, None, (6, 6, 4)


@pytest.mark.parametrize("name", ["klt_lk", "klt_v1"])
@pytest.mark.parametrize("H,W", [(376, 1241), (600, 800)])
def test_kernel_where_the_reference_slab_wraps(cuda, name, H, W):
    """``chip_smoke.wrap_call``'s input at the main path's and the Malaga
    preset's full resolution: every ``klt_lk`` search starts with rows of
    its window where the reference reads 32 rows up (the port reads the
    true rows), every ``klt_v1`` template has its upward gradient's row 0
    read 24 rows down, as the reference reads it.  Kernel and plain version
    read the same rows."""
    gen = torch.Generator().manual_seed(H + (name == "klt_v1"))
    _, kernel, plain, args, iters, extra, _ = chip_smoke.wrap_call(
        name, wrap_inputs(gen, H, W, cuda))
    before = kernel.launches
    out_k = kernel(*args, num_iters=iters, **extra)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    out_p = plain(*args, num_iters=iters, **extra)
    assert_kernel_agrees(out_k, out_p, 100)


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


@pytest.mark.parametrize("H,W,mid_iters", [(192, 320, 0), (600, 800, 4)])
def test_tracker_on_cuda_matches_cpu(cuda, H, W, mid_iters):
    """The multilevel chain on the card against the CPU: the main path's
    ``mid_iters=0`` and the Malaga preset's 600x800 with ``mid_iters=4``
    (a 150x200 mid plane)."""
    gen = torch.Generator().manual_seed(3)
    img0 = smooth_image(gen, H, W)
    img1 = torch.roll(img0, shifts=(3, 9), dims=(0, 1)).contiguous()
    pts = torch.stack([torch.rand(256, generator=gen) * (W - 40) + 20,
                       torch.rand(256, generator=gen) * (H - 42) + 20], 1)
    valid = torch.ones(256, dtype=torch.bool)

    def pyr(img):  # 4x4 and 16x16 box means, cropped to whole boxes
        return timops.build_flat_pyramid(img, 16, 4)

    kw = dict(num_iters=6, mid_iters=mid_iters, win=15)
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


def textured(gen, H, W):
    img = smooth_image(gen, H, W, passes=1)
    return (img - img.min()) / (img.max() - img.min()) * 255.0


def test_sift_on_cuda_matches_cpu(cuda):
    """``detect_and_compute`` at full width on the card against the same
    call on the CPU: the keypoints pair one to one by position (within
    1e-2 px), positions within 1e-3 px and scales within 1e-4; orientations
    and descriptors within 1e-4 for 99% of the pairs less the share whose
    orientation flipped (the card sums the histogram in its fixed order,
    not the CPU's scatter order, and an argmax between two near-equal bins
    can turn; at most 1%, printed)."""
    from monocular_visual_odometry_va4mr_torch.ops import sift

    img = textured(torch.Generator().manual_seed(11), 376, 1241)
    c = sift.detect_and_compute(img, max_features=512)
    g = sift.detect_and_compute(img.to(cuda), max_features=512)
    assert c.valid.sum() > 400
    assert abs(int(c.valid.sum()) - int(g.valid.sum())) <= 5
    paired, nn, dpos, dori = chip_smoke.pair_keypoints(c, g)
    assert paired.float().mean() >= 0.98
    assert dpos[paired].max() < 1e-3
    cv, gv = c.valid, g.valid.cpu()
    nn = nn[paired]
    assert (c.scale[cv][paired] - g.scale.cpu()[gv][nn]).abs().max() < 1e-4
    flips = (dori[paired] > chip_smoke.FLIP_RAD).float().mean().item()
    desc_err = (c.desc[cv][paired] - g.desc.cpu()[gv][nn]).abs().amax(1)
    print(f"sift cuda vs cpu: {int(paired.sum())} pairs, orientation flips "
          f"{flips:.4f}")
    assert flips <= 0.01
    assert (dori[paired] <= 1e-4).float().mean() >= 0.99 - flips
    assert (desc_err <= 1e-4).float().mean() >= 0.99 - flips


def test_posegraph_on_cuda_matches_cpu(cuda):
    """Both pose graphs on the card against the same solve on the CPU:
    a drifted 20-node circle with 3 loop edges, poses within 1e-4."""
    from monocular_visual_odometry_va4mr_torch.backend import (
        posegraph, posegraph_sim3)
    from monocular_visual_odometry_va4mr_torch.core import lie

    gen = torch.Generator().manual_seed(5)
    n = 20
    ang = torch.arange(n) * (2 * np.pi / n)
    xi = torch.zeros(n, 6)
    xi[:, 4] = ang
    T_WC = lie.se3_exp(xi)
    T_WC[:, 0, 3] = 5 * torch.sin(ang)
    T_WC[:, 2, 3] = 5 * (1 - torch.cos(ang))
    gt = lie.invert_se3(T_WC)
    noise = torch.cat([0.03 * torch.randn(n, 3, generator=gen),
                       0.01 * torch.randn(n, 3, generator=gen)], 1)
    drifted = [gt[0]]
    for k in range(1, n):
        rel = gt[k] @ lie.invert_se3(gt[k - 1])
        drifted.append(lie.se3_exp(noise[k]) @ rel @ drifted[-1])
    nodes = torch.stack(drifted)
    loops = [(19, 0), (15, 2), (12, 5)]

    def solve(dev):
        g3 = posegraph_sim3.from_se3_chain(nodes.to(dev))
        g = posegraph.odometry_edges(nodes.to(dev))
        for i, j in loops:
            rel = gt[j] @ lie.invert_se3(gt[i])
            g3 = posegraph_sim3.add_loop_edge(g3, i, j, rel[:3, :3],
                                              rel[:3, 3], 1.0, weight=3.0)
            g = posegraph.add_edge(g, i, j, rel, weight=3.0)
        o3, c3 = posegraph_sim3.optimize(g3, iters=15, damping=1e-4)
        o, c = posegraph.optimize(g, iters=15, damping=1e-5,
                                  robust_delta=0.5)
        return (o3.S_CW.cpu(), o.T_CW.cpu()), (c3.cpu(), c.cpu())

    (poses_c, costs_c), (poses_g, costs_g) = solve("cpu"), solve(cuda)
    for a, b in zip(poses_c, poses_g):
        assert torch.all(torch.isfinite(b))
        assert (a - b).abs().max() < 1e-4
    for a, b in zip(costs_c, costs_g):
        assert b[-1] < 0.5 * b[0]
        assert ((a - b).abs() <= 1e-4 * a[0]).all()


@pytest.fixture
def nccl_group(cuda, tmp_path):
    """A one-rank NCCL process group (file store under ``tmp_path``)."""
    import torch.distributed as dist

    from monocular_visual_odometry_va4mr_torch.parallel import multihost

    multihost.initialize(f"file://{tmp_path}/store", 1, 0)
    assert dist.get_backend() == "nccl"
    yield
    dist.destroy_process_group()


def nccl_window(cuda):
    from monocular_visual_odometry_va4mr_torch.backend import ba
    from monocular_visual_odometry_va4mr_torch.parallel import traj_ba

    noisy, _, cam = traj_ba.build_synthetic_traj(1, 6, 256, seed=0)
    noisy = traj_ba.TrajSegments(*(t.to(cuda) for t in noisy))
    win = ba.BAWindow(torch.cat([noisy.anchor_T_CW, noisy.T_CW]),
                      noisy.lm_xyz, noisy.obs_uv[0], noisy.obs_mask[0])
    return noisy, win, cam


def test_ba_sharded_on_nccl_equals_run_ba(cuda, nccl_group):
    from monocular_visual_odometry_va4mr_torch.backend import ba
    from monocular_visual_odometry_va4mr_torch.parallel import (ba_sharded,
                                                                multihost)

    _, win, cam = nccl_window(cuda)
    multihost.COMM.clear()
    out, costs = ba_sharded.run_ba_sharded(ba_sharded.shard_window(win, 0, 1),
                                           cam, iters=5)
    W = win.T_CW.shape[0]
    assert multihost.COMM == {("all_reduce", 4 * (36 * W * W + 6 * W + 1)): 5}
    ref, ref_costs = ba.run_ba(win, cam, iters=5)
    assert out.T_CW.is_cuda
    assert (out.T_CW - ref.T_CW).abs().max() <= 1e-5
    assert (out.lm_xyz - ref.lm_xyz).abs().max() <= 1e-4
    torch.testing.assert_close(costs, ref_costs, rtol=1e-3, atol=0)


def test_traj_ba_on_nccl_equals_segment_ba(cuda, nccl_group):
    from monocular_visual_odometry_va4mr_torch.backend import ba
    from monocular_visual_odometry_va4mr_torch.parallel import (multihost,
                                                                traj_ba)

    noisy, win, cam = nccl_window(cuda)
    multihost.COMM.clear()
    seg, _ = traj_ba.run_traj_ba(traj_ba.shard_segments(noisy, 0, 1), cam,
                                 iters=4)
    assert multihost.COMM == {("all_reduce", 4): 4}  # one rank: no halo
    ref, _ = ba.run_ba(win, cam, iters=4, damping=1e-2, n_fixed=2)
    assert (seg.T_CW - ref.T_CW[2:]).abs().max() <= 2e-4


def sharded_calls(cuda):
    """(name, call, iterations, collectives of a call) of both sharded BAs
    on the one-rank group."""
    from monocular_visual_odometry_va4mr_torch.parallel import (ba_sharded,
                                                                traj_ba)

    noisy, win, cam = nccl_window(cuda)
    W = win.T_CW.shape[0]
    return (
        ("ba_sharded", lambda: ba_sharded.run_ba_sharded(
            ba_sharded.shard_window(win, 0, 1), cam, iters=5), 5,
         {("all_reduce", 4 * (36 * W * W + 6 * W + 1)): 5}),
        ("traj_ba", lambda: traj_ba.run_traj_ba(
            traj_ba.shard_segments(noisy, 0, 1), cam, iters=4), 4,
         {("all_reduce", 4): 4}))


@pytest.mark.parametrize("which", [0, 1], ids=["ba_sharded", "traj_ba"])
def test_sharded_ba_replays_bit_equal_to_op_by_op(cuda, nccl_group, which):
    """Each sharded BA replays one graph of its GN iteration, its
    all-reduce inside, ``iters`` times a call (``core.graphs.scan``):
    poses, landmarks and costs bit for bit the same call op by op
    (``graphs.eager()``).  A second call of the key captures nothing, and
    each call counts the collectives of a call op by op (the capture's
    are added at each replay, the warm-up's and the capture's are not)."""
    from monocular_visual_odometry_va4mr_torch.core import graphs
    from monocular_visual_odometry_va4mr_torch.parallel import multihost

    _, call, iters, comm = sharded_calls(cuda)[which]
    captured = graphs.captures(cuda)[0]
    outs = []
    for _ in range(2):
        replays = graphs.replays(cuda)
        multihost.COMM.clear()
        outs.append(call())
        assert multihost.COMM == comm
        assert graphs.replays(cuda) == replays + iters
        assert graphs.captures(cuda)[0] == captured + 1
    multihost.COMM.clear()
    with graphs.eager():
        want = call()
    assert multihost.COMM == comm
    for out in outs:
        (a, costs), (b, want_costs) = out, want
        for x, y in ((a.T_CW, b.T_CW), (a.lm_xyz, b.lm_xyz),
                     (costs, want_costs)):
            assert x.is_cuda and same_bits(x, y), describe(x, y)


# --- the captured step -------------------------------------------------------

GRAPH_FRAMES = 30  # 27 steps: the ring of 3 wraps 9 times, BA every 2


def describe(a, b):
    """Where two tensors of one shape differ: positions, how many of them
    are NaN on both sides, and a few of the values."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return f"{a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}"
    x, y = (a.view(torch.int32), b.view(torch.int32)) if (
        a.dtype == torch.float32) else (a, b)
    ne = (x != y).reshape(-1)
    both_nan = (torch.isnan(a) & torch.isnan(b)).reshape(-1) if (
        a.is_floating_point()) else torch.zeros_like(ne)
    at = ne.nonzero().flatten()[:4].tolist()
    return (f"{int(ne.sum())} differ, {int((ne & both_nan).sum())} NaN on both "
            f"sides, at {at}: {a.reshape(-1)[at].tolist()} vs "
            f"{b.reshape(-1)[at].tolist()}")


def same_bits(a, b):
    """Bit for bit, NaNs included (``torch.equal`` counts a NaN unequal to
    itself, and the tracked positions of invalid slots may be NaN)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def graph_vo(cuda, method="klt", num_frames=GRAPH_FRAMES, ba=(2, 3), **kw):
    """``tests/test_pipeline.py``'s small config on ``pallas2`` with the
    in-step BA every ``ba[0]`` frames over a ring of ``ba[1]`` (2 and 3 by
    default), on the card, and ``num_frames`` frames; ``method``: the
    bootstrap's."""
    from monocular_visual_odometry_va4mr_torch.core import config as tconfig
    from monocular_visual_odometry_va4mr_torch.core.camera import Camera
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    scene = synthetic.make_corridor_scene(seed=3, num_frames=num_frames,
                                          num_points=2500,
                                          image_shape=(240, 320), step=0.4)
    frames = [synthetic.render_frame(scene, i) for i in range(num_frames)]
    cfg = tconfig.PipelineConfig(
        landmarks=tconfig.LandmarkConfig(min_dist=0.5, max_dist=120.0,
                                         min_baseline_angle_deg=1.0,
                                         min_baseline_frames=2),
        detector=tconfig.DetectorConfig(max_corners=512, quality_level=0.05,
                                        min_dist=8.0),
        klt=tconfig.KLTConfig(window=11, max_level=3, num_iters=15, eps=0.01,
                              backend="pallas2"),
        pnp=tconfig.PnPConfig(iterations=200, reproj_err_px=4.0),
        essential=tconfig.EssentialConfig(iterations=300, threshold_px=1.0),
        capacity=tconfig.CapacityConfig(max_landmarks=512,
                                        max_candidates=512),
        ba=tconfig.InStepBAConfig(every=ba[0], window=ba[1],
                                  max_landmarks=64),
        image_shape=(240, 320), bootstrap_method=method)
    make = lambda: VisualOdometry(Camera.from_matrix(scene.K), cfg, cuda,  # noqa: E731
                                  seed=0, **kw)
    return make, frames


def test_graph_step_equals_the_eager_body_bit_for_bit(cuda):
    """The replayed step against ``_step_impl`` op by op, from the same
    bootstrap with the same draws, over 27 steps (the ring wraps, the BA
    runs 13 times): every state tensor equal at every step, and the
    replays add 3 ``klt_lk`` launches each, the capture none of its own."""
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    make, frames = graph_vo(cuda)
    vo_g, vo_e = make(), make()
    gen = lambda i: runner.frame_generator(0, i, cuda)  # noqa: E731
    s_g = vo_g.bootstrap(frames[0], frames[2], intermediate=frames[1:2],
                         generator=gen(0))
    s_e = vo_e.bootstrap(frames[0], frames[2], intermediate=frames[1:2],
                         generator=gen(0))
    per_step, triggers = [], 0
    for i in range(3, GRAPH_FRAMES):
        triggers += vo_e.ba_due(s_e)
        before = tk2.klt_lk.launches, tv1.klt_v1.launches
        s_g = vo_g.step(s_g, frames[i], generator=gen(i))
        per_step.append((tk2.klt_lk.launches - before[0],
                         tv1.klt_v1.launches - before[1]))
        s_e = chip_smoke.eager_step(vo_e, s_e, frames[i], generator=gen(i))
        # The bootstrap ends at frame 2 with frame_idx 1.
        assert s_g.host_frame == s_e.host_frame == int(s_g.frame_idx) == i - 1
        for k, (a, b) in enumerate(zip(s_g.tensors(), s_e.tensors())):
            assert same_bits(a, b), (i, k, describe(a, b))
    assert per_step == [(3, 0)] * (GRAPH_FRAMES - 3)
    assert vo_g.ba_runs == triggers >= 12
    assert len(vo_g.graphs.graphs) == 2  # float32 frames: skip and BA
    assert vo_g.graphs.replays == GRAPH_FRAMES - 3


def test_graph_step_takes_uint8_frames_and_any_held_state(cuda):
    """A uint8 frame goes through its own buffer and graph, bit for bit as
    the eager body casts it; a state the graph did not return (here one
    from the host) is copied in field by field."""
    from monocular_visual_odometry_va4mr_torch.core.state import FrameState
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    make, frames = graph_vo(cuda)
    vo = make()
    u8 = [np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in frames]
    s = vo.bootstrap(u8[0], u8[2], intermediate=u8[1:2],
                     generator=runner.frame_generator(0, 0, cuda))
    for i in range(3, 8):
        s = vo.step(s, u8[i], generator=runner.frame_generator(0, i, cuda))
    held = FrameState.from_numpy(s.to_numpy(), cuda)
    nxt = vo.step(held, u8[8], generator=runner.frame_generator(0, 8, cuda))
    ref = chip_smoke.eager_step(vo, held, torch.from_numpy(u8[8]).to(cuda),
                                generator=runner.frame_generator(0, 8, cuda))
    for a, b in zip(nxt.tensors(), ref.tensors()):
        assert same_bits(a, b)
    assert {k[0] for k in vo.graphs.graphs} == {torch.uint8}


def test_recovery_reenters_the_graph_as_the_eager_run(cuda):
    """``run_sequence`` through two black frames: the re-bootstrapped state
    enters the graph's buffers, and every record equals the same run
    stepped op by op."""
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    make, frames = graph_vo(cuda)
    frames = [np.zeros_like(f) if i in (8, 9) else f
              for i, f in enumerate(frames[:20])]
    vo_g, vo_e = make(), make()
    vo_e.step = lambda state, image, generator=None: chip_smoke.eager_step(
        vo_e, state, image, generator)
    boots = chip_smoke.CountingBootstrap(vo_g)
    res_g = runner.run_sequence(vo_g, enumerate(frames), bootstrap_stride=2)
    res_e = runner.run_sequence(vo_e, enumerate(frames), bootstrap_stride=2)
    assert boots.recoveries >= 1
    assert [r.status for r in res_g.records] == [r.status
                                                 for r in res_e.records]
    np.testing.assert_array_equal(res_g.positions, res_e.positions)


def test_graph_step_raises_for_a_sampler_without_draw(cuda):
    """No fallback: a sampler that only maps (generator, valid) to a bank
    cannot feed the captured step, and the step raises."""
    from monocular_visual_odometry_va4mr_torch.ops import ransac

    make, frames = graph_vo(cuda, sampler=lambda g, v, n, k:
                            ransac.sample_minimal_sets(g, v, n, k))
    vo = make()
    s = vo.bootstrap(frames[0], frames[2], intermediate=frames[1:2])
    with pytest.raises(TypeError, match="draw"):
        vo.step(s, frames[3])


@pytest.mark.parametrize("name", ["klt_lk", "klt_v1"])
def test_batched_launch_equals_solo_launches(cuda, name):
    """Three problems on a batch axis: one launch, bit for bit the three
    solo launches; ``torch.func.vmap`` of the wrapper is that one launch."""
    gen = torch.Generator().manual_seed(7)
    H, W, N = 376, 1241, 1024
    args = []
    for b in range(3):
        tmpl = smooth_image(gen, H, W)
        srch = torch.roll(tmpl, shifts=(b - 1, 2 - b), dims=(0, 1))
        pts = torch.stack([torch.rand(N, generator=gen) * W,
                           torch.rand(N, generator=gen) * H], 1)
        q = pts + torch.tensor([2.0 - b, b - 1.0]) + torch.randn(
            N, 2, generator=gen)
        valid = torch.rand(N, generator=gen) < 0.9
        if name == "klt_lk":
            po, pp = tk2._origin_and_phase(pts, 15)
            qo, qp = tk2._origin_and_phase(q, 15)
            rest = (torch.cat([po, pp, qo, qp], 1), valid)
        else:
            rest = (torch.stack([pts[:, 1], pts[:, 0], q[:, 1], q[:, 0],
                                 valid.float()], 1),)
        args.append([t.to(cuda) for t in (tmpl, srch.contiguous(), *rest)])
    wrapper = tk2.klt_lk if name == "klt_lk" else tv1.klt_v1
    kw = dict(num_iters=6, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0, **({"win": 15} if name == "klt_lk" else {}))
    batch = [torch.stack(ts) for ts in zip(*args)]
    before = wrapper.launches
    out = wrapper(*batch, **kw)
    assert wrapper.launches == before + 1
    solo = torch.stack([wrapper(*a, **kw) for a in args])
    assert same_bits(out, solo)
    before = wrapper.launches
    mapped = torch.func.vmap(lambda *t: wrapper(*t, **kw))(*batch)
    assert wrapper.launches == before + 1 and same_bits(mapped, solo)
    assert (out[..., 2] > 0.5).float().mean() > 0.5


def test_batched_graph_step_equals_the_eager_batched_body(cuda):
    """Three sequences stepped by ``step_batch`` (one replay a frame)
    against the batched body run op by op with the same draws, over 9
    frames through BA triggers: every state tensor equal, 3 ``klt_lk``
    launches a batched step, one graph per (skip, BA) at batch size 3."""
    from monocular_visual_odometry_va4mr_torch.core.state import (
        stack_states)
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    make, frames = graph_vo(cuda)
    vo_g, vo_e = make(), make()
    gens = lambda i: [runner.frame_generator(s, i, cuda)  # noqa: E731
                      for s in range(3)]
    boots = [vo_g.bootstrap(frames[s], frames[s + 2],
                            intermediate=frames[s + 1:s + 2],
                            generator=runner.frame_generator(s, 0, cuda))
             for s in range(3)]
    b_g = b_e = stack_states(boots)
    for i in range(3, 12):
        images = [frames[s + i] for s in range(3)]
        before = tk2.klt_lk.launches
        b_g = vo_g.step_batch(b_g, images, gens(i))
        assert tk2.klt_lk.launches == before + 3
        run_ba = vo_e.ba_due(b_e)
        draws = torch.stack([vo_e.step_draws(g) for g in gens(i)])
        host = b_e.host_frame
        b_e = vo_e._step_batch_impl(
            b_e, torch.stack([torch.as_tensor(im) for im in images]).to(cuda),
            draws, run_ba)
        b_e.host_frame = host + 1
        for k, (a, b) in enumerate(zip(b_g.tensors(), b_e.tensors())):
            assert same_bits(a, b), (i, k, describe(a, b))
    assert vo_g.ba_runs >= 4
    assert sorted(k[1] for k in vo_g.graphs.graphs) == [False, True]
    assert {k[-1] for k in vo_g.graphs.graphs} == {3}


def test_batched_step_equals_batches_of_one(cuda):
    """Three sequences stepped by ``step_batch`` equal, bit for bit, each
    stepped in a batch of one with the same generators, over 9 frames
    through BA triggers: a sequence does not depend on its batch-mates."""
    from monocular_visual_odometry_va4mr_torch.core.state import (
        stack_states, unstack_states)
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    make, frames = graph_vo(cuda)
    vo = make()
    boots = [vo.bootstrap(frames[s], frames[s + 2],
                          intermediate=frames[s + 1:s + 2],
                          generator=runner.frame_generator(s, 0, cuda))
             for s in range(3)]
    alone = []
    for s, st in enumerate(boots):
        run, one = [], stack_states([st])
        for i in range(3, 12):
            one = vo.step_batch(one, [frames[s + i]],
                                [runner.frame_generator(s, i, cuda)])
            run.append([t.clone() for t in unstack_states(one)[0].tensors()])
        alone.append(run)
    batch = stack_states(boots)
    for k, i in enumerate(range(3, 12)):
        batch = vo.step_batch(
            batch, [frames[s + i] for s in range(3)],
            [runner.frame_generator(s, i, cuda) for s in range(3)])
        for s, one in enumerate(unstack_states(batch)):
            for a, b in zip(one.tensors(), alone[s][k]):
                assert same_bits(a, b), (i, s, describe(a, b))
    assert vo.ba_runs >= 8


def test_solo_step_keeps_its_arithmetic_inside_exact(cuda):
    """A solo step takes the libraries' arithmetic whatever ``linalg.exact``
    its caller is in: a VO whose graphs were captured inside ``exact()``
    steps bit for bit as one captured outside it."""
    from monocular_visual_odometry_va4mr_torch.core import linalg
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    make, frames = graph_vo(cuda)
    runs = []
    for mode in (True, False):
        vo = make()
        st = vo.bootstrap(frames[0], frames[2], intermediate=frames[1:2],
                          generator=runner.frame_generator(0, 0, cuda))
        with linalg.exact(mode):
            for i in range(3, 8):
                st = vo.step(st, frames[i],
                             generator=runner.frame_generator(0, i, cuda))
        runs.append(st)
    for a, b in zip(runs[0].tensors(), runs[1].tensors()):
        assert same_bits(a, b), describe(a, b)


# --- the bootstrap, SIFT and the loop verifier as graphs ---------------------

def test_graph_bootstrap_equals_the_eager_one(cuda):
    """The KLT bootstrap replayed (a graph for the first frame, one a hop,
    the geometry in segments around torch's eigh and svd) against
    ``bootstrap_eager`` with the same generator, twice (capture, then
    replays only): every state tensor bit for bit equal, 3 ``klt_lk``
    launches a hop."""
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    make, frames = graph_vo(cuda)
    vo = make()
    for _ in range(2):
        gen = lambda: runner.frame_generator(0, 0, cuda)  # noqa: E731
        before = tk2.klt_lk.launches
        g = vo.bootstrap(frames[0], frames[3], intermediate=frames[1:3],
                         generator=gen())
        assert tk2.klt_lk.launches == before + 9
        e = vo.bootstrap_eager(frames[0], frames[3],
                               intermediate=frames[1:3], generator=gen())
        assert g.host_frame == e.host_frame == 1
        for k, (a, b) in enumerate(zip(g.tensors(), e.tensors())):
            assert same_bits(a, b), (k, describe(a, b))
    assert int(g.status) == 0 and int(g.lm_valid.sum()) > 20
    graphs = {k[0]: steps for k, (steps, _) in vo.fn_graphs.graphs.items()}
    assert set(graphs) == {("first_frame",), ("hop",), ("geometry",)}
    # 5 graphs with 1 svd and 3 eigh calls between them.
    assert len(graphs[("geometry",)]) == 9


def test_graph_sift_bootstrap_equals_the_eager_one(cuda):
    """The SIFT bootstrap replayed (SIFT of both frames, the ratio match,
    the pyramid, the geometry) against ``bootstrap_eager``: bit for bit."""
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    make, frames = graph_vo(cuda, method="sift")
    vo = make()
    g = vo.bootstrap(frames[0], frames[2],
                     generator=runner.frame_generator(0, 0, cuda))
    e = vo.bootstrap_eager(frames[0], frames[2],
                           generator=runner.frame_generator(0, 0, cuda))
    for k, (a, b) in enumerate(zip(g.tensors(), e.tensors())):
        assert same_bits(a, b), (k, describe(a, b))
    assert int(g.n_tracked) >= 16
    assert {k[0] for k in vo.fn_graphs.graphs} == {
        ("sift", 512), ("match",), ("pyramid",), ("geometry",)}


def test_sift_twice_on_one_image_is_bit_equal(cuda):
    """SIFT sums its histograms and descriptors in a fixed order on the
    card: two calls on one image, and its replays, give the same bits."""
    from monocular_visual_odometry_va4mr_torch.ops import sift

    make, _ = graph_vo(cuda)
    vo = make()
    img = textured(torch.Generator().manual_seed(11), 376, 1241).to(cuda)
    runs = [sift.detect_and_compute(img, max_features=512) for _ in range(2)]
    runs += [vo.sift_features(img, 512) for _ in range(2)]
    assert runs[0].valid.sum() > 400
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert same_bits(a, b), describe(a, b)


def test_graph_verifier_chunk_equals_the_eager_chunk(cuda):
    """A chunk of 8 keyframe pairs through ``verify_chunk_replayed`` (its
    graph in segments) against ``verify_chunk`` op by op on the same
    draws, twice: every output bit for bit equal."""
    from monocular_visual_odometry_va4mr_torch.ops import ransac
    from monocular_visual_odometry_va4mr_torch.pipeline import (
        posegraph_runner as pr)

    make, frames = graph_vo(cuda, method="sift")
    vo = make()
    kfs = []
    for i in (0, 2, 4):
        f = vo.sift_features(frames[i], 512, host=True)
        kfs.append(pr.Keyframe(i, i, np.eye(4), f.uv.numpy(),
                               f.desc.numpy(), f.valid.numpy()))
    pairs = [(0, 1), (1, 2), (0, 2), (1, 0), (2, 1), (2, 0), (0, 1), (1, 2)]
    inputs = pr.chunk_inputs(kfs, pairs, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    draws = torch.stack([ransac.draw_uniforms(gen, 300, 5) for _ in pairs])
    eager = pr.verify_chunk(vo.cam, *inputs, draws,
                            ratio=vo.config.sift.ratio, threshold_px=1.5,
                            select=ransac.select_minimal_sets)
    for _ in range(2):
        replayed = pr.verify_chunk_replayed(vo, vo.cam, inputs, draws,
                                            threshold_px=1.5)
        for k, (a, b) in enumerate(zip(replayed, eager)):
            assert same_bits(a, b.cpu()), (k, describe(a, b.cpu()))
    assert int(eager[-2].min()) >= 16  # matches in every pair


# Capture one linalg call after a warm-up on a side stream, in a process of
# its own (a failed capture can leave the process's CUDA state unusable).
CAPTURE_PROBE = """
import torch
A = torch.randn(8, 3, 3, device="cuda")
A = A @ A.mT
Q = torch.randn(8, 5, 9, device="cuda")
fn = dict(eigh=lambda: torch.linalg.eigh(A),
          svd=lambda: torch.linalg.svd(Q, full_matrices=True),
          det=lambda: torch.linalg.det(A),
          solve_ex=lambda: torch.linalg.solve_ex(A, A[..., 0]))[{name!r}]
side = torch.cuda.Stream()
with torch.cuda.stream(side):
    fn()
torch.cuda.synchronize()
try:
    with torch.cuda.graph(torch.cuda.CUDAGraph(),
                          capture_error_mode="thread_local"):
        fn()
except Exception:
    print("failed", flush=True)
else:
    print("captured", flush=True)
"""


@pytest.mark.parametrize("name,captured", [
    ("eigh", False), ("svd", False), ("det", True), ("solve_ex", True)])
def test_only_the_host_wait_calls_fail_to_capture(cuda, name, captured):
    """torch's ``eigh`` and ``svd`` read their error codes on the host, so
    no capture can hold them (``core/graphs.py``'s ``_HOST_WAITS``, which
    ``GraphCache`` captures around); ``det`` and ``solve_ex`` capture."""
    out = subprocess.run([sys.executable, "-c",
                          CAPTURE_PROBE.format(name=name)],
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split()[:1] == ["captured" if captured else "failed"], \
        out.stderr[-2000:]


def test_segmented_capture_reads_what_the_graph_before_it_computed(cuda):
    """A function captured in segments around ``eigh``: at the capture the
    call reads the values the graph before it computes, not what earlier
    replays left in the shared pool (here NaN, written by another key's
    graph into blocks of the same size): the capture succeeds and its
    replays equal the eager function, bit for bit."""
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import GraphCache

    cache = GraphCache(cuda)
    a = torch.randn(64, 3, 3, generator=torch.Generator().manual_seed(5))
    a = a.to(cuda)

    def nan(x):
        return (sum(torch.full_like(x, float("nan")) * k
                    for k in range(8)),)

    def spd_eigh(x):
        w, v = torch.linalg.eigh(x @ x.mT + torch.eye(3, device=x.device))
        return (w + 1.0, v)

    assert torch.isnan(cache.call("nan", nan, [a])[0]).all()
    want = spd_eigh(a)
    for _ in range(2):
        got = cache.call("eigh", spd_eigh, [a])
        for x, y in zip(got, want):
            assert same_bits(x, y), describe(x, y)
    steps, _ = cache.graphs[("eigh", ((64, 3, 3), torch.float32))]
    assert len(steps) == 3  # a graph, the eigh call, a graph


# --- the back end's graphs ---------------------------------------------------


def posegraph_chain(group, n, device="cpu", seed=5, bogus=False):
    """A drifted circle of ``n`` nodes (Sim(3): drifting in scale too) with
    n // 3 loop edges measured from the truth, and with ``bogus`` one
    confidently wrong edge more, as ``group``'s graph on ``device``."""
    from monocular_visual_odometry_va4mr_torch.backend import (
        posegraph, posegraph_sim3)
    from monocular_visual_odometry_va4mr_torch.core import lie

    gen = torch.Generator().manual_seed(seed)
    ang = torch.arange(n) * (2 * np.pi / n)
    xi = torch.zeros(n, 6)
    xi[:, 4] = ang
    T_WC = lie.se3_exp(xi)
    T_WC[:, 0, 3] = 5 * torch.sin(ang)
    T_WC[:, 2, 3] = 5 * (1 - torch.cos(ang))
    gt = lie.invert_se3(T_WC)
    noise = torch.cat([0.03 * torch.randn(n, 3, generator=gen),
                       0.01 * torch.randn(n, 3, generator=gen)], 1)
    drifted = [gt[0]]
    for k in range(1, n):
        rel = gt[k] @ lie.invert_se3(gt[k - 1])
        if group == "sim3":
            rel[:3, 3] *= 1.004 ** k
        drifted.append(lie.se3_exp(noise[k]) @ rel @ drifted[-1])
    nodes = torch.stack(drifted).to(device)
    loops = [((37 * k) % n, (37 * k + n // 2) % n) for k in range(n // 3)]
    g = (posegraph.odometry_edges(nodes) if group == "se3"
         else posegraph_sim3.from_se3_chain(nodes))
    for i, j in loops:
        rel = gt[j] @ lie.invert_se3(gt[i])
        if group == "se3":
            g = posegraph.add_edge(g, i, j, rel, weight=3.0)
        else:
            g = posegraph_sim3.add_loop_edge(g, i, j, rel[:3, :3],
                                             rel[:3, 3], 1.0, weight=3.0)
    if bogus:
        g = posegraph_sim3.add_loop_edge(g, 3, n // 2, torch.eye(3),
                                         torch.tensor([0.1, 0.0, 0.1]), 2.5,
                                         weight=3.0)
    return g


def solve_kw(group):
    return (dict(iters=15, damping=1e-5, robust_delta=0.5) if group == "se3"
            else dict(iters=15, damping=1e-4, robust_delta=0.5))


@pytest.mark.parametrize("n", [78, 342])
@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_replayed_pose_graph_solve_equals_op_by_op(cuda, group, n):
    """``optimize`` on the card replays one graph of the GN iteration per
    iteration (``core.graphs.scan``): nodes and every cost bit for bit the
    same solve op by op (``graphs.eager()``), at phase B's 78 nodes and at
    the reference scale's 342.  A second solve of other nodes with the
    same shapes replays the same graph from the caller's nodes, not from
    what the first solve left."""
    from monocular_visual_odometry_va4mr_torch.backend import (
        posegraph, posegraph_sim3)
    from monocular_visual_odometry_va4mr_torch.core import graphs

    optimize = posegraph.optimize if group == "se3" else \
        posegraph_sim3.optimize
    kw = solve_kw(group)
    g1 = posegraph_chain(group, n, cuda)
    g2 = posegraph_chain(group, n, cuda, seed=6)
    captured = graphs.captures(cuda)[0]
    for g in (g1, g2, g1):
        replays = graphs.replays(cuda)
        out, costs = optimize(g, **kw)
        assert graphs.replays(cuda) == replays + kw["iters"]
        with graphs.eager():
            want, want_costs = optimize(g, **kw)
        assert same_bits(out[0], want[0]), describe(out[0], want[0])
        assert same_bits(costs, want_costs), describe(costs, want_costs)
        assert costs.is_cuda and costs[-1] < 0.5 * costs[0]
    assert graphs.captures(cuda)[0] == captured + 1


def test_optimize_consistent_captures_once(cuda):
    """Every solve of ``optimize_consistent`` has one graph's shapes: one
    capture, (1 + suspects + 1) x iters replays when it drops an edge, and
    the outcome bit for bit its run op by op."""
    from monocular_visual_odometry_va4mr_torch.backend import posegraph_sim3
    from monocular_visual_odometry_va4mr_torch.core import graphs

    n = 50
    g = posegraph_chain("sim3", n, cuda, bogus=True)
    captured, replays = graphs.captures(cuda)[0], graphs.replays(cuda)
    trace = {}
    out, costs, dropped = posegraph_sim3.optimize_consistent(
        g, n_odo=n - 1, iters=15, trace=trace)
    assert dropped[-1]  # the wrong edge
    assert graphs.captures(cuda)[0] == captured + 1
    assert graphs.replays(cuda) - replays == (2 + trace["suspects"]) * 15
    with graphs.eager():
        want, want_costs, want_dropped = posegraph_sim3.optimize_consistent(
            g, n_odo=n - 1, iters=15)
    assert list(dropped) == list(want_dropped)
    assert same_bits(out.S_CW, want.S_CW) and same_bits(costs, want_costs)


def test_ba_refine_replays_bit_equal_to_eager(cuda):
    """The runner's windowed BA (``ba_refine.refine``) replays its graph on
    the card (one capture per window shape, a replay a call), bit for bit
    the same refinement op by op, on two windows in turn."""
    import copy

    from monocular_visual_odometry_va4mr_torch.core import graphs
    from monocular_visual_odometry_va4mr_torch.core.camera import Camera
    from monocular_visual_odometry_va4mr_torch.core.config import (
        CapacityConfig, PipelineConfig)
    from monocular_visual_odometry_va4mr_torch.core.state import init_state
    from monocular_visual_odometry_va4mr_torch.pipeline import ba_refine
    from test_torch_parallel import K, WELL_POSED, make_ba_problem

    W, L = 8, 256
    cfg = PipelineConfig(capacity=CapacityConfig(L, 8), image_shape=(32, 32))
    cam = Camera.from_matrix(K)
    captured = graphs.captures(cuda)[0]
    for seed in (1, 2):
        T, X, obs, mask = make_ba_problem(np.random.default_rng(seed), W=W,
                                          L=L, **WELL_POSED)
        state = init_state(cfg, (torch.zeros(32, 32, device=cuda),))
        state = state.replace(T_CW=torch.from_numpy(T[-1]).to(cuda),
                              lm_xyz=torch.from_numpy(X).to(cuda),
                              lm_valid=torch.ones(L, dtype=torch.bool,
                                                  device=cuda),
                              lm_gen=torch.zeros(L, dtype=torch.int32,
                                                 device=cuda))
        ring = ba_refine.BARing(window=W, poses=list(T), obs_uv=list(obs),
                                obs_mask=list(mask),
                                obs_gen=[np.zeros(L, np.int32)] * W)
        ring_eager = copy.deepcopy(ring)
        replays = graphs.replays(cuda)
        out = ba_refine.refine(state, ring, cam)
        assert graphs.replays(cuda) == replays + 1
        with graphs.eager():
            want = ba_refine.refine(state, ring_eager, cam)
        for name in ("T_CW", "lm_xyz"):
            a, b = getattr(out, name), getattr(want, name)
            assert same_bits(a, b), (name, describe(a, b))
        assert not torch.equal(out.lm_xyz, state.lm_xyz)
        for a, b in zip(ring.poses, ring_eager.poses):
            assert np.array_equal(a, b)
    assert graphs.captures(cuda)[0] == captured + 1


# --- the block driver's chunks -----------------------------------------------

def positions(T_CW):
    T = T_CW.double().cpu()
    return -(T[:, :3, :3].mT @ T[:, :3, 3:])[..., 0]


def test_chunk_replays_equal_frame_replays_at_full_width(cuda):
    """``chip_smoke.py``'s main scene and configuration (376x1241,
    kitti_tuned: K = 8, BA every 8 frames over a ring of 10) from the
    bootstrap over frames 0..4, on uint8 frames: a chunk without a BA frame
    (frames 5..12, the ring not yet full) and one with it (frames 13..20,
    the BA at its 7th frame) replayed, against 16 replays of the one-frame
    graph with the same draws: every output field and the final state bit
    for bit (the same kernels on the same inputs), hence positions within
    ``chip_smoke.STREAM_POS_TOL`` of the path; 3 ``klt_lk`` launches a
    frame, one graph a chunk pattern."""
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic
    from monocular_visual_odometry_va4mr_torch.pipeline import runner
    from monocular_visual_odometry_va4mr_torch.tools.harness import (
        render_frames)

    scene = synthetic.make_textured_scene(
        seed=chip_smoke.SEED, num_frames=21, image_shape=chip_smoke.IMAGE_SHAPE,
        step=1.0)
    u8 = [np.clip(np.rint(f), 0, 255).astype(np.uint8)
          for f in render_frames(scene, 21)]
    _, _, vo = chip_smoke.main_path_vo(scene)
    assert vo.chunk_frames == 8
    gen = lambda i: runner.frame_generator(0, i, cuda)  # noqa: E731
    s0 = vo.bootstrap(u8[0], u8[4], intermediate=u8[1:4], generator=gen(0))
    nbytes = vo.outputs[True].nbytes
    rows_f = torch.empty((16, nbytes), dtype=torch.uint8, device=cuda)
    s = s0
    for k, i in enumerate(range(5, 21)):
        s = vo.step(s, u8[i], generator=gen(i), outputs=rows_f[k],
                    landmarks=True)
    imgs = torch.from_numpy(np.stack(u8[5:21])).to(cuda)
    rows_c = torch.empty_like(rows_f)
    before = tk2.klt_lk.launches
    c, flags = s0, []
    for k in (0, 8):
        flags.append(vo.ba_flags(c, 8))
        c = vo.step_chunk(c, imgs[k:k + 8],
                          [vo.step_draws(gen(i)) for i in range(5 + k, 13 + k)],
                          outputs=rows_c[k:k + 8], landmarks=True)
    assert tk2.klt_lk.launches - before == 3 * 16
    assert flags == [(False,) * 8, tuple(f == 16 for f in range(10, 18))]
    chunks = [k for k in vo.graphs.graphs if k[0] == "chunk"]
    assert sorted(k[2] for k in chunks) == sorted(flags)
    out_f, out_c = (vo.outputs[True].views(r) for r in (rows_f, rows_c))
    assert torch.equal(out_f[3], out_c[3])  # statuses
    p_f, p_c = positions(out_f[0]), positions(out_c[0])
    path = float((p_f[1:] - p_f[:-1]).norm(dim=1).sum())
    diff = float((p_f - p_c).abs().max())
    # Field by field: a packed row's padding between fields is never
    # written.
    differ = [f"out{k}" for k, (a, b) in enumerate(zip(out_f, out_c))
              if not same_bits(a, b)]
    differ += [f"state{k}" for k, (a, b) in enumerate(zip(s.tensors(),
                                                           c.tensors()))
               if not same_bits(a, b)]
    print(f"chunk_vs_frames bit_equal={not differ} differ={differ} "
          f"pos_diff={diff} path={path}")
    assert not differ, (differ, diff, path)
    assert diff <= chip_smoke.STREAM_POS_TOL * path, (diff, path)
    assert int(c.status) == int(s.status) and c.host_frame == s.host_frame


def test_one_capture_per_chunk_pattern_over_a_64_frame_block(cuda):
    """kitti_tuned's cadence (BA every 8 frames over a ring of 10, K = 8) on
    the 240x320 corridor: seven steps take the state to frame 8, then
    ``make_scan_step`` runs a 64-frame block as 8 chunks of one pattern
    (the BA at each chunk's last frame): one capture, 8 replays, 3
    ``klt_lk`` launches a frame, and a loop of ``step`` over the same
    frames gives the same statuses and positions within
    ``chip_smoke.STREAM_POS_TOL`` of the path."""
    from monocular_visual_odometry_va4mr_torch.pipeline import (runner,
                                                                scan_driver)

    make, frames = graph_vo(cuda, num_frames=74, ba=(8, 10))
    vo = make()
    gen = lambda i: runner.frame_generator(0, i, cuda)  # noqa: E731
    s = vo.bootstrap(frames[0], frames[2], intermediate=frames[1:2],
                     generator=gen(0))
    for i in range(3, 10):
        s = vo.step(s, frames[i], generator=gen(i))
    assert s.host_frame == 8
    ids = range(10, 74)
    imgs = torch.from_numpy(np.stack([frames[i] for i in ids])).to(cuda)
    replays, before = vo.graphs.replays, tk2.klt_lk.launches
    final, outs = scan_driver.make_scan_step(vo)(s, imgs,
                                                 [gen(i) for i in ids])
    assert tk2.klt_lk.launches - before == 3 * 64
    assert vo.graphs.replays - replays == 8
    chunks = [k for k in vo.graphs.graphs if k[0] == "chunk"]
    assert len(chunks) == 1 and chunks[0][2] == (False,) * 7 + (True,)
    loop = []
    for i in ids:
        s = vo.step(s, frames[i], generator=gen(i))
        loop.append((int(s.status), s.T_CW.cpu()))
    assert outs.status.tolist() == [st for st, _ in loop]
    p_l = positions(torch.stack([T for _, T in loop]))
    path = float((p_l[1:] - p_l[:-1]).norm(dim=1).sum())
    assert float((positions(outs.T_CW) - p_l).abs().max()) <= (
        chip_smoke.STREAM_POS_TOL * path)
    assert final.host_frame == s.host_frame == 72


def test_a_state_written_after_its_replay_is_copied_in(cuda):
    """The state buffer still holds the state the last replay returned, so
    the next replay copies nothing in; once a field of that state is
    written in place (its buffer's version moves on), the next replay
    copies it in and steps from the written state, as the eager body
    does."""
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    make, frames = graph_vo(cuda)
    vo = make()
    gen = lambda i: runner.frame_generator(0, i, cuda)  # noqa: E731
    s = vo.bootstrap(frames[0], frames[2], intermediate=frames[1:2],
                     generator=gen(0))
    s = vo.step(s, frames[3], generator=gen(3))
    s.T_CW[0, 3] += 0.05
    nxt = vo.step(s, frames[4], generator=gen(4))
    ref = chip_smoke.eager_step(vo, s, frames[4], generator=gen(4))
    for a, b in zip(nxt.tensors(), ref.tensors()):
        assert same_bits(a, b), describe(a, b)


# A chunk whose body reads the device on the host, in a process of its own
# (a failed capture can leave the process's CUDA state unusable).
CHUNK_CAPTURE_PROBE = """
import sys
import numpy as np
import torch
sys.path.insert(0, "tests")
import test_torch_cuda as t
from monocular_visual_odometry_va4mr_torch.pipeline import runner

cuda = torch.device("cuda")
make, frames = t.graph_vo(cuda)
vo = make()
gen = lambda i: runner.frame_generator(0, i, cuda)
s = vo.bootstrap(frames[0], frames[2], intermediate=frames[1:2],
                 generator=gen(0))
body = vo._chunk_impl

def reads_the_host(*args, **kw):
    out = body(*args, **kw)
    int(out.status)
    return out

vo._chunk_impl = reads_the_host
imgs = torch.from_numpy(np.stack(frames[3:5])).to(cuda)
try:
    vo.step_chunk(s, imgs, [vo.step_draws(gen(i)) for i in (3, 4)])
except RuntimeError:
    print("raised", vo.graphs.replays, len(vo.graphs.graphs), flush=True)
else:
    print("ran", flush=True)
"""


def test_a_chunk_that_fails_to_capture_raises(cuda):
    """No fallback: a chunk whose capture fails raises, and nothing has
    replayed a one-frame graph in its place."""
    out = subprocess.run([sys.executable, "-c", CHUNK_CAPTURE_PROBE],
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.split() == ["raised", "0", "0"], out.stderr[-2000:]


# --- spans on the device trace's clock (core/spans.py) -----------------------

def kineto(prof, records=()):
    """A profiler's events as ``core.spans.trace_events`` reads them, and
    the spans' ``graph.replay`` records, on one axis in us: (events, links,
    replays as sorted (start, end, attrs))."""
    from monocular_visual_odometry_va4mr_torch.core import spans

    t0 = prof.profiler.kineto_results.trace_start_ns()
    events, links, _ = spans.trace_events(
        prof.profiler.kineto_results.events(), t0)
    replays = sorted(((r[3] - t0) / 1e3, (r[4] - t0) / 1e3, r[5])
                     for r in records if r[2] == "graph.replay")
    return events, links, replays


@pytest.fixture(scope="module")
def traced_stream():
    """A chunked stream on the card (the in-step BA every 2 frames over a
    ring of 3: chunks of 2, single steps before the ring fills and at a
    block's tail), blocks of 7 without recovery, run once to capture its
    graphs and once more with spans on under ``torch.profiler`` (CUDA
    activity, as the benchmark's traced passes): (vo, frames, records,
    profiler)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    from torch.profiler import ProfilerActivity, profile

    from monocular_visual_odometry_va4mr_torch.core import spans
    from monocular_visual_odometry_va4mr_torch.pipeline import (runner,
                                                                scan_driver)

    cuda = torch.device("cuda")
    make, frames = graph_vo(cuda, num_frames=20)
    vo = make()

    def stream():
        s = vo.bootstrap(frames[0], frames[2], intermediate=frames[1:2],
                         generator=runner.frame_generator(0, 0, cuda))
        return scan_driver.run_streaming(
            vo, s, ((i, frames[i]) for i in range(3, 20)), 0, block=7)

    stream()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spans.start()
        try:
            stream()
            torch.cuda.synchronize()
        finally:
            records = spans.stop()
    return vo, frames, records, prof


def replay_of(t0, t1, replays):
    """The ``graph.replay`` span (start, end, attrs) around a host call
    from ``t0`` to ``t1`` us, within ``core.spans.CLOCK_US``, or None."""
    from monocular_visual_odometry_va4mr_torch.core.spans import CLOCK_US

    i = bisect.bisect_right([r[0] for r in replays], t0 + CLOCK_US) - 1
    if i >= 0 and t1 <= replays[i][1] + CLOCK_US:
        return replays[i]
    return None


def test_graph_launches_lie_in_their_replay_spans(traced_stream):
    """Spans and the profiler share a clock: every ``cudaGraphLaunch`` of a
    profiled chunked stream lies inside a ``graph.replay`` span, within
    20 us, and the device work it queued starts after the span began."""
    vo, _, records, prof = traced_stream
    events, links, replays = kineto(prof, records)
    launches = [e for e in events
                if e[0] == "host" and e[1] == "cudaGraphLaunch"]
    assert len(launches) >= len(replays) > 0
    outside = [e[2:] for e in launches
               if replay_of(e[2], e[3], replays) is None]
    assert not outside, (len(outside), outside[:5])
    linked = 0
    for d, h in links.items():
        if events[h][1] == "cudaGraphLaunch":
            r = replay_of(events[h][2], events[h][3], replays)
            assert events[d][2] >= r[0], (events[d], r[:2])
            linked += 1
    assert linked > len(replays)


def test_stage_map_splits_a_chunk_and_a_step_replay(traced_stream):
    """``StepGraphs.stage_map`` against the traced stream: for each step
    and chunk key, its last replay's device events, in order, carry the
    map's names one for one (a copy or a fill by its kind: a graph runs a
    copy as a kernel), and the map gives every one of them a stage."""
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import op_kind

    vo, _, records, prof = traced_stream
    events, links, replays = kineto(prof, records)
    maps = vo.graphs.stage_map()
    assert {k[0] == "chunk" for k in maps} == {True, False}
    last = {}
    for r in replays:
        if r[2]["key"] in maps:
            assert r[2]["segments"] == 1
            last[r[2]["key"]] = r
    assert set(last) == set(maps)
    for key, r in last.items():
        names = [op_kind(events[d][1])
                 for d in sorted(links, key=lambda d: events[d][2])
                 if events[links[d]][1] == "cudaGraphLaunch"
                 and replay_of(*events[links[d]][2:], [r]) is not None]
        staged = maps[key]
        assert names == [n for n, _ in staged], (key, len(names),
                                                 len(staged))
        assert all(st is not None for _, st in staged), key
        assert {"stage.klt", "stage.pnp", "stage.pack"} <= {
            st for _, st in staged}


def test_spans_add_no_runtime_call(traced_stream):
    """A replayed pass makes the same CUDA runtime calls, in the same
    order, with spans off and on: a span reads the host's clock only."""
    from torch.profiler import ProfilerActivity, profile

    from monocular_visual_odometry_va4mr_torch.core import spans
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    vo, frames, _, _ = traced_stream
    cuda = torch.device("cuda")
    imgs = torch.from_numpy(np.stack(frames[3:7])).to(cuda)
    s0 = vo.bootstrap(frames[0], frames[2], intermediate=frames[1:2],
                      generator=runner.frame_generator(0, 0, cuda))
    draws = [vo.step_draws(runner.frame_generator(0, i, cuda))
             for i in range(3, 7)]

    def steps():
        s = vo.step(s0, imgs[0], draws=draws[0])
        s = vo.step_chunk(s, imgs[1:3], draws[1:3])
        vo.step(s, imgs[3], draws=draws[3])
        torch.cuda.synchronize()

    steps()  # captures what the stream did not
    calls = []
    for on in (False, True, False):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if on:
                spans.start()
            try:
                steps()
            finally:
                if on:
                    assert spans.stop()
        events, _, _ = kineto(prof)
        calls.append([e[1] for e in sorted(events, key=lambda e: e[2])
                      if e[0] == "host" and e[1].startswith(spans.RUNTIME)])
    assert calls[0] == calls[1] == calls[2]
    assert calls[0].count("cudaGraphLaunch") == 3
