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

from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as tv1
from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as tk2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def smooth_image(gen, H, W):
    img = torch.rand((1, 1, H, W), generator=gen) * 255.0
    k = torch.ones(1, 1, 5, 5) / 25.0
    for _ in range(2):
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
