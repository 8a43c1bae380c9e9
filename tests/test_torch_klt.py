"""The port's KLT (the LK kernel's plain twin, the coarse prior, the tracker
chain) against the JAX package's Pallas tracker in interpret mode.

Inputs are made from a seed with numpy and fed to both.  On the CPU the
port's kernel wrapper runs its plain twin; the CUDA kernel itself is held
against the twin in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances:
  * positions of features accepted by both: within 1e-3 px (max), since
    both compute the same float32 function and differ only in summation
    order (measured: median 0, max ~5e-5 px);
  * ok masks: equal;
  * both exempt the features that the reference kernel's 32-row slab can
    wrap on (ROADMAP.md Queue 3): at win=15, registration rolls the slab up
    by ``sub`` in [0, 7] rows, so a search drifting ``ny`` px down reads a
    wrapped row when ``sub + ny > 23 - win``.  The port reads the true
    image there.  The tests assert that every difference lies in that set.

``stress_diag.reference_read_lk``, the plain LK that reads what the
reference kernel reads (its wrapped rows, and its 4-feature sums that a
runaway search makes NaN), is held against the reference with no exempt
set: equal ok masks and every accepted feature within 1e-3 px (measured
3e-5 px), on the cases above, on inputs built so that the slab wraps, on
runaway searches and through the /16 -> /4 -> full-res chain.  It is way
(a) of the hard-realism attribution (PERF.md), so its result there is the
reference tracker's.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_tpu.ops import image as jimops
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas as jv1
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas2 as jk2
from monocular_visual_odometry_va4mr_torch.ops import image as timops
from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as tv1
from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as tk2
from stress_diag import reference_read_lk

torch.set_num_threads(1)

POS_TOL_PX = 1e-3


def texture(rng, H=240, W=320, blur=2):
    img = rng.uniform(0, 255, size=(H, W)).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), blur)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


def shifted(img, dx, dy):
    M = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv2.warpAffine(img, M, (img.shape[1], img.shape[0]))


def tt(x):
    return torch.from_numpy(np.array(x))


def torch_pyr(pyr):
    return tuple(tt(p) for p in pyr)


def search_positions(prev_pyr, next_pyr, pts, prior, swap):
    """The search-window centres q the wrapper derives (port's arithmetic)."""
    H, W = prev_pyr[0].shape
    lim = np.array([W + 8.0, H + 8.0], np.float32)
    pts_s = np.clip(np.nan_to_num(pts, nan=64.0), -8.0, lim)
    if prior is None:
        a, b = (next_pyr, prev_pyr) if swap else (prev_pyr, next_pyr)
        ca, cb = a[min(4, len(a) - 1)], b[min(4, len(b) - 1)]
        scale = float(round(H / ca.shape[0]))
        flow = tv1.coarse_flow_volume(tt(ca), tt(cb))
        prior = (tv1.sample_map_onehot(flow, tt(pts_s) / scale) * scale).numpy()
    return np.clip(pts_s + prior, -8.0, lim)


def wrap_exposed(q, finals, win):
    """Features whose search can read a row the reference's slab wrapped."""
    t = q - (win - 1) / 2.0 + tk2.PAD
    tf = np.floor(t)
    by = tf[:, 1].astype(np.int64) - 8
    sub = by % 8
    gys = [t[:, 1] - tf[:, 1]] + [p[:, 1] - tf[:, 1] + tk2.PAD - (win - 1) / 2
                                  for p in finals]
    ny = np.clip(np.floor(np.max(gys, axis=0)), -8, 7)
    return sub + ny > 23 - win


def assert_parity(jax_out, torch_out, exposed):
    pj, okj, rj = (np.asarray(a) for a in jax_out)
    pt, okt, rt = (a.numpy() for a in torch_out)
    err = np.linalg.norm(pj - pt, axis=1)
    both = okj & okt
    assert both.sum() > 0, "no feature tracked"
    assert np.all(err[both & ~exposed] < POS_TOL_PX), err[both & ~exposed].max()
    assert np.array_equal(okj[~exposed], okt[~exposed])
    # Every difference is a wrap-exposed feature, and those stay few.
    assert (exposed & ((okj != okt) | (err > POS_TOL_PX))).sum() <= max(
        2, 0.1 * len(okj))


def run_both(pyr0, pyr1, pts, valid, **kw):
    jax_out = jk2.track_features_pallas2(
        pyr0, pyr1, jnp.asarray(pts), jnp.asarray(valid), interpret=True,
        **{k: (jnp.asarray(v) if k == "prior" else v) for k, v in kw.items()})
    torch_out = tk2.track_features_pallas2(
        torch_pyr(pyr0), torch_pyr(pyr1), tt(pts), tt(valid),
        **{k: (tt(v) if k == "prior" else v) for k, v in kw.items()})
    q = search_positions(pyr0, pyr1, pts, kw.get("prior"),
                         kw.get("swap_planes", False))
    exposed = wrap_exposed(q, [np.asarray(jax_out[0]),
                               torch_out[0].numpy()], kw.get("win", 15))
    return jax_out, torch_out, exposed


@pytest.mark.parametrize("win", [7, 15])
def test_pure_translation(rng, win):
    img0 = texture(rng)
    img1 = shifted(img0, 3.7, -2.3)
    pts = np.stack([rng.uniform(30, 290, 128), rng.uniform(30, 210, 128)],
                   1).astype(np.float32)
    pyr0 = jimops.build_pyramid(jnp.asarray(img0), 5)
    pyr1 = jimops.build_pyramid(jnp.asarray(img1), 5)
    jax_out, torch_out, exposed = run_both(pyr0, pyr1, pts, np.ones(128, bool),
                                           num_iters=8, win=win)
    assert_parity(jax_out, torch_out, exposed)
    ok = torch_out[1].numpy()
    err = np.linalg.norm(torch_out[0].numpy()[ok] - pts[ok] - [3.7, -2.3], axis=1)
    assert ok.sum() > 90 and np.median(err) < 0.1


def test_large_motion_via_coarse_prior(rng):
    img0 = texture(rng)
    img1 = shifted(img0, 37.0, 11.0)
    pts = np.stack([rng.uniform(20, 260, 128), rng.uniform(20, 200, 128)],
                   1).astype(np.float32)
    pyr0 = jimops.build_pyramid(jnp.asarray(img0), 5)
    pyr1 = jimops.build_pyramid(jnp.asarray(img1), 5)
    jax_out, torch_out, exposed = run_both(pyr0, pyr1, pts, np.ones(128, bool),
                                           num_iters=8)
    assert_parity(jax_out, torch_out, exposed)


def test_invalid_slots_and_garbage_positions(rng):
    img0 = texture(rng, 120, 160)
    pyr = jimops.build_pyramid(jnp.asarray(img0), 4)
    pts = np.full((8, 2), 50.0, np.float32)
    pts[3] = np.nan  # invalid slots may hold garbage
    pts[4] = [1e9, -1e9]
    valid = np.zeros(8, bool)
    valid[0] = True
    jax_out, torch_out, exposed = run_both(pyr, pyr, pts, valid, num_iters=5)
    assert_parity(jax_out, torch_out, exposed)
    assert not torch_out[1].numpy()[1:].any()


@pytest.mark.parametrize("swap", [False, True])
def test_explicit_prior_and_swap_planes(rng, swap):
    """The backward pass: explicit prior, template and search swapped."""
    img0 = texture(rng)
    img1 = shifted(img0, 2.6, -1.2)
    pts = np.stack([rng.uniform(20, 300, 128), rng.uniform(20, 220, 128)],
                   1).astype(np.float32)
    prior = (np.float32([-2.6, 1.2] if swap else [2.6, -1.2])
             + rng.normal(0, 1.5, (128, 2)).astype(np.float32))
    pyr0 = jimops.build_pyramid(jnp.asarray(img0), 5)
    pyr1 = jimops.build_pyramid(jnp.asarray(img1), 5)
    valid = rng.uniform(size=128) < 0.9
    jax_out, torch_out, exposed = run_both(
        pyr0, pyr1, pts, valid, num_iters=4, prior=prior, swap_planes=swap,
        win=15)
    assert_parity(jax_out, torch_out, exposed)
    assert torch_out[1].numpy().sum() > 60


@pytest.mark.parametrize("mid_iters", [0, 4])
def test_track_multilevel_on_flat_pyramids(rng, mid_iters):
    """The /16 prior -> /4 LK -> full-res LK chain on build_flat_pyramid
    planes; mid_iters=0 runs the mid pass at num_iters, 4 is the Malaga
    preset's cap on it."""
    img0 = texture(rng, 192, 320)
    img1 = shifted(img0, 9.5, 3.25)
    jp0 = jimops.build_flat_pyramid(jnp.asarray(img0), 16, 4)
    jp1 = jimops.build_flat_pyramid(jnp.asarray(img1), 16, 4)
    tp0 = timops.build_flat_pyramid(tt(img0), 16, 4)
    for a, b in zip(jp0, tp0):  # box means: f32 sums in another order
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-4)
    pts = np.stack([rng.uniform(20, 300, 128), rng.uniform(20, 170, 128)],
                   1).astype(np.float32)
    valid = np.ones(128, bool)
    kw = dict(num_iters=6, mid_iters=mid_iters, eps=0.01,
              min_eig_threshold=1e-4, max_residual=20.0, win=15)
    jax_out = jk2.track_multilevel(
        jp0, jp1, jnp.asarray(pts), jnp.asarray(valid),
        track_fn=jk2.track_features_pallas2, interpret=True, **kw)
    # Same planes on both sides: the chain is under test, not the pyramid.
    torch_out = tk2.track_multilevel(torch_pyr(jp0), torch_pyr(jp1), tt(pts),
                                     tt(valid), **kw)
    pj, okj, _ = (np.asarray(a) for a in jax_out)
    pt, okt, _ = (a.numpy() for a in torch_out)
    both = okj & okt
    err = np.linalg.norm(pj - pt, axis=1)[both]
    assert both.sum() > 60
    # Wrap-exposed features can differ at either pass; they stay few.
    assert np.median(err) < POS_TOL_PX
    assert (err > POS_TOL_PX).sum() <= 0.1 * len(err)
    assert (okj != okt).sum() <= 0.05 * len(okj)
    ok = okt
    assert np.median(np.linalg.norm(pt[ok] - pts[ok] - [9.5, 3.25], axis=1)) < 0.1


def test_coarse_flow_volume_and_prior_sampling(rng):
    i0 = texture(rng, 15, 20, blur=1)
    i1 = shifted(i0, 2.0, -1.0)
    fj = np.asarray(jv1.coarse_flow_volume(jnp.asarray(i0), jnp.asarray(i1)))
    ft = tv1.coarse_flow_volume(tt(i0), tt(i1)).numpy()
    # Same shift-add sums, same first-argmin: the integer flow is exact and
    # the parabola differs by float32 rounding only.
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)
    pts = np.stack([rng.uniform(-3, 23, 64), rng.uniform(-3, 18, 64)],
                   1).astype(np.float32)
    sj = np.asarray(jv1.sample_map_onehot(jnp.asarray(fj), jnp.asarray(pts)))
    st = tv1.sample_map_onehot(tt(fj), tt(pts)).numpy()
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)


def test_kernel_wrapper_checks_its_inputs():
    img = torch.zeros(32, 48)
    feat = torch.zeros(4, tk2.FEAT_COLS)
    valid = torch.ones(4, dtype=torch.bool)
    kw = dict(win=15, num_iters=4, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    with pytest.raises(TypeError):
        tk2.klt_lk(img.double(), img.double(), feat, valid, **kw)
    with pytest.raises(ValueError):
        tk2.klt_lk(img, img[:, :40], feat, valid, **kw)
    with pytest.raises(ValueError):
        tk2.klt_lk(img, img, feat[:, :5], valid, **kw)
    with pytest.raises(ValueError):
        tk2.klt_lk(img, img, feat, valid, **dict(kw, win=16))
    with pytest.raises(ValueError):
        tk2.klt_lk(img, img, feat, valid, **dict(kw, num_iters=9))
    before = tk2.klt_lk.launches
    out = tk2.klt_lk(img, img, feat, valid, **kw)  # CPU: the twin, no launch
    assert out.shape == (4, tk2.OUT_COLS) and tk2.klt_lk.launches == before


# --- the reference's reading (stress_diag.reference_read_lk) ---------------

def assert_same(jax_out, torch_out):
    """Equal ok masks, every accepted feature within POS_TOL_PX."""
    pj, okj, _ = (np.asarray(a) for a in jax_out)
    pt, okt, _ = (a.numpy() for a in torch_out)
    np.testing.assert_array_equal(okt, okj)
    err = np.linalg.norm(pj - pt, axis=1)[okj]
    assert np.all(err < POS_TOL_PX), err.max()


def refread_case(rng, name):
    """(pyramids, positions, valid, keyword arguments, the least number of
    features whose search reads a wrapped row) of one case."""
    img0 = texture(rng)
    n = 128
    pts = np.stack([rng.uniform(30, 290, n), rng.uniform(30, 210, n)],
                   1).astype(np.float32)
    valid, prior, swap, win, exposed = np.ones(n, bool), None, False, 15, 0
    if name.startswith("translation"):
        img1, win = shifted(img0, 3.7, -2.3), int(name[-2:].strip("n"))
    elif name == "large_motion":
        img1, exposed = shifted(img0, 37.0, 11.0), 1
    elif name.startswith("prior"):
        swap = name.endswith("backward")
        img1 = shifted(img0, 2.6, -1.2)
        prior = (np.float32([-2.6, 1.2] if swap else [2.6, -1.2])
                 + rng.normal(0, 1.5, (n, 2)).astype(np.float32))
        valid = rng.uniform(size=n) < 0.9
    else:  # forced wrap: sub = 7 and the truth 7.7 px down, as below
        swap = name.endswith("backward")
        img1 = shifted(img0, 0.0, -7.3 if swap else 7.3)
        pts[:, 1] = 8.0 * rng.integers(2, 24, n) + 6.4
        prior, exposed = np.zeros((n, 2), np.float32), 40
    kw = dict(num_iters=8, win=win, swap_planes=swap)
    if prior is not None:
        kw["prior"] = prior
    return (jimops.build_pyramid(jnp.asarray(img0), 5),
            jimops.build_pyramid(jnp.asarray(img1), 5), pts, valid, kw,
            exposed)


@pytest.mark.parametrize("name", [
    "translation_win7", "translation_win15", "large_motion",
    "prior_forward", "prior_backward", "forced_wrap_forward",
    "forced_wrap_backward"])
def test_reference_read_equals_the_reference(rng, monkeypatch, name):
    """The forced wrap: every search origin has ``sub`` = 7 and the true
    offset is 7.7 px down (template rows 8k + 6.4 put the window top at
    padded row 8k + 31, by = 8k + 23), so a search that gets 2 px or more
    down reads its window's last rows from 32 rows above, in the forward
    call and in the backward one, whose slab follows its own search
    origin.  Measured: 74 and 75 of 128 searches read a wrapped row (2, 4,
    9 and 0 in the other win-15 cases), positions within 3e-5 px."""
    pyr0, pyr1, pts, valid, kw, exposed = refread_case(rng, name)
    monkeypatch.setattr(tk2, "klt_lk", reference_read_lk)
    jax_out, torch_out, wrapped = run_both(pyr0, pyr1, pts, valid, **kw)
    assert np.asarray(jax_out[1]).sum() > 20
    assert wrapped.sum() >= exposed
    assert_same(jax_out, torch_out)


def test_reference_read_fails_a_runaway_group(rng, monkeypatch):
    """The reference sums 4 features in one matmul: a search that runs away
    and overflows (features 4k, on a template that is flat but for tiny
    noise, against a textured search plane) makes the residuals of the 3
    others of its group NaN, so they are rejected where they froze.  The
    port's own tracker accepts them; the reference's reading follows the
    reference feature for feature."""
    img0 = texture(rng, 120, 160)
    img1 = shifted(img0, 2.5, 1.5)
    img0[:, :60] = 100.0 + rng.normal(0, 0.01, (120, 60)).astype(np.float32)
    pts = np.stack([rng.uniform(70, 140, 32), rng.uniform(20, 100, 32)],
                   1).astype(np.float32)
    pts[0::4, 0] = rng.uniform(15, 40, 8)
    args = (jimops.build_pyramid(jnp.asarray(img0), 3),
            jimops.build_pyramid(jnp.asarray(img1), 3), pts,
            np.ones(32, bool))
    kw = dict(num_iters=8, prior=np.tile(np.float32([2.5, 1.5]), (32, 1)))
    mates = np.arange(32) % 4 != 0
    _, own, _ = run_both(*args, **kw)
    assert own[1].numpy()[mates].mean() > 0.9
    monkeypatch.setattr(tk2, "klt_lk", reference_read_lk)
    jax_out, torch_out, _ = run_both(*args, **kw)
    (pj, okj, rj), (pt, okt, rt) = (
        [np.asarray(a) for a in out] for out in (jax_out, torch_out))
    assert np.isnan(pj[0::4]).all() and np.isnan(rj).all() and not okj.any()
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(np.isnan(rt), np.isnan(rj))
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    fin = np.isfinite(pj).all(1)
    assert fin[mates].all()
    assert np.abs(pj[fin] - pt[fin]).max() < POS_TOL_PX


@pytest.mark.parametrize("mid_iters", [0, 4])
def test_reference_read_through_the_chain(rng, monkeypatch, mid_iters):
    """The /16 prior -> /4 LK -> full-res LK chain with the reference's
    reading: every ok flag equal and every accepted feature within 1e-3 px
    (the test above holds the port's own chain by median only)."""
    img0 = texture(rng, 192, 320)
    img1 = shifted(img0, 9.5, 3.25)
    jp0 = jimops.build_flat_pyramid(jnp.asarray(img0), 16, 4)
    jp1 = jimops.build_flat_pyramid(jnp.asarray(img1), 16, 4)
    pts = np.stack([rng.uniform(20, 300, 128), rng.uniform(20, 170, 128)],
                   1).astype(np.float32)
    valid = np.ones(128, bool)
    kw = dict(num_iters=6, mid_iters=mid_iters, eps=0.01,
              min_eig_threshold=1e-4, max_residual=20.0, win=15)
    jax_out = jk2.track_multilevel(
        jp0, jp1, jnp.asarray(pts), jnp.asarray(valid),
        track_fn=jk2.track_features_pallas2, interpret=True, **kw)
    monkeypatch.setattr(tk2, "klt_lk", reference_read_lk)
    torch_out = tk2.track_multilevel(torch_pyr(jp0), torch_pyr(jp1), tt(pts),
                                     tt(valid), **kw)
    assert np.asarray(jax_out[1]).sum() > 60
    assert_same(jax_out, torch_out)
