"""The port's gather tracker (``ops/klt.py``, ``klt.backend="xla"``) and the
image ops it needs against the JAX package, and the slice (bootstrap + 3
steps with in-step BA) on that tracker.

Inputs are made from a seed with numpy and fed to both, at the sizes of
``tests/test_image_ops.py``.

Tolerances:
  * image ops: float32 rounding of convolutions summed in another order
    (atol 1e-3 on 0..255 images); ``window_coords`` exact;
  * the tracker: positions within 1e-3 px (the iterations amplify ulp
    differences of the pyramid; measured max ~1e-4 px) and equal ok masks
    on features whose final residual is not within 1e-3 of its gate;
  * the slice: the tests/test_torch_vo.py tolerances with equal tracks
    (0.01 deg, 1e-3; measured 1e-3 deg, 7e-5).
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_tpu.ops import image as jimops
from monocular_visual_odometry_va4mr_tpu.ops import klt as jklt
from monocular_visual_odometry_va4mr_torch.ops import image as timops
from monocular_visual_odometry_va4mr_torch.ops import klt as tklt
from test_torch_vo import (MASK_AGREE, N_STEPS, ROT_TOL_DEG, T_TOL,
                           assert_states_agree, rot_deg, slice_runs)

torch.set_num_threads(1)

IMG_TOL = 1e-3
POS_TOL_PX = 1e-3


def tt(x):
    return torch.from_numpy(np.array(x))


def texture(rng, H=240, W=320, blur=2):
    img = cv2.GaussianBlur(rng.uniform(0, 255, (H, W)).astype(np.float32),
                           (0, 0), blur)
    return ((img - img.min()) / (img.max() - img.min()) * 255.0).astype(
        np.float32)


def shifted(img, dx, dy):
    M = np.float32([[1, 0, dx], [0, 1, dy]])
    return cv2.warpAffine(img, M, (img.shape[1], img.shape[0]))


@pytest.mark.parametrize("sigma,radius", [(1.6, None), (1.1, 3)])
def test_gaussian_blur_and_kernel(rng, sigma, radius):
    img = rng.uniform(0, 255, (64, 80)).astype(np.float32)
    np.testing.assert_allclose(
        timops.gaussian_kernel_1d(sigma, radius).numpy(),
        np.asarray(jimops.gaussian_kernel_1d(sigma, radius)), rtol=1e-6)
    np.testing.assert_allclose(
        timops.gaussian_blur(tt(img), sigma, radius).numpy(),
        np.asarray(jimops.gaussian_blur(jnp.asarray(img), sigma, radius)),
        rtol=0, atol=IMG_TOL)


def test_pyramid_and_central_gradients(rng):
    img = rng.uniform(0, 255, (64, 80)).astype(np.float32)
    np.testing.assert_allclose(
        timops.pyr_down(tt(img)).numpy(),
        np.asarray(jimops.pyr_down(jnp.asarray(img))), rtol=0, atol=IMG_TOL)
    tp = timops.build_pyramid(tt(img), 4)
    jp = jimops.build_pyramid(jnp.asarray(img), 4)
    assert [tuple(p.shape) for p in tp] == [p.shape for p in jp]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=IMG_TOL)
    for a, b in zip(timops.central_gradients(tt(img)),
                    jimops.central_gradients(jnp.asarray(img))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)


def test_bilinear_sample_and_window_coords(rng):
    img = rng.uniform(0, 255, (32, 32)).astype(np.float32)
    uv = rng.uniform(-3, 35, (50, 2)).astype(np.float32)
    uv[0] = np.nan
    a = timops.bilinear_sample(tt(img), tt(uv)).numpy()
    b = np.asarray(jimops.bilinear_sample(jnp.asarray(img), jnp.asarray(uv)))
    np.testing.assert_allclose(a[1:], b[1:], rtol=1e-6, atol=1e-4)
    assert np.isnan(a[0]).all() and np.isnan(b[0]).all()
    for w in (5, 15):
        np.testing.assert_array_equal(timops.window_coords(w).numpy(),
                                      np.asarray(jimops.window_coords(w)))


def run_both(prev_img, next_img, pts, valid, levels, **kw):
    jp0 = jimops.build_pyramid(jnp.asarray(prev_img), levels)
    jp1 = jimops.build_pyramid(jnp.asarray(next_img), levels)
    jout = jklt.track_features(jp0, jp1, jnp.asarray(pts),
                               jnp.asarray(valid), **kw)
    # The same planes on both sides: the tracker is under test here.
    tout = tklt.track_features(tuple(tt(p) for p in jp0),
                               tuple(tt(p) for p in jp1), tt(pts), tt(valid),
                               **kw)
    return [np.asarray(a) for a in jout], [a.numpy() for a in tout]


def assert_parity(jout, tout, max_residual):
    (pj, okj, rj), (pt, okt, rt) = jout, tout
    # Features whose residual sits on the gate may flip either way.
    settled = np.abs(rj - max_residual) > 1e-3
    both = okj & okt
    assert both.sum() > 0
    err = np.abs(pj - pt).max(1)
    assert np.all(err[both] < POS_TOL_PX), err[both].max()
    assert np.array_equal(okj[settled], okt[settled])
    np.testing.assert_allclose(rt[both], rj[both], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dx,dy,levels", [(2.5, -1.5, 3), (17.0, 9.0, 4)])
def test_track_features_translation(rng, dx, dy, levels):
    img0 = texture(rng)
    pts = np.stack([rng.uniform(40, 280, 128), rng.uniform(40, 200, 128)],
                   1).astype(np.float32)
    valid = np.ones(128, bool)
    kw = dict(window=15, num_iters=20, max_residual=20.0)
    jout, tout = run_both(img0, shifted(img0, dx, dy), pts, valid, levels,
                          **kw)
    assert_parity(jout, tout, 20.0)
    ok = tout[1]
    assert ok.sum() > 80
    err = np.linalg.norm(tout[0][ok] - pts[ok] - [dx, dy], axis=1)
    assert np.median(err) < 0.1


def test_track_features_window_and_invalid_slots(rng):
    """A window outside the kernel trackers' 5..15 (the reason the gather
    tracker exists) and invalid slots holding garbage."""
    img0 = texture(rng, 120, 160)
    pts = np.stack([rng.uniform(5, 155, 64), rng.uniform(5, 115, 64)],
                   1).astype(np.float32)
    valid = rng.uniform(size=64) < 0.8
    pts[3] = np.nan
    valid[3] = False
    kw = dict(window=21, num_iters=10, max_residual=20.0)
    jout, tout = run_both(img0, shifted(img0, 1.25, 0.5), pts, valid, 2,
                          **kw)
    fin = np.isfinite(pts).all(1)
    assert_parity([a[fin] for a in jout], [a[fin] for a in tout], 20.0)
    assert not tout[1][~valid].any() and not jout[1][~valid].any()


@pytest.fixture(scope="module")
def runs_xla():
    return slice_runs("xla")


def test_xla_bootstrap_matches_reference(runs_xla):
    j, t = runs_xla["j_boot"], runs_xla["t_boot"]
    assert int(j["status"]) == 0
    assert len(j["prev_pyramid"]) == len(t["prev_pyramid"]) >= 5
    assert_states_agree(j, t)


@pytest.mark.parametrize("k", range(N_STEPS))
def test_xla_step_matches_reference(runs_xla, k):
    j, t = runs_xla["j_steps"][k], runs_xla["t_steps"][k]
    assert int(t["frame_idx"]) == int(j["frame_idx"]) == 2 + k
    assert int(j["n_tracked"]) == int(t["n_tracked"])
    assert rot_deg(j["T_CW"], t["T_CW"]) < ROT_TOL_DEG
    np.testing.assert_allclose(t["T_CW"][:3, 3], j["T_CW"][:3, 3], atol=T_TOL)
    for name in ("lm_valid", "cand_valid"):
        assert np.mean(j[name] == t[name]) >= MASK_AGREE, name
