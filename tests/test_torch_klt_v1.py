"""The port's v1 LK tracker (``klt.backend="pallas"``: the plain version of
``csrc/klt_v1.cu`` and ``track_features_pallas``) against the JAX package's
``track_features_pallas`` in interpret mode.

Inputs are made from a seed with numpy and fed to both.  On the CPU the
port's kernel wrapper runs its plain version; the CUDA kernel itself is held
against that in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances, on every feature with no exempt set: ok masks equal; positions
of the accepted features within 1e-3 px, residuals within 1e-4 relative and
1e-3 absolute.  Both compute the same float32 function and differ only in
summation order (measured max ~3e-5 px), the /4 -> full-res chain
included.

The reference kernel rolls its 24 template rows and its 256 slab columns
circularly, so the upward gradient of window row 0 reads slab row
``yi + 23`` when the template's slab row ``yi`` is a multiple of 8 (about 1
feature in 8), and the leftward gradient of window column 0 reads slab
column 255 when ``xi == 0`` (a template more than 8 px left of the image).
The port reads the same rows and columns; ``template_sub0`` finds the first
kind, and the tests assert that they meet some.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_tpu.ops import image as jimops
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas as jv1
from monocular_visual_odometry_va4mr_tpu.ops import klt_pallas2 as jk2
from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as tv1
from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as tk2

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


def template_sub0(prev_pyr, next_pyr, pts, valid, prior):
    """Features whose template row offset ``sub`` is 0 (the port's slab
    arithmetic on the port's prediction)."""
    H, W = prev_pyr[0].shape
    if prior is None:
        ca, cb = prev_pyr[min(4, len(prev_pyr) - 1)], next_pyr[
            min(4, len(next_pyr) - 1)]
        scale = float(round(H / ca.shape[0]))
        flow = tv1.coarse_flow_volume(tt(ca), tt(cb))
        prior = (tv1.sample_map_onehot(flow, tt(pts) / scale) * scale).numpy()
    q = pts + prior
    meta = tt(np.stack([pts[:, 1], pts[:, 0], q[:, 1], q[:, 0],
                        valid.astype(np.float32)], 1).astype(np.float32))
    _, _, yi, _ = tv1.slab_geometry(meta, H, W)
    return (yi % 8 == 0).numpy()


def run_both(prev_pyr, next_pyr, pts, valid, **kw):
    prior = kw.pop("prior", None)
    jout = jv1.track_features_pallas(
        tuple(jnp.asarray(p) for p in prev_pyr),
        tuple(jnp.asarray(p) for p in next_pyr), jnp.asarray(pts),
        jnp.asarray(valid), interpret=True,
        prior=None if prior is None else jnp.asarray(prior), **kw)
    tout = tv1.track_features_pallas(
        tuple(tt(p) for p in prev_pyr), tuple(tt(p) for p in next_pyr),
        tt(pts), tt(valid), prior=None if prior is None else tt(prior), **kw)
    sub0 = template_sub0(prev_pyr, next_pyr, pts, valid, prior)
    return ([np.asarray(a) for a in jout], [a.numpy() for a in tout], sub0)


def assert_parity(jout, tout, valid):
    pj, okj, rj = jout
    pt, okt, rt = tout
    assert okj.sum() > 0, "no feature tracked"
    np.testing.assert_array_equal(okt, okj)
    err = np.abs(pj - pt).max(1)[okj]
    assert np.all(err < POS_TOL_PX), err.max()
    np.testing.assert_allclose(rt[okj], rj[okj], rtol=1e-4, atol=1e-3)
    assert not okt[~valid].any()


def pyramids(img0, img1, levels=5):
    return (tuple(np.asarray(p) for p in jimops.build_pyramid(
        jnp.asarray(img0), levels)),
            tuple(np.asarray(p) for p in jimops.build_pyramid(
                jnp.asarray(img1), levels)))


@pytest.mark.parametrize("dx,dy,min_ok", [(3.7, -2.3, 90), (37.0, 11.0, 50)])
def test_translation_through_coarse_prior(rng, dx, dy, min_ok):
    """Small and large translations, the prior from the /16 volume."""
    img0 = texture(rng)
    pyr0, pyr1 = pyramids(img0, shifted(img0, dx, dy))
    pts = np.stack([rng.uniform(20, 290, 128), rng.uniform(20, 210, 128)],
                   1).astype(np.float32)
    valid = np.ones(128, bool)
    jout, tout, sub0 = run_both(pyr0, pyr1, pts, valid, num_iters=8)
    assert_parity(jout, tout, valid)
    assert (sub0 & tout[1]).sum() > 5  # the row wrap, on tracked features
    ok = tout[1]
    assert ok.sum() > min_ok
    err = np.linalg.norm(tout[0][ok] - pts[ok] - [dx, dy], axis=1)
    assert np.median(err) < 0.2


@pytest.mark.parametrize("backward", [False, True])
def test_explicit_prior_and_backward_call(rng, backward):
    """An explicit prior, and the forward-backward check's backward call:
    planes swapped (template = the next frame), prior = -forward flow."""
    img0 = texture(rng)
    img1 = shifted(img0, 2.6, -1.2)
    pyr0, pyr1 = pyramids(img0, img1)
    pts = np.stack([rng.uniform(20, 300, 128), rng.uniform(20, 220, 128)],
                   1).astype(np.float32)
    flow = np.float32([2.6, -1.2])
    noise = rng.normal(0, 1.5, (128, 2)).astype(np.float32)
    valid = rng.uniform(size=128) < 0.9
    if backward:
        pts = pts + flow
        args = (pyr1, pyr0, pts, valid)
        prior = -flow + noise
    else:
        args = (pyr0, pyr1, pts, valid)
        prior = flow + noise
    jout, tout, _ = run_both(*args, num_iters=4, prior=prior)
    assert_parity(jout, tout, valid)
    assert tout[1].sum() > 60


def test_invalid_and_nan_slots(rng):
    img0 = texture(rng, 120, 160)
    pyr0, pyr1 = pyramids(img0, shifted(img0, 1.5, 0.5), 4)
    pts = np.stack([rng.uniform(20, 140, 16), rng.uniform(20, 100, 16)],
                   1).astype(np.float32)
    valid = np.ones(16, bool)
    valid[[3, 4, 9]] = False
    pts[3] = np.nan  # invalid slots may hold garbage
    pts[4] = [np.nan, 40.0]
    prior = np.tile(np.float32([1.5, 0.5]), (16, 1))
    prior[9] = np.nan
    jout, tout, _ = run_both(pyr0, pyr1, pts, valid, num_iters=5,
                             prior=prior)
    assert_parity(jout, tout, valid)
    assert tout[1][valid].sum() >= 10
    assert not tout[1][~valid].any()


def test_template_clipped_by_the_slab(rng):
    """A prediction far above (or left of) the template moves the slab base
    with it; the template origin is then clipped to the slab and the window
    read there, as the reference does."""
    img0 = texture(rng)
    pyr0, pyr1 = pyramids(img0, shifted(img0, 0.0, 0.0))
    n = 16
    pts = np.stack([rng.uniform(60, 300, n), rng.uniform(80, 220, n)],
                   1).astype(np.float32)
    prior = np.zeros((n, 2), np.float32)
    prior[: n // 2, 1] = -40.0  # predicted 40 px above the template
    prior[n // 2:, 0] = -200.0  # predicted 200 px to its left
    pts[n // 2:, 0] = rng.uniform(260, 310, n // 2)
    valid = np.ones(n, bool)
    q = pts + prior
    meta = tt(np.stack([pts[:, 1], pts[:, 0], q[:, 1], q[:, 0],
                        valid.astype(np.float32)], 1).astype(np.float32))
    y0, x0, yi, xi = tv1.slab_geometry(meta, *img0.shape)
    ty = pts[:, 1] - 7 - (y0.numpy() - 16)
    tx = pts[:, 0] - 7 - (x0.numpy() - 16)
    clipped = (np.floor(ty) != yi.numpy()) | (np.floor(tx) != xi.numpy())
    assert clipped.all()
    jout, tout, _ = run_both(pyr0, pyr1, pts, valid, num_iters=6,
                             prior=prior)
    err = np.abs(jout[0] - tout[0]).max(1)
    assert np.all(err < POS_TOL_PX), err.max()
    np.testing.assert_array_equal(tout[1], jout[1])
    np.testing.assert_allclose(tout[2], jout[2], rtol=1e-4, atol=1e-3)


def test_track_multilevel_with_the_v1_tracker(rng):
    """The /16 prior -> /4 LK -> full-res LK chain with track_fn = the v1
    tracker, on flat pyramids, against the reference chain."""
    img0 = texture(rng, 192, 320)
    img1 = shifted(img0, 9.5, 3.25)
    jp0 = jimops.build_flat_pyramid(jnp.asarray(img0), 16, 4)
    jp1 = jimops.build_flat_pyramid(jnp.asarray(img1), 16, 4)
    pts = np.stack([rng.uniform(20, 300, 128), rng.uniform(20, 170, 128)],
                   1).astype(np.float32)
    valid = np.ones(128, bool)
    kw = dict(num_iters=6, mid_iters=0, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    pj, okj, _ = (np.asarray(a) for a in jk2.track_multilevel(
        jp0, jp1, jnp.asarray(pts), jnp.asarray(valid),
        track_fn=jv1.track_features_pallas, interpret=True, **kw))
    pt, okt, _ = (a.numpy() for a in tk2.track_multilevel(
        tuple(tt(p) for p in jp0), tuple(tt(p) for p in jp1), tt(pts),
        tt(valid), track_fn=tv1.track_features_pallas, **kw))
    # About 1 feature in 8 per pass meets the reference's row wrap.
    np.testing.assert_array_equal(okt, okj)
    err = np.abs(pj - pt).max(1)[okt]
    assert okt.sum() > 60
    assert np.all(err < POS_TOL_PX), err.max()
    assert np.median(np.linalg.norm(pt[okt] - pts[okt] - [9.5, 3.25],
                                    axis=1)) < 0.1


def wrap_probe(img0, img1, py):
    """One feature at (160.4, py) searched at +(2.2, 1.3), in 8 slots."""
    pts = np.tile(np.float32([160.4, py]), (8, 1))
    valid = np.zeros(8, bool)
    valid[0] = True
    prior = np.tile(np.float32([2.2, 1.3]), (8, 1))
    pyr0, pyr1 = (img0,), (img1,)
    jout, tout, sub0 = run_both(pyr0, pyr1, pts, valid, num_iters=8,
                                prior=prior)
    jmeta = tt(np.float32([[py, 160.4, py + 1.3, 162.6, 1.0]]))
    return jout, tout, int(tv1.slab_geometry(jmeta, *img0.shape)[2][0])


@pytest.mark.parametrize("py,wrapped", [(103.3, True), (100.3, False),
                                        (104.3, False)])
def test_reference_template_row_wrap(rng, py, wrapped):
    """The reference's row wrap, followed: at py = 103.3 the template's slab
    row is yi = 8 (sub = 0) and its template rows are image rows 96..110,
    yet its upward gradient of row 0 reads image row 119 (the slab base is
    image row 88, and yi + 23 = 31).  Adding 500 to that row of the
    TEMPLATE plane moves the reference's result, and the port's with it.
    Controls at py = 100.3 (sub = 5) and 104.3 (sub = 1): neither moves."""
    img0 = texture(rng)
    img1 = shifted(img0, 2.2, 1.3)
    jout, tout, yi = wrap_probe(img0, img1, py)
    assert (yi % 8 == 0) == wrapped
    bumped = img0.copy()
    bumped[119] += 500.0
    jout_b, tout_b, _ = wrap_probe(bumped, img1, py)
    assert jout[1][0] and tout[1][0]
    for j, t in ((jout, tout), (jout_b, tout_b)):
        np.testing.assert_allclose(t[0][0], j[0][0], rtol=0, atol=POS_TOL_PX)
        assert t[1][0] == j[1][0]
    moved = np.abs(jout[0][0] - jout_b[0][0]).max()
    moved_t = np.abs(tout[0][0] - tout_b[0][0]).max()
    if wrapped:
        assert moved > 1e-3 and moved_t > 1e-3, (moved, moved_t)
    else:
        assert moved == 0.0 and moved_t == 0.0


@pytest.mark.parametrize("px,wrapped", [(-9.6, True), (-7.6, False)])
def test_reference_template_column_wrap(rng, px, wrapped):
    """The reference's column wrap, followed: a template at px = -9.6 has
    slab column xi = 0 (the slab base is clipped to image column -16), so
    its leftward gradient of window column 0 reads slab column 255, image
    column 239, not column -17 clamped to 0.  Adding 500 to image column
    239 of the TEMPLATE plane moves the reference's result, and the
    port's with it.  Control at px = -7.6 (xi = 1): neither moves.  Such a
    feature is rejected (its window lies off the image), so the outputs
    compared are positions and residuals.  The control's window reads image
    column 0 for all but its last column, so its structure tensor is near
    singular and its position amplifies the summation order (0.55 px
    between the packages, measured): only that it does not move is held
    there."""
    img0 = texture(rng)
    img1 = shifted(img0, 2.2, 1.3)
    pts = np.tile(np.float32([px, 120.3]), (8, 1))
    valid = np.ones(8, bool)
    prior = np.tile(np.float32([20.2, 1.3]), (8, 1))
    meta = tt(np.float32([[120.3, px, 121.6, px + 20.2, 1.0]]))
    xi = int(tv1.slab_geometry(meta, *img0.shape)[3][0])
    assert (xi == 0) == wrapped
    outs = []
    for tmpl in (img0, img0 + 500.0 * (np.arange(320) == 239)):
        jout, tout, _ = run_both((tmpl.astype(np.float32),), (img1,), pts,
                                 valid, num_iters=8, prior=prior)
        np.testing.assert_array_equal(tout[1], jout[1])
        if wrapped:
            np.testing.assert_allclose(tout[0], jout[0], rtol=0,
                                       atol=POS_TOL_PX)
            np.testing.assert_allclose(tout[2], jout[2], rtol=1e-4,
                                       atol=1e-3)
        outs.append((jout, tout))
    (j0, t0), (j1, t1) = outs
    moved = np.abs(j0[0] - j1[0]).max()
    moved_t = np.abs(t0[0] - t1[0]).max()
    if wrapped:
        assert moved > 1e-3 and moved_t > 1e-3, (moved, moved_t)
    else:
        assert moved == 0.0 and moved_t == 0.0


def test_kernel_wrapper_checks_its_inputs():
    img = torch.zeros(32, 48)
    meta = torch.zeros(8, tv1.META_COLS)
    kw = dict(num_iters=4, eps=0.01, min_eig_threshold=1e-4,
              max_residual=20.0)
    with pytest.raises(ValueError, match="N % 8"):
        tv1.klt_v1(img, img, meta[:6], **kw)
    with pytest.raises(ValueError, match="N % 8"):
        tv1.track_features_pallas((img,), (img,), torch.zeros(12, 2),
                                  torch.ones(12, dtype=torch.bool),
                                  prior=torch.zeros(12, 2), **kw)
    with pytest.raises(ValueError, match="fixed at 15"):
        tv1.track_features_pallas((img,), (img,), torch.zeros(8, 2),
                                  torch.ones(8, dtype=torch.bool),
                                  prior=torch.zeros(8, 2), win=11, **kw)
    with pytest.raises(TypeError):
        tv1.klt_v1(img.double(), img.double(), meta, **kw)
    with pytest.raises(ValueError):
        tv1.klt_v1(img, img[:, :40], meta, **kw)
    with pytest.raises(ValueError):
        tv1.klt_v1(img, img, meta[:, :4], **kw)
    before = tv1.klt_v1.launches
    out = tv1.klt_v1(img, img, meta, **kw)  # CPU: the plain version
    assert out.shape == (8, tv1.OUT_COLS) and tv1.klt_v1.launches == before


@pytest.mark.parametrize("path,left,clipped", [
    ("sideways_20_px_a_round", 2, False),
    ("sideways_3_px_a_round", 1, False),
    ("one_12_px_step_down", 1, False),
    ("up_20_px_a_round_into_the_slab_clip", 1, True)])
def test_search_boxes_follow_the_kernel_staging(path, left, clipped):
    """Hand-made paths of offsets through ``kernel_ab.search_boxes``, the
    replay of ``csrc/klt_v1.cu``'s staging: the first box reaches +-8 px,
    the wide box staged on leaving it 40 px ahead of the window."""
    import kernel_ab

    H, W = 376, 1241
    p = torch.tensor([[200.5, 600.5]])  # [y, x]
    meta = torch.cat([p, p, torch.ones(1, 1)], 1)
    k = torch.arange(7.0)
    zero = torch.zeros(7)
    g = {"sideways_20_px_a_round": torch.stack([20 * k, zero], 1),
         "sideways_3_px_a_round": torch.stack([3 * k, zero], 1),
         "one_12_px_step_down": torch.stack([zero, 12.0 * (k > 0)], 1),
         "up_20_px_a_round_into_the_slab_clip": torch.stack([zero, -20 * k],
                                                            1)}[path]
    got_left, got_clipped = kernel_ab.search_boxes(
        meta, [g[i:i + 1] for i in range(7)], H, W)
    assert got_left.tolist() == [left]
    assert got_clipped.tolist() == [clipped]
