"""The port's SIFT and descriptor matching against the JAX package's, on the
CPU, with the same numpy inputs made from a seed.

Image: uniform noise blurred with a numpy Gaussian (sigma 1.5), stretched to
[0, 255], 240x320, the texture of ``tests/test_sift.py`` made without cv2.

Tolerances of ``detect_and_compute`` (512 features, the reference's default
parameters): the same number of valid keypoints, paired one to one by
position (within 1e-2 px) and then by orientation (a secondary-orientation
keypoint shares its primary's position); paired positions within 1e-3 px
and scales within 1e-4.  Orientation and descriptor within 1e-4 for at
least 99% of the pairs; the rest within 1e-2.  The two packages blur in
another float32 summation order (half the pixels differ by an ulp), which
moves refined positions by up to ~5e-4 px; where an orientation histogram's
peak is flat, the parabolic peak fit turns that into up to ~2e-3 rad and the
rotated descriptor follows (measured: 2 of 512 keypoints).

The 2x resize is compared exactly on integer-valued images, where every
weight product and sum is exact in float32, so any summation order agrees
(on img / 255 the two differ by one rounding in a quarter of the pixels);
the 3x3x3 extrema exactly on any input.  ``match_ratio``: identical
``idx1`` and ``ok``, with and without ``cross_check``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from monocular_visual_odometry_va4mr_tpu.ops import match as jmatch
from monocular_visual_odometry_va4mr_tpu.ops import sift as jsift
from monocular_visual_odometry_va4mr_torch.ops import match as tmatch
from monocular_visual_odometry_va4mr_torch.ops import sift as tsift

torch.set_num_threads(1)

MAX_FEATURES = 512
PAIR_PX = 1e-2
POS_TOL = 1e-3
SCALE_TOL = 1e-4
ORIENT_TOL = 1e-4
DESC_TOL = 1e-4
TIGHT_SHARE = 0.99
LOOSE_TOL = 1e-2


def textured_image(rng, H=240, W=320):
    img = rng.uniform(0, 255, (H, W))
    x = np.arange(-5, 6)
    k = np.exp(-0.5 * (x / 1.5) ** 2)
    k /= k.sum()
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, img)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    return img.astype(np.float32)


@pytest.fixture(scope="module")
def features():
    img = textured_image(np.random.default_rng(5))
    jf = jsift.detect_and_compute(jnp.asarray(img), max_features=MAX_FEATURES)
    tf = tsift.detect_and_compute(torch.from_numpy(img),
                                  max_features=MAX_FEATURES)
    return ({k: np.asarray(v) for k, v in jf._asdict().items()},
            {k: v.numpy() for k, v in tf._asdict().items()})


def angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (a - b))))


def pair_features(j, t):
    """Index of the port's keypoint paired with each of the reference's
    valid keypoints: nearest orientation among those within PAIR_PX."""
    jv, tv = j["valid"], t["valid"]
    d = np.abs(j["uv"][jv][:, None] - t["uv"][tv][None]).max(-1)
    do = angle_diff(j["orientation"][jv][:, None],
                    t["orientation"][tv][None])
    cost = np.where(d < PAIR_PX, do, np.inf)
    assert np.all(np.isfinite(cost.min(1))), "a keypoint has no partner"
    return cost.argmin(1)


def test_same_keypoints_as_reference(features):
    j, t = features
    assert j["valid"].sum() == t["valid"].sum() > 300
    nn = pair_features(j, t)
    assert len(set(nn.tolist())) == len(nn), "pairing is not one to one"
    jv, tv = j["valid"], t["valid"]
    dpos = np.abs(j["uv"][jv] - t["uv"][tv][nn]).max(1)
    assert dpos.max() < POS_TOL
    np.testing.assert_allclose(t["scale"][tv][nn], j["scale"][jv], rtol=0,
                               atol=SCALE_TOL)
    np.testing.assert_allclose(t["score"][tv][nn], j["score"][jv], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("field", ["orientation", "desc"])
def test_orientations_and_descriptors_match_reference(features, field):
    j, t = features
    nn = pair_features(j, t)
    jv, tv = j["valid"], t["valid"]
    if field == "orientation":
        err = angle_diff(j["orientation"][jv], t["orientation"][tv][nn])
        tol = ORIENT_TOL
    else:
        err = np.abs(j["desc"][jv] - t["desc"][tv][nn]).max(1)
        tol = DESC_TOL
    assert np.mean(err <= tol) >= TIGHT_SHARE, np.sort(err)[-8:]
    assert err.max() <= LOOSE_TOL


def test_upsample_edge_weights_match_jax_resize():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (74, 106), "linear"))
    np.testing.assert_array_equal(tsift.upsample2x(torch.from_numpy(img)),
                                  ref)


def test_extrema_match_reduce_window():
    x = np.random.default_rng(1).normal(size=(5, 23, 31)).astype(np.float32)
    mx = lax.reduce_window(jnp.asarray(x), -jnp.inf, lax.max, (3, 3, 3),
                           (1, 1, 1), "SAME")
    mn = lax.reduce_window(jnp.asarray(x), jnp.inf, lax.min, (3, 3, 3),
                           (1, 1, 1), "SAME")
    tmx, tmn = tsift.extrema3(torch.from_numpy(x))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(mx))
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(mn))


@pytest.mark.parametrize("cross_check", [False, True])
def test_match_ratio_matches_reference(cross_check):
    rng = np.random.default_rng(2)
    d0 = rng.normal(size=(300, 128)).astype(np.float32)
    near = d0[rng.permutation(300)[:200]] + 0.3 * rng.normal(size=(200, 128))
    d1 = np.concatenate([near, rng.normal(size=(100, 128))]).astype(
        np.float32)
    d1[-1] = d1[-2]  # an exact tie for the nearest neighbour
    v0 = rng.uniform(size=300) < 0.9
    v1 = rng.uniform(size=300) < 0.9
    v1[-2:] = True
    d0[-1] = d1[-1] + 0.1 * rng.normal(size=128)
    v0[-1] = True
    j_idx, j_ok = jmatch.match_ratio(jnp.asarray(d0), jnp.asarray(v0),
                                     jnp.asarray(d1), jnp.asarray(v1),
                                     cross_check=cross_check)
    t_idx, t_ok = tmatch.match_ratio(torch.from_numpy(d0),
                                     torch.from_numpy(v0),
                                     torch.from_numpy(d1),
                                     torch.from_numpy(v1),
                                     cross_check=cross_check)
    assert np.asarray(j_ok).sum() > 50
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
