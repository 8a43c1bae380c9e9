"""The port's small public helpers against the JAX package's: ``masked_top_k``,
``world_to_cam``, ``scharr_gradients``, ``detect_corners_config`` and
``track_features_config``.

Inputs are made from a seed with numpy and fed to both.  Indices and
masks must be equal; float results agree to a few float32 ulps (rtol /
atol 1e-5), tracked positions to 1e-3 px, as in ``tests/test_torch_klt_xla.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_tpu.core import camera as jcam
from monocular_visual_odometry_va4mr_tpu.core import config as jconfig
from monocular_visual_odometry_va4mr_tpu.core import slots as jslots
from monocular_visual_odometry_va4mr_tpu.dataio import synthetic as jsynth
from monocular_visual_odometry_va4mr_tpu.ops import corners as jcorners
from monocular_visual_odometry_va4mr_tpu.ops import image as jimage
from monocular_visual_odometry_va4mr_tpu.ops import klt as jklt
from monocular_visual_odometry_va4mr_torch.core import camera as tcam
from monocular_visual_odometry_va4mr_torch.core import config as tconfig
from monocular_visual_odometry_va4mr_torch.core import slots as tslots
from monocular_visual_odometry_va4mr_torch.ops import corners as tcorners
from monocular_visual_odometry_va4mr_torch.ops import image as timage
from monocular_visual_odometry_va4mr_torch.ops import klt as tklt

torch.set_num_threads(1)


def tt(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,k,ties", [(64, 16, False), (40, 40, True),
                                      (300, 7, True)])
def test_masked_top_k(n, k, ties):
    rng = np.random.default_rng(n + k)
    scores = rng.normal(size=n).astype(np.float32)
    if ties:  # repeated scores: the order among them is lax.top_k's
        scores = np.round(scores * 2) / 2
    mask = rng.uniform(size=n) < 0.6
    jv, ji, jok = jslots.masked_top_k(jnp.asarray(scores), jnp.asarray(mask),
                                      k)
    tv, ti, tok = tslots.masked_top_k(tt(scores), tt(mask), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_world_to_cam():
    rng = np.random.default_rng(3)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(size=3)
    xyz = rng.normal(size=(5, 7, 3)).astype(np.float32) * 10
    ref = jcam.world_to_cam(jnp.asarray(T), jnp.asarray(xyz))
    out = tcam.world_to_cam(tt(T), tt(xyz))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(48, 64), (37, 91)])
def test_scharr_gradients(shape):
    img = np.random.default_rng(sum(shape)).uniform(
        0, 255, size=shape).astype(np.float32)
    for t, j in zip(timage.scharr_gradients(tt(img)),
                    jimage.scharr_gradients(jnp.asarray(img))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-4)


def scene_frames():
    scene = jsynth.make_textured_scene(seed=5, num_frames=3,
                                       image_shape=(96, 160), step=1.0)
    return [scene.render(i) for i in range(3)]


@pytest.mark.parametrize("preset", ["kitti", "parking"])
def test_detect_corners_config(preset):
    img = scene_frames()[0]
    jcfg = jconfig.PRESETS[preset]().detector
    tcfg = tconfig.PRESETS[preset]().detector
    j = jcorners.detect_corners_config(jnp.asarray(img), jcfg, border=6)
    t = tcorners.detect_corners_config(tt(img), tcfg, border=6)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-5,
                               atol=1e-5)


def test_track_features_config():
    f0, f1, _ = scene_frames()
    cfg_t = tconfig.kitti_config().klt
    cfg_j = jconfig.kitti_config().klt
    uv, _, valid = tcorners.detect_corners(tt(f0), max_corners=64,
                                           quality_level=0.01, cell=8)
    levels = 3
    jp0 = jimage.build_pyramid(jnp.asarray(f0), levels)
    jp1 = jimage.build_pyramid(jnp.asarray(f1), levels)
    tp0 = timage.build_pyramid(tt(f0), levels)
    tp1 = timage.build_pyramid(tt(f1), levels)
    jpts, jok, _ = jklt.track_features_config(
        jp0, jp1, jnp.asarray(uv.numpy()), jnp.asarray(valid.numpy()), cfg_j)
    tpts, tok, _ = tklt.track_features_config(tp0, tp1, uv, valid, cfg_t)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    both = tok.numpy()
    assert both.sum() > 20
    np.testing.assert_allclose(tpts.numpy()[both], np.asarray(jpts)[both],
                               atol=1e-3)
