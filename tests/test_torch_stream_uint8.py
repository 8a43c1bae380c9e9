"""The block driver on uint8 frames, the port's against the JAX package's,
on the CPU: the upload path a long stream takes (4x fewer bytes; the step
casts on the device, exactly).

Scene, config and draws: ``tests/test_torch_drivers.py``'s beacon corridor
(seed 3, 20 frames, 240x320, the gather tracker), its frames rounded to
uint8, blocks of 5 with a padded tail, recovery and landmark snapshots on,
each package from its own bootstrap on the same uint8 frames; the port draws
the reference's RANSAC banks (``JaxDraws``).  Tolerances: those of the
float-frame stream test there: the same frames, blocks, recoveries,
statuses and tracked counts; camera positions within 1e-3 of the path.
Then the port's uint8 stream against its own float32 stream of the same
rounded frames: bit-equal (the cast is exact).
"""
import jax
import numpy as np
import torch

from monocular_visual_odometry_va4mr_tpu.core import config as jconfig
from monocular_visual_odometry_va4mr_tpu.core.camera import Camera as JCamera
from monocular_visual_odometry_va4mr_tpu.pipeline import scan_driver as jscan
from monocular_visual_odometry_va4mr_tpu.pipeline.vo import (
    VisualOdometry as JVO)
from monocular_visual_odometry_va4mr_torch.dataio import synthetic
from monocular_visual_odometry_va4mr_torch.pipeline import runner, scan_driver
from test_torch_drivers import (SEED, STREAM_KW, STRIDE, JaxDraws, make_tvo,
                                small_config, stream_inputs)

torch.set_num_threads(1)

PATH_TOL = 1e-3


def positions(T_CW):
    return np.stack([-T[:3, :3].T @ T[:3, 3]
                     for T in np.asarray(T_CW, np.float64)])


def test_uint8_stream_matches_reference():
    scene = synthetic.make_corridor_scene(seed=3, num_frames=20,
                                          num_points=2500,
                                          image_shape=(240, 320), step=0.4)
    u8 = [np.clip(np.rint(synthetic.render_frame(scene, i)), 0,
                  255).astype(np.uint8) for i in range(scene.num_frames)]

    jvo = JVO(JCamera.from_matrix(scene.K), small_config(jconfig))
    key = jax.random.PRNGKey(SEED)
    j0 = jvo.bootstrap(u8[0], u8[STRIDE], jax.random.fold_in(key, 0),
                       intermediate=u8[1:STRIDE])
    _, jout, jids, jinfo = jscan.run_streaming(jvo, j0, stream_inputs(u8),
                                               key, **STREAM_KW)

    tvo = make_tvo(scene, JaxDraws())
    gen0 = runner.frame_generator(SEED, 0, "cpu")
    t0 = tvo.bootstrap(u8[0], u8[STRIDE], intermediate=u8[1:STRIDE],
                       generator=gen0)
    _, tout, tids, tinfo = scan_driver.run_streaming(
        tvo, t0, stream_inputs(u8), SEED, **STREAM_KW)

    assert tids == jids and tuple(tinfo) == tuple(jinfo)
    assert tinfo.lost == 0 and tinfo.recoveries == 0
    np.testing.assert_array_equal(tout.status, np.asarray(jout.status))
    np.testing.assert_array_equal(tout.n_tracked, np.asarray(jout.n_tracked))
    pj, pt = positions(jout.T_CW), positions(tout.T_CW)
    path = np.sum(np.linalg.norm(np.diff(pj, axis=0), axis=1))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PATH_TOL * path)

    # The same rounded frames streamed as float32: bit-equal.
    _, fout, _, _ = scan_driver.run_streaming(
        make_tvo(scene, JaxDraws()), t0,
        ((i, f.astype(np.float32)) for i, f in stream_inputs(u8)), SEED,
        **STREAM_KW)
    np.testing.assert_array_equal(fout.T_CW, tout.T_CW)
