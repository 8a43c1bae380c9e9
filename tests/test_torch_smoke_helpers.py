"""The helpers ``chip_smoke.py``'s realism-stress phase gates with, on the
CPU: ``CpuDraws`` draws what the call's own CPU generator would, and
``replay`` of a ``step_loop`` on the device it ran on changes nothing.  On
the card the same helpers hold each card step against the CPU's."""
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
from monocular_visual_odometry_va4mr_torch.core.camera import (  # noqa: E402
    Camera)
from monocular_visual_odometry_va4mr_torch.ops import ransac  # noqa: E402
from monocular_visual_odometry_va4mr_torch.pipeline import (  # noqa: E402
    runner)
from monocular_visual_odometry_va4mr_torch.pipeline.vo import (  # noqa: E402
    VisualOdometry)


def test_cpu_draws_equal_the_call_generators_own():
    valid = torch.from_numpy(np.random.default_rng(0).random(300) < 0.7)
    draws = chip_smoke.CpuDraws()
    for seed, stream in ((0, 5), (3, 17), (2**31 - 1, 10_000_042)):
        gen = runner.frame_generator(seed, stream, "cpu")
        ref = runner.frame_generator(seed, stream, "cpu")
        for n, k in ((500, 4), (64, 5)):  # two banks from one call
            idx, ok = draws(gen, valid, n, k)
            ridx, rok = ransac.sample_minimal_sets(ref, valid, n, k)
            assert torch.equal(idx, ridx) and torch.equal(ok, rok)


def test_replay_on_the_same_device_changes_no_step():
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic
    from test_torch_parallel import small_config

    scene = synthetic.make_corridor_scene(seed=1, num_frames=10,
                                          num_points=2000,
                                          image_shape=(160, 224), step=0.5)
    frames = [synthetic.render_frame(scene, i) for i in range(10)]
    vo = VisualOdometry(Camera.from_matrix(scene.K),
                        small_config((160, 224)), "cpu",
                        sampler=chip_smoke.CpuDraws())
    run = chip_smoke.step_loop(vo, frames, 4, 2, keep_states=True)
    ids, pos, stat, _, _, states = run
    assert ids == list(range(2, 10)) and len(states) == 7
    solo = runner.run_sequence(vo, enumerate(frames), seed=4,
                               bootstrap_stride=2, recover=False)
    np.testing.assert_array_equal(pos, solo.positions)
    assert stat == [r.status for r in solo.records]
    rep = chip_smoke.replay(vo, frames, 4, run)
    assert rep["steps"] == 7 and rep["max_step_m"] == 0.0
    assert not (rep["steps_inliers_differ"] or rep["steps_tracked_differ"]
                or rep["steps_status_differ"] or rep["most_changed"])
