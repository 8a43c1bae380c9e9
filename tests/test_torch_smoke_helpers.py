"""The helpers ``chip_smoke.py``'s realism-stress phase gates with, on the
CPU: ``CpuDraws`` draws what the call's own CPU generator would, and
``replay`` of a ``step_loop`` on the device it ran on changes nothing.  On
the card the same helpers hold each card step against the CPU's."""
import dataclasses
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


def test_lockstep_phase_on_the_cpu(monkeypatch):
    """Phase E's ``lockstep`` rehearsed on the CPU: the card's clocks and
    profiler stubbed, ``klt_lk`` counted where the tracker calls it (once
    per batched call, as the kernel launches once for the batch).  Every
    sequence equals itself in a batch of one and its solo run (on the CPU
    both take the CPU's forms, core/linalg.py), so its ATE is the solo
    run's, and the launch count is the batched step's."""
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from test_torch_parallel import small_config

    scenes = [synthetic.make_corridor_scene(seed=s, num_frames=9,
                                            num_points=2000,
                                            image_shape=(160, 224), step=0.5)
              for s in (1, 2, 3)]
    seqs = [[synthetic.render_frame(sc, i) for i in range(9)]
            for sc in scenes]
    cfg = small_config((160, 224))
    cfg = cfg.replace(klt=dataclasses.replace(cfg.klt, backend="pallas2"))
    vo = VisualOdometry(Camera.from_matrix(scenes[0].K), cfg, "cpu")
    lk = k2.klt_lk

    def counted(*a, **kw):
        counted.launches += 1
        return lk(*a, **kw)

    counted.launches = 0
    monkeypatch.setattr(k2, "klt_lk", counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "profile_calls",
                        lambda fn, reps=3: (fn(), (1.0, 100.0, 10.0))[1])
    monkeypatch.setattr(chip_smoke, "BOOTSTRAP_STRIDE", 2)
    res = chip_smoke.lockstep(vo, seqs, [(sc, 0) for sc in scenes])
    assert res["ok"] and res["sequences"] == 3
    assert res["batched_steps"] == 6
    assert res["launches"] == res["launches_expected"] == 3 * (6 + 3 * 2)
    assert res["launches_per_batched_step"] == 3.0
    for s in range(3):
        seq = res[f"seq{s}"]
        assert seq["statuses_equal"] and seq["pos_diff"] == 0.0
        assert seq["solo"]["pos_diff"] == 0.0
        assert seq["finite"] and seq["ate"] == seq["solo"]["ate"]
