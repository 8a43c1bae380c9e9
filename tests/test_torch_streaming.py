"""The port's drivers against themselves on the CPU: the block driver
against the Python loop, streaming block sizes, streaming recovery, resume
against the uninterrupted run, the CLI, and the entry points' default
device.

Scene and config: those of ``tests/test_torch_drivers.py`` (the beacon
corridor of ``tests/test_pipeline.py`` with its ``small_config``, the
gather tracker).  Tolerance: bit-equal where the same float32 operations
run in the same order (block driver and loop, block sizes, resume); the
recovery contract of ``tests/test_pipeline.py`` for the streaming blackout.
"""
import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_torch import run as tcli
from monocular_visual_odometry_va4mr_torch.core import config as tconfig
from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.core.state import STATUS_TRACKING
from monocular_visual_odometry_va4mr_torch.dataio import synthetic
from monocular_visual_odometry_va4mr_torch.pipeline import (
    checkpoint, runner, scan_driver)
from monocular_visual_odometry_va4mr_torch.pipeline.vo import VisualOdometry
from test_torch_drivers import BLACKOUT, SEED, STRIDE, make_tvo, small_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_corridor_scene(seed=3, num_frames=20,
                                         num_points=2500,
                                         image_shape=(240, 320), step=0.4)


@pytest.fixture(scope="module")
def frames(scene):
    return [synthetic.render_frame(scene, i) for i in range(scene.num_frames)]


@pytest.fixture(scope="module")
def blackout_frames(frames):
    return [np.zeros_like(f) if i in BLACKOUT else f
            for i, f in enumerate(frames)]


@pytest.fixture(scope="module")
def boot(scene, frames):
    """A port VO (its own draws) and its bootstrap over frames 0..2."""
    tvo = make_tvo(scene)
    state = tvo.bootstrap(frames[0], frames[STRIDE],
                          intermediate=frames[1:STRIDE],
                          generator=runner.frame_generator(SEED, 0, "cpu"))
    assert int(state.status) == STATUS_TRACKING
    return tvo, state


def gens(ids):
    return [runner.frame_generator(SEED, i, "cpu") for i in ids]


def test_scan_step_equals_the_python_loop(boot, frames):
    tvo, state = boot
    ids = list(range(STRIDE + 1, 10))
    s = state
    loop = []
    for i, g in zip(ids, gens(ids)):
        s = tvo.step(s, frames[i], generator=g)
        loop.append(s.T_CW.numpy())
    final, outs = scan_driver.run_block(tvo, state,
                                        np.stack([frames[i] for i in ids]),
                                        gens(ids))
    np.testing.assert_array_equal(outs.T_CW.numpy(), np.stack(loop))
    np.testing.assert_array_equal(final.T_CW.numpy(), loop[-1])
    assert final.frame_idx == s.frame_idx
    # Masked: inactive frames are identity steps; landmark snapshots.
    run = scan_driver.make_scan_step(tvo, emit_landmarks=True, masked=True)
    imgs = torch.from_numpy(np.stack([frames[i] for i in ids[:3]]
                                     + [frames[ids[2]]] * 2))
    final_m, outs_m = run(state, imgs, gens(ids[:3]) + [None, None],
                          [True] * 3 + [False] * 2)
    np.testing.assert_array_equal(outs_m.T_CW[:3].numpy(), np.stack(loop[:3]))
    np.testing.assert_array_equal(outs_m.T_CW[3:].numpy(),
                                  np.stack([loop[2]] * 2))
    assert final_m.frame_idx == state.frame_idx + 3
    assert outs_m.lm_z.shape == (5, tvo.config.capacity.max_landmarks)
    assert bool(outs_m.lm_valid[2].any())


def test_streaming_blocks_match_single_block(boot, frames):
    """Block sizes 4 (padded tail) and 9 (one block) give the same
    outputs; the final state is the one after the last real frame."""
    tvo, state = boot
    ids = list(range(STRIDE + 1, 12))
    outs = {}
    for block in (4, 9):
        final, o, fids, info = scan_driver.run_streaming(
            tvo, state, ((i, frames[i]) for i in ids), SEED, block=block)
        assert fids == ids and info.blocks == -(-len(ids) // block)
        assert final.frame_idx == state.frame_idx + len(ids)
        np.testing.assert_array_equal(final.T_CW.numpy(), o.T_CW[-1])
        outs[block] = o
    for f in scan_driver.ScanOutputs._fields:
        np.testing.assert_array_equal(getattr(outs[4], f),
                                      getattr(outs[9], f))
    assert np.all(outs[4].status == 0)
    # uint8 frames stream as uint8; a float frame in that stream raises.
    u8 = [(i, frames[i].astype(np.uint8)) for i in ids[:3]]
    scan_driver.run_streaming(tvo, state, u8, SEED, block=2)
    with pytest.raises(ValueError, match="uint8 stream"):
        scan_driver.run_streaming(tvo, state, u8 + [(ids[3], frames[ids[3]])],
                                  SEED, block=2)


def test_streaming_blackout_recovery(scene, blackout_frames):
    """tests/test_pipeline.py's streaming blackout test on the port."""
    tvo = make_tvo(scene)
    state0 = tvo.bootstrap(blackout_frames[0], blackout_frames[STRIDE],
                           intermediate=blackout_frames[1:STRIDE],
                           generator=runner.frame_generator(SEED, 0, "cpu"))
    ids = range(STRIDE + 1, len(blackout_frames))
    final, outs, fids, info = scan_driver.run_streaming(
        tvo, state0, ((i, blackout_frames[i]) for i in ids), SEED, block=5,
        recover=True, bootstrap_stride=STRIDE, emit_landmarks=True)
    statuses = list(outs.status)
    assert info.lost > 0 and info.recoveries >= 1
    assert int(final.status) == 0 and all(s == 0 for s in statuses[-4:])
    pos = np.stack([-t[:3, :3].T @ t[:3, 3] for t in outs.T_CW])
    good = [i for i, s in enumerate(statuses) if s == 0]
    pre = [i for i in good if fids[i] < 8]
    post = [i for i in good if fids[i] > 11]
    pre_steps = np.linalg.norm(np.diff(pos[pre], axis=0), axis=1)
    post_steps = np.linalg.norm(np.diff(pos[post][1:], axis=0), axis=1)
    ratio = np.median(post_steps) / max(np.median(pre_steps), 1e-9)
    assert 0.4 < ratio < 2.5, (ratio, pre_steps, post_steps)


def test_resume_repeats_the_uninterrupted_run(tmp_path, scene, frames):
    kw = dict(bootstrap_stride=STRIDE, ba_every=4, ba_window=6)
    full = runner.run_sequence(make_tvo(scene), enumerate(frames),
                               checkpoint_dir=str(tmp_path),
                               checkpoint_every=10, **kw)
    assert checkpoint.latest_frame(str(tmp_path)) == 10
    resumed = runner.run_sequence(make_tvo(scene), enumerate(frames),
                                  resume_from=str(tmp_path), **kw)
    assert [r.frame for r in resumed.records] == [r.frame
                                                  for r in full.records]
    np.testing.assert_array_equal(resumed.positions, full.positions)


def test_interrupted_checkpoint_leaves_the_previous_one(tmp_path, boot,
                                                        frames, monkeypatch):
    """A save cut off mid-write (here: after part of its bytes) leaves the
    previous checkpoint whole: its state, frame index and records belong
    together."""
    tvo, state = boot
    later = tvo.step(state, frames[STRIDE + 1],
                     generator=runner.frame_generator(SEED, STRIDE + 1, "cpu"))
    rec = [runner.FrameRecord(STRIDE, np.eye(4), 10, 12, 0, 1.5)]
    checkpoint.save(str(tmp_path), state, STRIDE, records=rec)

    def cut_off(obj, f):
        f.write(b"\x80\x02partial")
        raise KeyboardInterrupt

    with monkeypatch.context() as m:
        m.setattr(checkpoint.torch, "save", cut_off)
        with pytest.raises(KeyboardInterrupt):
            checkpoint.save(str(tmp_path), later, STRIDE + 1,
                            records=rec + rec)
    assert checkpoint.latest_frame(str(tmp_path)) == STRIDE
    restored, at = checkpoint.restore(str(tmp_path), later)
    assert at == STRIDE and restored.frame_idx == state.frame_idx
    assert torch.equal(restored.T_CW, state.T_CW)
    assert len(checkpoint.restore_aux(str(tmp_path))[0]) == 1
    # The next whole save replaces it, leftovers of the cut one aside.
    checkpoint.save(str(tmp_path), later, STRIDE + 1)
    restored, at = checkpoint.restore(str(tmp_path), later)
    assert at == STRIDE + 1 and torch.equal(restored.T_CW, later.T_CW)
    assert checkpoint.restore_aux(str(tmp_path))[:2] == (None, None)


def test_entry_points_default_to_cuda(scene):
    vo = VisualOdometry(Camera.from_matrix(scene.K),
                        small_config(tconfig, scene.image_shape))
    assert vo.device.type == "cuda"
    assert tcli.build_parser().parse_args(
        ["--dataset", "synthetic"]).device == "cuda"
    with pytest.raises(ValueError, match="window 15"):
        VisualOdometry(Camera.from_matrix(scene.K), small_config(
            tconfig, scene.image_shape).replace(klt=tconfig.KLTConfig(
                window=11, backend="pallas")), "cpu")


def test_cli_synthetic_run_ends_with_ate(capsys, tmp_path):
    metrics = tmp_path / "m.jsonl"
    plot = tmp_path / "x.png"
    res = tcli.main(["--dataset", "synthetic", "--max-frames", "9",
                     "--device", "cpu", "--quiet", "--ba-every", "4",
                     "--metrics-json", str(metrics), "--plot", str(plot)])
    out = capsys.readouterr().out
    assert "ATE RMSE (Sim3-aligned)" in out and "LOST frames: 0" in out
    assert res.num_lost() == 0 and len(res.records) == 9 - 6
    assert len(metrics.read_text().splitlines()) == 3
    assert plot.stat().st_size > 10000
    # A real dataset reads --data-root (default ./data/<dataset>).
    with pytest.raises(FileNotFoundError, match="kitti"):
        tcli.main(["--dataset", "kitti", "--data-root",
                   str(tmp_path / "kitti"), "--device", "cpu"])
