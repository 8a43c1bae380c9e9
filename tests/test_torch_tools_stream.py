"""The port's stream tools (``make_kitti_seq``, ``bench_stream_2761``,
``bench_stream``, ``bench_native_decode``) on the CPU at small sizes,
against the JAX side's scripts they stand in for.

* ``make_kitti_seq`` at 8 frames writes what ``tools/make_kitti_seq.py``
  writes for the same arguments: the JAX script's PNGs decoded with cv2,
  the port's with cv2 and with the native decoder, bit-equal; the poses
  equal as ``np.loadtxt`` reads them; ``scene.json`` equal.
* ``bench_stream_2761`` on a 40-frame loop root prints the JAX keys,
  writes its block checkpoint, and leaves ``BENCH_stream_2761.json`` and
  ``out/`` as they were (bytes and mtimes), and splits its post-pass by
  stage (``posegraph_split``: bank SIFT, retrieval, verification, graph,
  solves, recomposition) within 5% of its total.  The root is 192x320 with the
  scene's own K in place of KITTI's (``load_kitti`` carries KITTI-05's,
  which fits 376x1241 only): at 120x160 the loop world leaves the KLT
  bootstrap no landmarks.
* ``bench_stream`` and ``bench_native_decode`` print the JAX keys; the
  decode tool's disk trajectory equals the in-memory one bit for bit.
"""
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_torch.dataio import datasets, native_io
from monocular_visual_odometry_va4mr_torch.dataio import synthetic as tsyn
from monocular_visual_odometry_va4mr_torch.tools import (
    bench, bench_native_decode, bench_stream, bench_stream_2761, harness,
    make_kitti_seq)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = (120, 160)

STREAM_2761_KEYS = {"frames", "resolution", "block", "sustained_fps",
                    "wall_s", "lost", "recoveries", "ate_rmse_raw",
                    "ate_rmse_posegraph", "keyframes", "posegraph_wall_s",
                    "path_m", "ref_fps", "ref_ate", "ref_completed",
                    "ref_died_at", "ate_bound",
                    "healthy"}  # tools/bench_stream_2761.py:186-205
STREAM_KEYS = {"streamed_frames", "block", "sustained_fps", "lost",
               "ate_rmse", "path_m", "ref_ate", "ref_completed", "ate_bound",
               "healthy"}  # tools/bench_stream.py:107-117
DECODE_KEYS = {"decode_fps", "frames", "resolution", "device_rate_target_fps",
               "decode_keeps_up", "trajectory_identical",
               "max_pose_diff"}  # tools/bench_native_decode.py:122-130


def json_lines(text):
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Build outputs and the scene cache under ``tmp_path``; scenes
    rendered in this process."""
    monkeypatch.setattr(harness, "BUILD", tmp_path / "build")
    monkeypatch.setattr(tsyn, "SCENE_CACHE", tmp_path / "scene_cache")
    monkeypatch.setattr(harness, "render_frames",
                        lambda scene, n: [scene.render(i) for i in range(n)])
    torch.set_num_threads(2)
    return tmp_path


# --- make_kitti_seq ----------------------------------------------------------

def test_make_kitti_seq_writes_what_the_jax_script_writes(tmp_path):
    import cv2

    args = ["--frames", "8", "--shape", "120,160", "--laps", "0.03"]
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "tools/make_kitti_seq.py", "--out",
                    str(jax_root), "--workers", "1"] + args, cwd=ROOT,
                   env=env, check=True, capture_output=True, timeout=600)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert make_kitti_seq.main(["--device", "cpu", "--out",
                                    str(port_root), "--workers", "1"]
                                   + args) == 0
    (line,) = json_lines(buf.getvalue())
    assert line["rendered"] == 8 and line["skipped"] == 0
    for i in range(8):
        name = f"05/image_0/{i:06d}.png"
        ref = cv2.imread(str(jax_root / name), cv2.IMREAD_UNCHANGED)
        ours = cv2.imread(str(port_root / name), cv2.IMREAD_UNCHANGED)
        assert ref.dtype == ours.dtype == np.uint8 and ref.shape == SMALL
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(
            native_io.decode_png(str(port_root / name)), ref)
    np.testing.assert_array_equal(np.loadtxt(port_root / "poses/05.txt"),
                                  np.loadtxt(jax_root / "poses/05.txt"))
    assert (json.loads((port_root / "scene.json").read_text())
            == json.loads((jax_root / "scene.json").read_text()))
    # A second run resumes: every frame is there, none is rendered again.
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        make_kitti_seq.main(["--device", "cpu", "--out", str(port_root),
                             "--workers", "1"] + args)
    (line,) = json_lines(buf.getvalue())
    assert line["rendered"] == 0 and line["skipped"] == 8


def test_make_kitti_seq_truncates_as_the_jax_recipe():
    f = np.array([[-3.0, 0.4, 0.6, 254.9, 255.5, 300.0]], np.float32)
    np.testing.assert_array_equal(make_kitti_seq.to_uint8(f),
                                  [[0, 0, 0, 254, 255, 255]])


# --- bench_stream_2761 -------------------------------------------------------

LOOP_SHAPE = (192, 320)
LOOP_FRAMES = 40


def snapshot(paths):
    """(bytes, mtime) of every file under ``paths``."""
    out = {}
    for p in paths:
        files = [p] if p.is_file() else sorted(q for q in p.rglob("*")
                                               if q.is_file())
        for q in files:
            out[str(q)] = (q.read_bytes(), q.stat().st_mtime_ns)
    return out


@pytest.fixture(scope="module")
def stream_2761(tmp_path_factory):
    """The port's loop root (40 frames), then ``bench_stream_2761`` on it
    with its default output paths, moved under a temporary build
    directory; the JAX artifacts' bytes and mtimes around the run."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("stream2761")
    root = tmp / "kitti_loop"
    mp.setattr(harness, "BUILD", tmp / "build")
    torch.set_num_threads(2)
    guarded = [ROOT / "BENCH_stream_2761.json", ROOT / "out"]
    before = snapshot(guarded)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            make_kitti_seq.main([
                "--device", "cpu", "--out", str(root), "--frames",
                str(LOOP_FRAMES), "--shape", "192,320", "--laps", "0.03",
                "--workers", "2"])
            K = json.loads((root / "scene.json").read_text())["K"]
            mp.setattr(datasets, "KITTI_K", np.array(K))
            rc = bench_stream_2761.main([
                "--device", "cpu", "--root", str(root), "--block", "4"])
    finally:
        mp.undo()
    lines = json_lines(out.getvalue())
    return dict(rc=rc, line=lines[-1], build=tmp / "build", before=before,
                after=snapshot(guarded))


def test_bench_stream_2761_prints_the_jax_keys(stream_2761):
    line = stream_2761["line"]
    assert STREAM_2761_KEYS <= set(line)
    assert line["frames"] == LOOP_FRAMES - 9  # after the bootstrap 0..8
    assert line["resolution"] == list(LOOP_SHAPE) and line["block"] == 4
    assert all(line[k] is None for k in STREAM_2761_KEYS
               if k.startswith("ref_"))
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert line["tracker"] == "xla" and line["klt_lk_launches"] == 0
    assert line["steps"] >= line["frames"] and line["hops"] >= 8
    assert line["keyframes"] >= 3 and line["instep_ba"]
    assert line["ate_bound"] == pytest.approx(0.02 * line["path_m"])
    assert line["healthy"] == (stream_2761["rc"] == 0)
    with open(ROOT / "BENCH_stream_2761.json") as f:
        jax = json.load(f)
    assert {f"jax_{k}": v for k, v in jax.items()}.items() <= line.items()
    saved = json.loads((stream_2761["build"] / "stream_2761.json")
                       .read_text())
    assert saved == line


def test_bench_stream_2761_splits_the_post_pass(stream_2761):
    """The post-pass's seconds by stage (``posegraph_split``) add up to its
    total within 5%; the solves' parts lie within the solves' seconds, and
    the CPU captures and replays nothing."""
    line = stream_2761["line"]
    split = line["posegraph_split"]
    names = (bench_stream_2761.SPLIT_STAGES + bench_stream_2761.SPLIT_PARTS
             + bench_stream_2761.SPLIT_COUNTS)
    assert set(split) == set(names)
    assert split["bank_sift_s"] > 0 and all(split[k] >= 0 for k in names)
    stages = sum(split[k] for k in bench_stream_2761.SPLIT_STAGES)
    assert stages == pytest.approx(line["posegraph_wall_s"], rel=0.05)
    assert (split["solve_first_s"] + split["solve_loo_s"]
            + split["solve_final_s"]) <= split["solve_s"]
    assert split["captures"] == split["replays"] == 0
    assert split["capture_s"] == 0.0


def test_bench_stream_2761_writes_block_checkpoints(stream_2761):
    from monocular_visual_odometry_va4mr_torch.pipeline import checkpoint

    line = stream_2761["line"]
    ck = stream_2761["build"] / "stream2761_ck"
    assert (ck / "checkpoint.pt").is_file()
    # 31 frames in blocks of 4: a checkpoint after block 8, frame 9 + 31.
    assert line["blocks"] == 8 and line["checkpoints_written"] == 1
    assert line["checkpoint_frame"] == checkpoint.saved_frame(str(ck)) == 39


def test_bench_stream_2761_leaves_the_jax_artifacts_alone(stream_2761):
    assert stream_2761["before"]
    assert stream_2761["after"] == stream_2761["before"]
    dash = stream_2761["line"]["dashboard"]
    if dash is not None:  # drawn where matplotlib is installed
        assert pathlib.Path(dash).parent == stream_2761["build"]


# --- bench_stream, bench_native_decode ---------------------------------------

def test_bench_stream_lines(small, monkeypatch, capsys):
    monkeypatch.setattr(bench_stream, "IMAGE_SHAPE", SMALL)
    rc = bench_stream.main(["--device", "cpu", "--frames", "24",
                            "--block", "6"])
    (line,) = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    assert STREAM_KEYS <= set(line)
    assert line["streamed_frames"] == 24 - 5 - 6
    assert line["ref_ate"] is None and line["ref_completed"] is None
    assert line["device_ms_per_step"] is None and line["device"] == "cpu"
    assert rc == (0 if line["healthy"] else 2)


def narrow(preset):
    """``preset`` with 256-slot tables and 300 corners: the CPU's size."""
    def cfg():
        c = preset()
        return c.replace(
            capacity=dataclasses.replace(c.capacity, max_landmarks=256,
                                         max_candidates=256),
            detector=dataclasses.replace(c.detector, max_corners=300))
    return cfg


def test_bench_native_decode_lines(small, monkeypatch, capsys):
    from monocular_visual_odometry_va4mr_torch.core import config as tconfig

    monkeypatch.setattr(bench, "NUM_FRAMES", 16)
    monkeypatch.setattr(bench, "IMAGE_SHAPE", SMALL)
    monkeypatch.setattr(tconfig, "kitti_config",
                        narrow(tconfig.kitti_config))
    rc = bench_native_decode.main(["--device", "cpu", "--frames", "16"])
    (line,) = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    assert DECODE_KEYS <= set(line)
    assert line["frames"] == 16 and line["resolution"] == list(SMALL)
    assert line["trajectory_identical"] is True
    assert line["max_pose_diff"] == 0.0
    assert line["device_rate_target_fps"] > 0
    assert line["decode_keeps_up"] == (line["decode_fps"]
                                       >= line["device_rate_target_fps"])
    assert rc == (0 if line["decode_keeps_up"] else 2)
    # The written sequence is gone unless --keep.
    assert not list((small / "build").glob("kitti_synth_*"))
