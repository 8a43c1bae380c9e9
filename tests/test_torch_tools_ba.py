"""The port's BA tools (``profile_ba``, ``profile_branch``,
``profile_trigger``, ``diag_ba``, ``bench_ba_scaling``,
``traj_ba_convergence``) on the CPU at small sizes, against the JAX
side's scripts.

* The ``profile_*`` rows print with host ms (device fields ``None`` on the
  CPU); the trigger step runs the BA branch once, the skip step never.
* ``diag_ba`` finds every frame finite on the clean bench scene (100
  frames cut to 30 at 120x160, where ``kitti_config`` may lose track: the
  tool reads finiteness, not health).
* In gloo worlds of 1 and 2, the bytes ``multihost.COMM`` counted an
  iteration equal the JAX tool's analytic model (``bench_ba_scaling.py:87``
  and ``:132``) exactly for the window BA in both worlds and for the
  trajectory BA in the world of 2.  In a world of 1 the trajectory BA has
  no neighbour to send its halo to: it sends the 4-byte cost all-reduce
  alone, 128 bytes under the model, which counts the halo at every world
  size (the JAX ``ppermute`` of one device has an empty permutation too).
* ``traj_ba_convergence``'s centralised solution (80 Gauss-Newton
  iterations, damping 0.1, on ``global_window``) equals the JAX script's
  ``global_window`` solved by the JAX ``run_ba`` on the same inputs, within
  1e-3 m per camera centre (float32 over 80 iterations; measured ~1e-5).
"""
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_torch.core import config as tconfig
from monocular_visual_odometry_va4mr_torch.dataio import synthetic as tsyn
from monocular_visual_odometry_va4mr_torch.tools import (
    bench, bench_ba_scaling, diag_ba, harness, profile_ba, profile_branch,
    profile_trigger, traj_ba_convergence)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = (120, 160)
ROW_KEYS = {"case", "ms", "device_ms", "launches"}


def lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Small scenes rendered in this process, cached and built under
    ``tmp_path``; ``kitti_config`` at 120x160 with 256-slot tables."""
    monkeypatch.setattr(harness, "BUILD", tmp_path / "build")
    monkeypatch.setattr(tsyn, "SCENE_CACHE", tmp_path / "scene_cache")
    monkeypatch.setattr(harness, "render_frames",
                        lambda scene, n: [scene.render(i) for i in range(n)])
    kitti = tconfig.kitti_config

    def kitti_small():
        c = kitti()
        return c.replace(image_shape=SMALL, capacity=dataclasses.replace(
            c.capacity, max_landmarks=256, max_candidates=256),
            detector=dataclasses.replace(c.detector, max_corners=300))

    monkeypatch.setattr(tconfig, "kitti_config", kitti_small)
    torch.set_num_threads(2)
    return tmp_path


def test_profile_ba_rows(small, capsys):
    assert profile_ba.main(["--device", "cpu"]) == 0
    rows = lines(capsys)
    assert [r["case"] for r in rows] == [
        "run_ba", "run_ba", "build_normal_blocks", "solve_camera_system",
        "apply_updates", "run_ba"]
    assert [r.get("iters") for r in rows] == [2, 1, None, None, None, 2]
    assert [r["L"] for r in rows] == [256] * 5 + [1024]
    for r in rows:
        assert ROW_KEYS <= set(r) and r["ms"] > 0
        assert r["device_ms"] is None and r["launches"] is None
        assert r["device"] == "cpu"


def test_profile_ba_window_is_plausible():
    """The landmarks lie 5-60 m ahead, so nearly all are seen (1 m in
    front of the camera) in every frame; BA lowers the cost of the
    displaced landmarks."""
    from monocular_visual_odometry_va4mr_torch.backend import ba

    win, cam = profile_ba.make_window("cpu")
    assert win.obs_mask.float().mean() > 0.95
    _, costs = ba.run_ba(win, cam, iters=2, n_fixed=2)
    assert costs[-1] < costs[0]


def test_profile_branch_rows(small, capsys):
    assert profile_branch.main(["--device", "cpu"]) == 0
    rows = lines(capsys)
    assert [r["case"] for r in rows] == ["branch", "compaction", "run_ba"]
    cfg = tconfig.kitti_config().ba
    for r in rows:
        assert ROW_KEYS <= set(r) and r["ms"] > 0
        assert r["W"] == cfg.window and r["L"] == cfg.max_landmarks
        assert r["device_ms"] is None


def test_profile_trigger_rows(small, monkeypatch, capsys):
    host_ms = harness.host_ms
    monkeypatch.setattr(harness, "host_ms", lambda fn, device: host_ms(
        fn, device, reps=3, warmup=1))
    monkeypatch.setattr(profile_trigger, "NUM_FRAMES", 20)
    assert profile_trigger.main(["--device", "cpu"]) == 0
    rows = {r["case"]: r for r in lines(capsys)}
    assert list(rows) == ["step_trigger", "step_skip", "scan_ba_on",
                          "scan_ba_off", "step_ba_off"]
    assert rows["step_trigger"]["frame"] == 16
    assert rows["step_trigger"]["ba_runs_per_call"] == 1
    assert rows["step_skip"]["frame"] == 17
    assert rows["step_skip"]["ba_runs_per_call"] == 0
    assert rows["step_ba_off"]["ba_runs_per_call"] == 0
    for name in ("scan_ba_on", "scan_ba_off"):
        assert rows[name]["frames"] == profile_trigger.NUM_FRAMES - 14
        assert rows[name]["ms_per_frame"] > 0
        assert rows[name]["device_ms_per_frame"] is None
    for r in rows.values():
        assert r["device"] == "cpu"


def test_diag_ba_finds_a_clean_scene_finite(small, monkeypatch, capsys):
    monkeypatch.setattr(bench, "NUM_FRAMES", 30)
    monkeypatch.setattr(bench, "IMAGE_SHAPE", SMALL)
    assert diag_ba.main(["4", "30", "--device", "cpu"]) == 0
    (line,) = lines(capsys)
    assert line["every"] == 4 and line["frames"] == 30
    assert line["first_nonfinite_frame"] is None
    assert line["final_status"] in (0, 1)
    assert line["ba_runs"] >= 4  # frames 12, 16, 20, 24, 28 (window 10)


def test_diag_ba_window_stats():
    """The statistics of a state whose ring holds one tenant's
    observations: landmarks seen in >= min_obs rows are eligible."""
    from monocular_visual_odometry_va4mr_torch.core.state import init_state

    cfg = tconfig.PipelineConfig(
        capacity=tconfig.CapacityConfig(8, 8), image_shape=(32, 32),
        ba=tconfig.InStepBAConfig(every=4, window=4, min_obs=3))
    st = init_state(cfg, (torch.zeros(32, 32),))
    mask = torch.zeros_like(st.ba_mask)
    mask[:3, :5] = True
    st = st.replace(ba_mask=mask, lm_valid=torch.arange(8) < 4,
                    lm_xyz=torch.tensor([[0.0, 0.0, z] for z in range(2, 10)]))
    vo = type("VO", (), {"config": cfg})()
    w = diag_ba.window_stats(vo, st)
    assert w["eligible"] == 4 and w["n_obs_max"] == 3
    assert (w["depth_min"], w["depth_max"]) == (2.0, 5.0)
    assert w["prev_T_finite"] and w["lm_xyz_abs_max"] == 5.0


# --- the sharded BAs over process groups ------------------------------------

@pytest.fixture(scope="module")
def scaling_rows(tmp_path_factory):
    """``bench_ba_scaling`` in gloo worlds of 1 and 2 (small problems)."""
    import contextlib
    import io

    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "BUILD", tmp_path_factory.mktemp("scaling"))
    mp.setattr(bench_ba_scaling, "REPS", 1)
    mp.setattr(bench_ba_scaling, "WARMUP", 0)
    mp.setattr(bench_ba_scaling, "SEGMENT_LMS", 64)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert bench_ba_scaling.main([
                "--device", "cpu", "--worlds", "1,2", "--iters", "3",
                "--landmarks", "128"]) == 0
    finally:
        mp.undo()
    return [json.loads(s) for s in out.getvalue().splitlines()
            if s.startswith("{")]


def test_ba_scaling_counted_bytes_equal_the_jax_model(scaling_rows):
    jax = jax_tool("bench_ba_scaling")  # its model, written in its code
    W = 8
    lm_model = (W * W * 36 + W * 6 + 1) * 4
    kf_model = 2 * 16 * 4 + 4
    assert bench_ba_scaling.lm_model_bytes(W) == lm_model == 9412
    assert bench_ba_scaling.kf_model_bytes() == kf_model == 132
    assert "(W * W * 36 + W * 6 + 1) * 4" in open(jax.__file__).read()
    rows = {(r["sharding"], r["shards"]): r for r in scaling_rows
            if "sharding" in r}
    assert set(rows) == {("landmark", 1), ("landmark", 2), ("keyframe", 1),
                         ("keyframe", 2)}
    for n in (1, 2):
        r = rows["landmark", n]
        assert r["model_bytes_per_iter"] == lm_model
        assert r["counted_bytes_per_iter"] == lm_model
        assert r["comm_by_rank"] == [{f"all_reduce:{lm_model}": 3}] * n
    r = rows["keyframe", 2]
    assert r["counted_bytes_per_iter"] == r["model_bytes_per_iter"] == 132
    assert r["comm_by_rank"] == [{"send:128": 3, "all_reduce:4": 3},
                                 {"recv:128": 3, "all_reduce:4": 3}]
    # One segment has no neighbour: the cost all-reduce alone.
    r = rows["keyframe", 1]
    assert r["counted_bytes_per_iter"] == 4
    assert r["comm_by_rank"] == [{"all_reduce:4": 3}]
    # Op by op beside the run as it goes (both op by op on the CPU).
    for r in rows.values():
        assert r["replayed"] is False
        assert r["ms_per_iter"] > 0 and r["ms_per_iter_eager"] > 0


def test_ba_scaling_claims_no_efficiency(scaling_rows):
    for r in scaling_rows:
        assert r["multi_card_efficiency"] is None
        assert r["device"] == "cpu"
    for r in scaling_rows[:-1]:
        assert r["backend"] == "gloo" and r["ms_per_iter"] > 0
        assert r["ms_per_iter_unsharded"] > 0
    summary = scaling_rows[-1]
    assert summary["summary"] == "bench_ba_scaling"
    assert "no multi-card efficiency is claimed" in summary["note"]


def test_traj_ba_convergence_lines(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(harness, "BUILD", tmp_path)
    assert traj_ba_convergence.main([
        "--device", "cpu", "--worlds", "1,2", "--segment-kf", "4",
        "--landmarks", "96", "--max-iters", "16"]) == 0
    out = lines(capsys)
    keys = {"D", "kf", "iters_to_match_global", "traj_ba_gt_err",
            "global_gt_err", "dist_to_global"}  # traj_ba_convergence.py:97
    assert [r["D"] for r in out[:-1]] == [1, 2]
    for r in out[:-1]:
        assert keys <= set(r) and r["kf"] == 4 * r["D"]
        assert r["iters_to_match_global"] is not None
        assert r["timed_iters"] == r["iters_to_match_global"]
        assert r["replayed"] is False
        assert r["ms_per_iter"] > 0 and r["ms_per_iter_eager"] > 0
    assert out[-1]["iters_to_match_global"] == [
        r["iters_to_match_global"] for r in out[:-1]]


def test_centralised_solution_equals_the_jax_scripts():
    import jax.numpy as jnp

    from monocular_visual_odometry_va4mr_torch.parallel import traj_ba
    from monocular_visual_odometry_va4mr_tpu.backend import ba as jba
    from monocular_visual_odometry_va4mr_tpu.parallel import traj_ba as jtraj

    D, S, L = 2, 4, 64
    jnoisy, _, jcam = jtraj.build_synthetic_traj(D, S, L, seed=1)
    ref, _ = jba.run_ba(jax_tool("traj_ba_convergence").global_window(
        jnoisy, D, S, L), jcam, iters=80, n_fixed=2, damping=0.1)
    ref_pos = traj_ba_convergence.cam_positions(np.asarray(ref.T_CW))[2:]
    noisy = traj_ba.TrajSegments(*(torch.from_numpy(np.asarray(a))
                                   for a in jnoisy))
    _, _, cam = traj_ba.build_synthetic_traj(D, S, L, seed=1)
    # The same window first, then the same solution.
    ours = traj_ba_convergence.global_window(noisy, D, S, L)
    theirs = jax_tool("traj_ba_convergence").global_window(jnoisy, D, S, L)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pos = traj_ba_convergence.centralised(noisy, D, S, L, cam, device="cpu")
    np.testing.assert_allclose(pos, ref_pos, rtol=0, atol=1e-3)
    assert jnp.isfinite(ref.T_CW).all()
