"""The port's measuring tools (``monocular_visual_odometry_va4mr_torch/tools``)
on the CPU at small sizes, against the JAX side's scripts they stand in for.

Each tool's ``main`` runs with ``--device cpu`` on a 120x160 scene (20
frames where it renders a sequence) and must print JSON lines carrying the
keys of its JAX counterpart's output; those key lists are written here
from the JAX scripts (``bench.py``, ``tools/bench_datasets.py``,
``tools/profile_step.py``, ``tools/diag_tracker.py``,
``tools/stress_klt_motion.py``).  On the CPU the trackers run the plain
versions and every device metric is ``None``.

Also: the health gate's arithmetic on crafted trajectories (the port's ATE
equal to the JAX one, to 1e-12 m), the ground-truth flow of the tracker A/B
equal to the JAX tool's to 1e-6 px, and the motion stress's yaw frames
bit-equal to the JAX tool's recipe at a reduced size.
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
from monocular_visual_odometry_va4mr_torch.evalx import ate as tate
from monocular_visual_odometry_va4mr_torch.tools import (
    bench, bench_ba_scaling, bench_datasets, bench_lockstep,
    bench_native_decode, bench_stream, bench_stream_2761, diag_ba, diag_drift, diag_e2e,
    diag_survival, diag_tracker, exp_ate, harness, make_kitti_seq,
    profile_ba, profile_branch, profile_step, profile_trigger,
    stress_klt_motion, traj_ba_convergence)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = (120, 160)
FRAMES = 16  # bootstrap over 0..4, warm-up to 12, 4 timed frames

# The keys of the JAX scripts' output lines.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "lost", "ate_rmse",
              "ate_bound", "measured_fps", "ref_fps", "ref_ate",
              "ref_completed", "healthy"}  # bench.py:183-195
DATASETS_KEYS = {"dataset", "resolution", "klt_window", "klt_max_level",
                 "fps", "lost", "ate_rmse", "ate_bound", "ref_fps", "ref_ate",
                 "ref_completed", "vs_ref",
                 "healthy"}  # tools/bench_datasets.py:106-115
# tools/profile_step.py:180-184: a row per stage, (stage, ms, % of step).
PROFILE_STAGES = ["pyramid", "klt/coarse_volume", "klt/prior_sample",
                  "klt/total", "klt/total+fb", "pnp_ransac", "triangulate",
                  "lm_retriangulate", "detect_corners", "dedup_matrix",
                  "FULL STEP"]
PROFILE_KEYS = {"stage", "ms", "pct_of_step"}
# tools/diag_tracker.py:96-145: the corner count, the GT flow's median, p90
# and max, then per tracker accepted and err-vs-GT med, p90, > 3 px.
DIAG_TRACKERS = {"xla", "pallas", "pallas2", "pallas2_ml", "pallas2_fb",
                 "xla_fb"}
DIAG_TRACKER_KEYS = {"accepted", "err_vs_gt_median", "err_vs_gt_p90",
                     "err_vs_gt_over_3px"}
# tools/stress_klt_motion.py:82-105.
STRESS_ROW_KEYS = {"accepted", "good", "gross_outliers", "median_err_px"}
STRESS_SUMMARY_KEYS = {"envelope_px", "healthy_inside", "bounded_beyond"}


def lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Small scenes, rendered in this process, cached under ``tmp_path``."""
    monkeypatch.setattr(tsyn, "SCENE_CACHE", tmp_path / "scene_cache")
    monkeypatch.setattr(harness, "render_frames",
                        lambda scene, n: [scene.render(i) for i in range(n)])
    torch.set_num_threads(2)
    return tmp_path


def test_bench_lines(small, monkeypatch, capsys):
    monkeypatch.setattr(bench, "NUM_FRAMES", FRAMES)
    monkeypatch.setattr(bench, "IMAGE_SHAPE", SMALL)
    monkeypatch.setattr(bench, "REPS", 1)
    rc = bench.main(["--device", "cpu", "--seeds", "0,1"])
    out = lines(capsys)
    assert len(out) == 3  # two runs, then the median and the worst
    for line in out:
        assert BENCH_KEYS <= set(line)
        assert line["ref_fps"] is None and line["ref_ate"] is None
        assert line["device"] == "cpu" and line["tracker"] == "xla"
        assert line["device_ms_per_step"] is None
        assert line["n_timed"] == FRAMES - bench.TIMED_START
    runs, summ = out[:2], out[2]
    assert [r["seed"] for r in runs] == [0, 1] and summ["seeds"] == [0, 1]
    assert summ["worst"]["ate_rmse"] == max(r["ate_rmse"] for r in runs)
    assert summ["lost"] == max(r["lost"] for r in runs)
    assert rc == (0 if all(r["healthy"] for r in runs) else 2)
    for r in runs:
        assert r["value"] == (r["measured_fps"] if r["healthy"] else 0.0)


def test_bench_lockstep_lines(small, monkeypatch, capsys):
    """The batch-size sweep at 2 sizes on the CPU: one line per size, the
    windows stepped as one batch, device numbers ``None``."""
    monkeypatch.setattr(bench, "NUM_FRAMES", 20)
    monkeypatch.setattr(bench, "IMAGE_SHAPE", SMALL)
    rc = bench_lockstep.main(["--device", "cpu", "--sizes", "1,3",
                              "--frames", "8"])
    out = lines(capsys)
    assert rc == 0 and [r["sequences"] for r in out] == [1, 3]
    for r in out:
        assert r["batched_steps"] == 8 - bench.BOOTSTRAP_STRIDE - 1
        assert r["ms_per_batched_frame"] > 0 and r["device"] == "cpu"
        assert r["profile"] is None and r["peak_device_mb"] is None
    assert bench_lockstep.windows(list(range(100)), 11, 24)[-1] == list(
        range(70, 94))


def test_bench_datasets_lines(small, monkeypatch, capsys):
    """The Malaga preset (``mid_iters=4``) at a reduced size; the JAX
    record's columns read from ``BENCH_datasets.json``."""
    monkeypatch.setattr(bench_datasets, "PRESETS", {
        "malaga": (SMALL, "malaga_config", 4)})
    out_path = small / "datasets.json"
    rc = bench_datasets.main(["--device", "cpu", "--datasets", "malaga",
                              "--frames", str(FRAMES), "--out",
                              str(out_path)])
    (line,) = lines(capsys)
    assert DATASETS_KEYS <= set(line)
    assert line["dataset"] == "malaga" and line["resolution"] == list(SMALL)
    assert line["mid_iters"] == 4 and line["klt_max_level"] == 5
    assert line["ref_ate"] is None and line["vs_ref"] is None
    with open(ROOT / "BENCH_datasets.json") as f:
        jax = {r["dataset"]: r for r in json.load(f)}["malaga"]
    assert (line["jax_ate_rmse"], line["jax_ref_ate"]) == (
        jax["ate_rmse"], jax["ref_ate"])
    assert json.loads(out_path.read_text()) == [line]
    assert rc == (0 if line["healthy"] else 2)


def test_profile_step_lines(small, monkeypatch, capsys):
    def parking_small():  # the preset at a small size, narrow tables
        cfg = tconfig.parking_config()
        return cfg.replace(image_shape=SMALL, capacity=dataclasses.replace(
            cfg.capacity, max_landmarks=256, max_candidates=256))

    monkeypatch.setitem(tconfig.PRESETS, "parking", parking_small)
    monkeypatch.setattr(profile_step, "REPS", 1)
    monkeypatch.setattr(profile_step, "WARMUP", 0)
    assert profile_step.main(["--device", "cpu", "--frames", "12", "--scan",
                              "--json"]) == 0
    out = lines(capsys)
    assert [r["stage"] for r in out] == PROFILE_STAGES + ["scan"]
    for r in out[:-1]:
        assert PROFILE_KEYS <= set(r) and r["ms"] > 0
        assert r["launches"] is None and r["device_ms"] is None
        assert r["dataset"] == "parking" and r["device"] == "cpu"
    assert out[-2]["pct_of_step"] == 100.0
    assert out[-1]["frames"] == 2 and out[-1]["ms_per_frame"] > 0
    # The table form prints a row per stage.
    profile_step.print_table(out[0], out[:-1], out[-1:])
    table = capsys.readouterr().out
    assert all(name in table for name in PROFILE_STAGES)
    assert "scan driver: 2 frames" in table


def test_diag_tracker_lines(small, capsys):
    assert diag_tracker.main(["--device", "cpu", "--height", str(SMALL[0]),
                              "--width", str(SMALL[1])]) == 0
    (res,) = lines(capsys)
    assert res["corners"] > 20 and set(res["gt_flow_px"]) == {
        "median", "p90", "max"}
    assert set(res["trackers"]) == DIAG_TRACKERS
    for name, t in res["trackers"].items():
        assert DIAG_TRACKER_KEYS <= set(t)
        assert t["accepted"] > 0
    # The oracle against itself.
    assert res["trackers"]["xla"]["err_vs_xla_max"] == 0.0
    assert res["device"] == "cpu"


def test_stress_klt_motion_lines(small, monkeypatch, capsys):
    monkeypatch.setattr(stress_klt_motion, "SHAPE", (120, 288))
    monkeypatch.setattr(stress_klt_motion, "MARGIN", 64)
    monkeypatch.setattr(stress_klt_motion, "N", 64)
    monkeypatch.setattr(stress_klt_motion, "DXS", (4, 16, 32))
    rc = stress_klt_motion.main(["--device", "cpu"])
    out = lines(capsys)
    rows, summ = out[:-1], out[-1]
    assert [r["dx"] for r in rows] == [4, 16, 32]
    for r in rows:
        assert STRESS_ROW_KEYS == set(r["pallas2"]) == set(r["xla"])
    assert STRESS_SUMMARY_KEYS <= set(summ) and summ["envelope_px"] == 160
    assert rc == (0 if summ["healthy_inside"] and summ["bounded_beyond"]
                  else 2)
    # Inside the envelope the chain follows every shift; the oracle's deep
    # pyramid runs out of texture on a 120-row render beyond a few px.
    assert all(r["pallas2"]["good"] > 0.6 * 64 for r in rows)
    assert rows[0]["xla"]["good"] > 0.6 * 64


@pytest.mark.parametrize("tool", [
    bench, bench_datasets, profile_step, diag_tracker, stress_klt_motion,
    bench_stream, bench_stream_2761, make_kitti_seq, bench_native_decode,
    profile_ba, profile_branch, profile_trigger, diag_ba, bench_ba_scaling,
    traj_ba_convergence, diag_e2e, diag_drift, diag_survival, exp_ate,
    bench_lockstep], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_default_to_cuda_and_refuse_without_it(tool):
    """No ``--device``: the card.  Without one the tool raises before it
    renders or runs anything; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


# --- the health gate -------------------------------------------------------

class Straight:
    """A scene stand-in: ground truth moving 1 m a frame along z."""

    def __init__(self, n):
        self.poses_WC = np.tile(np.eye(4), (n, 1, 1))
        self.poses_WC[:, 2, 3] = np.arange(n, dtype=np.float64)


def test_health_gate_arithmetic():
    scene = Straight(51)  # path 50 m: bound 1 m
    gt = scene.poses_WC[:, :3, 3]
    ids = range(51)
    ok = [0] * 51
    exact = harness.trajectory_health(scene, ids, gt.copy(), ok)
    assert exact["path"] == 50.0 and exact["ate_bound"] == 1.0
    assert exact["ate"] < 1e-9 and harness.healthy(exact)
    # Sim(3) alignment: a scaled, rotated, shifted copy is still exact.
    c, s_ = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]])
    moved = 2.5 * gt @ R.T + [3.0, -1.0, 7.0]
    assert harness.trajectory_health(scene, ids, moved, ok)["ate"] < 1e-9
    # A lateral zig-zag of +-a m has ATE a (the mean is 0, so alignment
    # keeps it): healthy at 0.9 m, not at 1.1 m.
    for a, want in ((0.9, True), (1.1, False)):
        zig = gt.copy()
        zig[:, 0] = a * np.where(np.arange(51) % 2, 1.0, -1.0)
        zig[-1, 0] = 0.0  # an even count of +-a about the axis
        res = harness.trajectory_health(scene, ids, zig, ok)
        assert harness.healthy(res) == want, res
    lost = harness.trajectory_health(scene, ids, gt.copy(), [0] * 50 + [1])
    assert lost["lost"] == 1 and not harness.healthy(lost)
    bad = gt.copy()
    bad[7, 1] = np.nan
    res = harness.trajectory_health(scene, ids, bad, ok)
    assert not res["finite"] and np.isnan(res["ate"])
    assert not harness.healthy(res)


def test_ate_equals_the_jax_ate():
    from monocular_visual_odometry_va4mr_tpu.evalx import ate as jate

    rng = np.random.default_rng(3)
    gt = np.cumsum(rng.normal(0, 1, (80, 3)), 0)
    est = 0.7 * gt + rng.normal(0, 0.2, gt.shape) + [1.0, 2.0, 3.0]
    for scale in (True, False):
        assert abs(tate.ate_rmse(est, gt, scale)
                   - float(jate.ate_rmse(est, gt, scale))) <= 1e-12


# --- the tracker A/B and the motion stress against the JAX tools -----------

def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gt_flow_equals_the_jax_tool():
    from monocular_visual_odometry_va4mr_tpu.dataio import synthetic as jsyn

    kw = dict(seed=11, num_frames=20, image_shape=(480, 640), step=1.0)
    ours, ref = tsyn.make_textured_scene(**kw), jsyn.make_textured_scene(**kw)
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(0, 640, 500), rng.uniform(0, 480, 500)], 1)
    p, ok = diag_tracker.gt_flow(ours, 10, 11, uv)
    rp, rok = jax_tool("diag_tracker").gt_flow(ref, 10, 11, uv)
    np.testing.assert_array_equal(ok, rok)
    assert ok.sum() > 400
    np.testing.assert_allclose(p[ok], rp[ok], rtol=0, atol=1e-6)


def test_yaw_frames_equal_the_jax_tools():
    """``tools/stress_klt_motion.py``'s recipe (a seed-5 scene, step 0, one
    wide render, crops MARGIN px in, the second shifted by dx) at a reduced
    size, through the JAX package's renderer."""
    from monocular_visual_odometry_va4mr_tpu.dataio import synthetic as jsyn

    H, W, margin = 96, 320, 72
    scene = jsyn.make_textured_scene(seed=5, num_frames=2,
                                     image_shape=(H, W), step=0.0)
    ref = np.asarray(scene.render(0), np.float32)
    base = stress_klt_motion.base_frame((H, W))
    assert base.dtype == np.float32
    np.testing.assert_array_equal(base, ref)
    for dx in (20, 40, 72):
        i0, i1 = stress_klt_motion.yaw_pair(base, dx, margin)
        np.testing.assert_array_equal(i0, ref[:, margin:W - margin])
        np.testing.assert_array_equal(i1, ref[:, margin - dx:W - margin - dx])


class FakeEvent:
    def __init__(self, name, us, on_device):
        self.name, self.key = name, name
        self.device_type = (torch.autograd.DeviceType.CUDA if on_device
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"elapsed_us": lambda _: us})()
        # As torch.profiler reports them: an operator also carries the
        # device time of the kernels it launched.
        self.self_device_time_total = us


class FakeProfile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events

    def key_averages(self):
        return self._events


def test_device_profile_counts_each_device_event_once():
    prof = FakeProfile([
        FakeEvent("aten::add", 30.0, False),  # the launching operator
        FakeEvent("add_kernel", 30.0, True),
        FakeEvent("klt_lk_kernel", 8.0, True),
        FakeEvent("klt_lk_kernel", 9.0, True),
        FakeEvent("Memcpy HtoD", 3.0, True)])
    res = harness.device_profile(prof, 2, "klt_lk_kernel")
    assert res["device_ms_per_step"] == pytest.approx(0.025)  # 50 us / 2
    assert res["launches_per_step"] == 2.0
    assert res["kernel_calls_per_step"] == 1.0
    assert res["kernel_ms_per_call"] == pytest.approx(0.0085)
