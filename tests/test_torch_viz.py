"""The port's dashboard against the JAX renderer, and the port's CLI on a
dataset read from PNG files.

Tolerances: none.  The dashboard is the same matplotlib figure, so both
renderers write the same pixels; the CLI's positions equal an in-memory
``run_sequence`` over the same frames exactly (same device, same draws).
"""
import json
import os

import numpy as np
import pytest
import torch

from monocular_visual_odometry_va4mr_torch.core.camera import Camera
from monocular_visual_odometry_va4mr_torch.core.config import parking_config
from monocular_visual_odometry_va4mr_torch.dataio import datasets as tds
from monocular_visual_odometry_va4mr_torch.dataio import synthetic as tsyn
from monocular_visual_odometry_va4mr_torch.pipeline import runner
from monocular_visual_odometry_va4mr_torch.pipeline.vo import VisualOdometry
from monocular_visual_odometry_va4mr_torch.run import main
from monocular_visual_odometry_va4mr_torch.viz import dashboard as tdash
from test_torch_dataio import write_png

torch.set_num_threads(2)


def dashboard_inputs(seed=0, n=30):
    rng = np.random.default_rng(seed)
    traj = np.cumsum(rng.normal(0, 0.3, (n, 3)), 0)
    return dict(
        image=rng.uniform(0, 255, (48, 64)).astype(np.float32),
        inlier_uv=rng.uniform(0, 48, (25, 2)),
        outlier_uv=rng.uniform(0, 48, (7, 2)),
        trajectory=traj,
        landmark_xyz=traj[-1] + rng.normal(0, 5, (40, 3)),
        num_tracked=rng.integers(50, 200, n),
        frame_index=n + 5)


def read_png(path):
    import matplotlib.pyplot as plt

    return plt.imread(path)


@pytest.mark.parametrize("with_gt", [True, False])
def test_render_dashboard_same_pixels(tmp_path, with_gt):
    from monocular_visual_odometry_va4mr_tpu.viz import dashboard as jdash

    kw = dashboard_inputs()
    gt = (np.cumsum(np.random.default_rng(1).normal(0, 0.3, (30, 2)), 0)
          if with_gt else None)
    ours = tdash.render_dashboard(**kw, out_path=str(tmp_path / "t.png"),
                                  gt_xz=gt, max_dist=20.0)
    ref = jdash.render_dashboard(**kw, out_path=str(tmp_path / "j.png"),
                                 gt_xz=gt, max_dist=20.0)
    a, b = read_png(ours), read_png(ref)
    assert a.shape == b.shape and a.shape[0] > 400
    np.testing.assert_array_equal(a, b)


def test_live_dashboard_honours_save_every(tmp_path):
    out = tmp_path / "live" / "dash.png"
    live = tdash.LiveDashboard(out_path=str(out), save_every=3, max_dist=10.0)
    assert not live.interactive  # Agg
    saves = []
    save = live.fig.savefig
    live.fig.savefig = lambda path: (saves.append(live._n), save(path))
    kw = dashboard_inputs(n=12)
    for n in range(1, 8):
        kw["frame_index"] = n
        live.update(**{**kw, "trajectory": kw["trajectory"][:n],
                       "num_tracked": kw["num_tracked"][:n]})
    live.close()
    assert saves == [3, 6]
    assert out.exists()


# --- the CLI on PNG files ----------------------------------------------------

FRAMES, SHAPE = 12, (480, 640)


@pytest.fixture(scope="module")
def parking_dir(tmp_path_factory):
    """The beacon corridor at 480x640 as uint8 PNGs in the Parking layout,
    with its ground truth; (root, uint8 frames, scene)."""
    root = tmp_path_factory.mktemp("parking")
    scene = tsyn.make_corridor_scene(seed=0, num_frames=FRAMES,
                                     num_points=(FRAMES + 60) * 60,
                                     image_shape=SHAPE)
    u8 = [np.clip(np.rint(tsyn.render_frame(scene, i)), 0, 255)
          .astype(np.uint8) for i in range(FRAMES)]
    for i, img in enumerate(u8):
        write_png(root / "images" / f"img_{i:05d}.png", img)
    np.savetxt(root / "poses.txt",
               scene.poses_WC[:, :3, :].reshape(FRAMES, 12))
    return str(root), u8, scene


def in_memory_positions(u8, scene, seed=0):
    cfg = parking_config().replace(bootstrap_method="klt")
    vo = VisualOdometry(Camera.from_matrix(tds.PARKING_K), cfg, "cpu",
                        seed=seed)
    res = runner.run_sequence(vo, ((i, f.astype(np.float32))
                                   for i, f in enumerate(u8)),
                              seed=seed, bootstrap_stride=6)
    return res.positions, [r.status for r in res.records]


@pytest.fixture(scope="module")
def in_memory(parking_dir):
    _, u8, scene = parking_dir
    return in_memory_positions(u8, scene)


@pytest.mark.parametrize("live", [False, True], ids=["plot", "plot_live"])
def test_cli_on_png_files_equals_run_sequence(parking_dir, in_memory,
                                              tmp_path, live):
    root, u8, _ = parking_dir
    metrics = tmp_path / "m.jsonl"
    plot = tmp_path / "out" / "dash.png"
    argv = ["--dataset", "parking", "--data-root", root, "--bootstrap",
            "klt", "--max-frames", str(FRAMES), "--device", "cpu",
            "--quiet", "--plot", str(plot), "--metrics-json", str(metrics)]
    if live:
        argv += ["--plot-live", "--plot-every", "2"]
    result = main(argv)
    rows = [json.loads(line) for line in open(metrics)]
    pos = np.array([r["position"] for r in rows])
    ref_pos, ref_status = in_memory
    assert len(rows) == FRAMES - 6
    assert [r["frame"] for r in rows] == list(range(6, FRAMES))
    np.testing.assert_array_equal(pos, ref_pos)
    assert [r["status"] for r in rows] == ref_status
    assert result.num_lost() == 0
    assert plot.exists() and plot.stat().st_size > 10000
    assert read_png(str(plot)).shape[:2] == (800, 1000)


def test_cli_default_data_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match=os.path.join("data",
                                                             "kitti")):
        main(["--dataset", "kitti", "--device", "cpu", "--quiet"])
