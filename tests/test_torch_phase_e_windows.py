"""``chip_smoke.py`` phase E's eleven 24-frame windows of the loop stream
through both packages' runners on the CPU, on the gather (``xla``)
tracker, with the same RANSAC draws: the JAX ``run_sequence`` and the
port's fed the JAX runner's own draws (``test_torch_stress_tail``'s
``JaxSeedDraws``), each window run alone as phase E's solo runs are (run
seed ``multi_seq.sequence_seed(0, s)``, bootstrap stride 4, no recovery).
Run as a script, it renders the windows' frames of phase B's loop scene
(seed 11, 640 frames, 376x1241), prints one JSON line per window (ATE,
its bound of 2% of the path, LOST, per package) and a summary line:

    JAX_PLATFORMS=cpu python tests/test_torch_phase_e_windows.py \\
        [--windows 0,1,...,10] [--workers 4]

A window that misses its bound in both packages misses by the scene; in
the port alone, by a fault of the port; in neither, by the card's
arithmetic.  The test checks what the script relies on: its windows are
phase E's, and the JAX configuration is the port's (``main_path_vo``'s
on the gather tracker) field by field.
"""
import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from monocular_visual_odometry_va4mr_tpu.core import config as jconfig  # noqa
from monocular_visual_odometry_va4mr_torch.core import config as tconfig  # noqa


def windows():
    """(first frame, frames) of phase E's S = MULTI_SEQS windows."""
    gap = (cs.LOOP_FRAMES - cs.MULTI_FRAMES) // (cs.MULTI_SEQS - 1)
    return [(k * gap, cs.MULTI_FRAMES) for k in range(cs.MULTI_SEQS)]


def config(cfg_mod):
    """``chip_smoke.main_path_vo``'s configuration on the gather tracker,
    in either package."""
    cfg = cfg_mod.kitti_tuned_config().replace(image_shape=cs.IMAGE_SHAPE,
                                               bootstrap_method="klt")
    return cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.03),
        klt=dataclasses.replace(cfg.klt, backend="xla"))


def test_windows_and_configs_are_phase_es():
    starts = [a for a, _ in windows()]
    assert starts == [61 * k for k in range(11)] and starts[-1] + 24 <= 640
    assert all(n == cs.MULTI_FRAMES == 24 for _, n in windows())

    class Scene:
        image_shape = cs.IMAGE_SHAPE
        K = np.array([[718.856, 0, 607.1928], [0, 718.856, 185.2157],
                      [0, 0, 1]])

    cs.DEVICE = "cpu"
    port_cfg, _, _ = cs.main_path_vo(Scene())
    port_cfg = port_cfg.replace(
        klt=dataclasses.replace(port_cfg.klt, backend="xla"))
    assert dataclasses.asdict(config(tconfig)) == dataclasses.asdict(port_cfg)
    assert dataclasses.asdict(config(jconfig)) == dataclasses.asdict(port_cfg)


def health(scene, first, res, b):
    """ATE, its 2% bound and LOST of a run's frames after the bootstrap,
    as phase E reads its solo runs."""
    from monocular_visual_odometry_va4mr_torch.tools.harness import (
        trajectory_health)

    recs = res.records[1:]
    ids = [first + r.frame for r in recs]
    pos = np.stack([r.T_WC[:3, 3] for r in recs])
    h = trajectory_health(scene, ids, pos, [r.status for r in recs])
    return dict(ate=h["ate"], bound=h["ate_bound"], lost=h["lost"],
                frames=len(recs), over=not h["ate"] <= h["ate_bound"])


def main():
    import torch

    from monocular_visual_odometry_va4mr_tpu.core.camera import (
        Camera as JCamera)
    from monocular_visual_odometry_va4mr_tpu.pipeline import (
        runner as jrunner)
    from monocular_visual_odometry_va4mr_tpu.pipeline.vo import (
        VisualOdometry as JVO)
    from monocular_visual_odometry_va4mr_torch.core.camera import Camera
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic
    from monocular_visual_odometry_va4mr_torch.parallel import multi_seq
    from monocular_visual_odometry_va4mr_torch.pipeline import runner
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)
    from monocular_visual_odometry_va4mr_torch.tools import harness
    from test_torch_stress_tail import JaxSeedDraws

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", default=",".join(map(str, range(11))))
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.workers)
    picked = [int(s) for s in args.windows.split(",")]
    scene = synthetic.make_loop_scene(seed=cs.SEED, num_frames=cs.LOOP_FRAMES,
                                      laps=cs.LOOP_LAPS,
                                      image_shape=cs.IMAGE_SHAPE)
    wins = windows()
    ids = sorted({wins[s][0] + i for s in picked for i in range(wins[s][1])})
    rendered = dict(zip(ids, harness.spawn_map(
        harness._render, [(scene, i) for i in ids],
        workers=args.workers)))
    jvo = JVO(JCamera.from_matrix(scene.K), config(jconfig))
    tvo = VisualOdometry(Camera.from_matrix(scene.K), config(tconfig), "cpu",
                         sampler=JaxSeedDraws(), seed=0)
    b = cs.BOOTSTRAP_STRIDE
    rows = []
    for s in picked:
        first, n = wins[s]
        seq = [rendered[first + i] for i in range(n)]
        seed = multi_seq.sequence_seed(0, s)
        row = dict(window=s, first=first, seed=seed)
        row["jax_xla"] = health(scene, first, jrunner.run_sequence(
            jvo, enumerate(seq), seed=seed, bootstrap_stride=b,
            recover=False), b)
        row["port_xla"] = health(scene, first, runner.run_sequence(
            tvo, enumerate(seq), seed=seed, bootstrap_stride=b,
            recover=False), b)
        print("window " + json.dumps(row), flush=True)
        rows.append(row)
    print("summary " + json.dumps({
        p: dict(over=[r["window"] for r in rows if r[p]["over"]],
                lost=[r[p]["lost"] for r in rows],
                ate=[r[p]["ate"] for r in rows])
        for p in ("jax_xla", "port_xla")}), flush=True)


if __name__ == "__main__":
    main()
