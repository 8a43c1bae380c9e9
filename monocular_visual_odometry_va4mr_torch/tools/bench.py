"""The port's headline benchmark, counterpart of the root ``bench.py``:
frames per second of the block driver on one device, with the pipeline's
health asserted before any rate is reported.

Scene, configuration and procedure are ``bench.py``'s: the textured
KITTI-geometry corridor (seed 11, 100 frames at 376x1241, ~1 m a frame),
``kitti_tuned_config()`` with the KLT bootstrap and
``detector.quality_level=0.03`` (tracker ``auto``: ``pallas2`` on the card),
a bootstrap over frames 0..4, warm-up steps to frame 12, then
``scan_driver.run_streaming`` over frames 12..99 in one block, best of 3
(``harness.bench_run``).

Health: 0 LOST over the bootstrap frame, the warm-up and the timed frames, a
finite trajectory and an ATE RMSE (Sim(3) aligned) within 2% of the path.
``bench.py``'s reference-CPU term runs the original CPU pipeline through
cv2 (``tools/run_reference.py``), which the port does not carry: every
``ref_*`` field is ``null``.

``--seeds 0,1,2`` repeats the run with those runner seeds (the RANSAC draws)
on the same frames and prints one line per run, then a summary line with
the median and the worst; one draw says little (the ATE of this scene
spreads 0.25-0.71 m over seeds).  Each line has ``bench.py``'s keys plus
``device``, ``device_ms_per_step`` and ``launches_per_step`` (profiler, over
8 streamed frames; ``null`` on the CPU), ``bootstrap_ms`` and ``klt_lk``'s
launches against 3 per hop and per step.  Exit code 2 when a run is
unhealthy, as ``bench.py``.

    python -m monocular_visual_odometry_va4mr_torch.tools.bench [--seeds 0,1,2]
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys

from . import harness

NUM_FRAMES = 100
IMAGE_SHAPE = (376, 1241)  # KITTI seq 05
BOOTSTRAP_STRIDE = 4
SEED = 11
TIMED_START = 12
REPS = 3


def render_scene():
    from ..dataio import synthetic

    scene = synthetic.make_textured_scene(
        seed=SEED, num_frames=NUM_FRAMES, image_shape=IMAGE_SHAPE, step=1.0)
    return scene, harness.render_frames(scene, NUM_FRAMES)


def make_vo(scene, device):
    """``bench.py``'s configuration on ``scene``."""
    from ..core.camera import Camera
    from ..core.config import kitti_tuned_config
    from ..pipeline.vo import VisualOdometry

    cfg = kitti_tuned_config().replace(image_shape=scene.image_shape,
                                       bootstrap_method="klt")
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.03))
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)


def bench_seed(scene, frames, vo, seed, device_name):
    """One run with runner seed ``seed``: ``bench.py``'s line."""
    r = harness.bench_run(vo, frames, seed=seed, stride=BOOTSTRAP_STRIDE,
                          start=TIMED_START, reps=REPS)
    h = harness.trajectory_health(scene, r["ids"], r["positions"],
                                  r["statuses"])
    ok = harness.healthy(h)
    return {
        "metric": "vo_frames_per_sec_per_chip",
        "value": r["fps"] if ok else 0.0, "unit": "frames/s",
        "vs_baseline": None, "lost": h["lost"], "ate_rmse": h["ate"],
        "ate_bound": h["ate_bound"], "measured_fps": r["fps"],
        "ref_fps": None, "ref_ate": None, "ref_completed": None,
        "healthy": ok, "seed": seed, "device": device_name,
        "tracker": vo.klt_backend, "n_timed": r["n_timed"],
        "step_ms": r["step_ms"], "bootstrap_ms": r["bootstrap_ms"],
        "device_ms_per_step": r["device_ms_per_step"],
        "launches_per_step": r["launches_per_step"],
        "dispatches_per_step": r["dispatches_per_step"],
        "klt_lk_per_step": r["klt_lk_per_step"],
        "klt_lk_launches": r["klt_lk_launches"],
        "klt_lk_launches_expected": r["klt_lk_launches_expected"],
    }


def summary(runs):
    """The median and the worst of ``runs`` under ``bench.py``'s keys."""
    def med(key):
        vals = [r[key] for r in runs if r[key] is not None]
        return statistics.median(vals) if vals else None

    ok = all(r["healthy"] for r in runs)
    out = dict(runs[0])
    out.update(
        value=med("measured_fps") if ok else 0.0,
        lost=max(r["lost"] for r in runs), ate_rmse=med("ate_rmse"),
        measured_fps=med("measured_fps"), healthy=ok,
        seed=None, seeds=[r["seed"] for r in runs],
        step_ms=med("step_ms"), bootstrap_ms=med("bootstrap_ms"),
        device_ms_per_step=med("device_ms_per_step"),
        launches_per_step=med("launches_per_step"),
        dispatches_per_step=med("dispatches_per_step"),
        klt_lk_per_step=med("klt_lk_per_step"),
        klt_lk_launches=sum(r["klt_lk_launches"] for r in runs),
        klt_lk_launches_expected=sum(r["klt_lk_launches_expected"]
                                     for r in runs),
        worst=dict(measured_fps=min(r["measured_fps"] for r in runs),
                   ate_rmse=max(r["ate_rmse"] for r in runs),
                   lost=max(r["lost"] for r in runs),
                   step_ms=max(r["step_ms"] for r in runs)),
        ates=[r["ate_rmse"] for r in runs],
        fps=[r["measured_fps"] for r in runs])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0",
                    help="runner seeds, comma-separated (default 0)")
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    name = harness.device_label(device)
    scene, frames = render_scene()
    vo = make_vo(scene, device)
    runs = []
    for seed in harness.parse_seeds(args.seeds):
        runs.append(bench_seed(scene, frames, vo, seed, name))
        harness.emit(runs[-1])
    if len(runs) > 1:
        harness.emit(summary(runs))
    return 0 if all(r["healthy"] for r in runs) else 2


if __name__ == "__main__":
    sys.exit(main())
