"""End-to-end health diagnostic, counterpart of ``tools/diag_e2e.py``: run
the runner on a synthetic scene and report each frame's status and counts
and the final LOST count, finiteness and ATE.

The scene is the textured world (``--scene textured``) or the beacon
corridor (``blob``; (frames + 60) x 75 points), seed 11, 480x640 by
default; the preset (``--preset``, ``parking`` by default) with the KLT
bootstrap, the tracker ``--backend`` (``pallas2``, the kernel path, by
default; ``pallas`` the v1 kernel, ``xla`` the gather tracker, ``auto``),
and optional ``--quality`` / ``--fb`` overrides; ``runner.run_sequence``
with recovery (unless ``--no-recover``) and host-side BA every
``--ba-every`` frames.

One JSON line a frame (``frame``, ``status``, ``n_inliers``,
``n_tracked``, ``wall_ms``; left out with ``--quiet``), then the summary
line with the JAX tool's quantities (``frames``, ``lost``, ``finite``,
``ate_rmse``, ``fps``) and the LK kernels' launches (0 on the CPU, where
the wrappers run their plain versions).

    python -m monocular_visual_odometry_va4mr_torch.tools.diag_e2e \\
        [--scene textured] [--backend pallas2] [--frames 80]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from . import harness


def make_scene(scene_kind, num_frames, image_shape, seed):
    from ..dataio import synthetic

    if scene_kind == "textured":
        scene = synthetic.make_textured_scene(
            seed=seed, num_frames=num_frames, image_shape=image_shape,
            step=1.0)
        render = lambda sc: harness.render_frames(sc, num_frames)  # noqa: E731
    else:  # the corridor's points render fast, in this process
        scene = synthetic.make_corridor_scene(
            seed=seed, num_frames=num_frames,
            num_points=int((num_frames * 1.0 + 60.0) * 75),
            image_shape=image_shape, step=1.0)
        render = None
    tag = (f"{scene_kind}-s{seed}-f{num_frames}-"
           f"{image_shape[0]}x{image_shape[1]}")
    return scene, synthetic.render_all_cached(scene, tag, render=render)


def make_vo(scene, preset, backend, device, quality=None, fb=None):
    from ..core.camera import Camera
    from ..core.config import PRESETS
    from ..pipeline.vo import VisualOdometry

    cfg = PRESETS[preset]().replace(image_shape=scene.image_shape,
                                    bootstrap_method="klt")
    cfg = cfg.replace(klt=dataclasses.replace(cfg.klt, backend=backend))
    if quality is not None:
        cfg = cfg.replace(
            detector=dataclasses.replace(cfg.detector, quality_level=quality))
    if fb is not None:
        cfg = cfg.replace(klt=dataclasses.replace(cfg.klt, fb_max_err_px=fb))
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)


def run(scene_kind, backend, num_frames, image_shape, device, *,
        bootstrap_stride=4, seed=11, recover=True, quality=None, fb=None,
        preset="parking", ba_every=0, ba_window=8):
    """(RunResult, summary fields)."""
    from ..evalx import ate
    from ..ops import klt_pallas as v1
    from ..ops import klt_pallas2 as k2
    from ..pipeline import runner

    t0 = time.perf_counter()
    scene, frames = make_scene(scene_kind, num_frames, image_shape, seed)
    render_s = time.perf_counter() - t0
    vo = make_vo(scene, preset, backend, device, quality, fb)
    k2.klt_lk.launches = v1.klt_v1.launches = 0
    result = runner.run_sequence(
        vo, enumerate(frames), bootstrap_stride=bootstrap_stride,
        recover=recover, ba_every=ba_every, ba_window=ba_window)
    est = result.positions
    gt = scene.poses_WC[[r.frame for r in result.records], :3, 3]
    lost = result.num_lost()
    finite = bool(np.all(np.isfinite(est)))
    rmse = float(ate.ate_rmse(est, gt)) if finite else float("nan")
    summary = dict(scene=scene_kind, backend=backend,
                   tracker=vo.klt_backend, preset=preset,
                   resolution=list(image_shape),
                   frames=len(result.records), lost=lost, finite=finite,
                   ate_rmse=rmse, fps=result.frames_per_sec,
                   render_s=render_s, klt_lk_launches=k2.klt_lk.launches,
                   klt_v1_launches=v1.klt_v1.launches)
    return result, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="textured",
                    choices=["textured", "blob"])
    ap.add_argument("--backend", default="pallas2",
                    choices=["pallas2", "pallas", "xla", "auto"])
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--no-recover", action="store_true")
    ap.add_argument("--quality", type=float, default=None)
    ap.add_argument("--fb", type=float, default=None)
    ap.add_argument("--preset", default="parking")
    ap.add_argument("--ba-every", type=int, default=0)
    ap.add_argument("--ba-window", type=int, default=8)
    harness.add_device_arg(ap)
    a = ap.parse_args(argv)
    device = harness.resolve_device(a.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    result, summary = run(
        a.scene, a.backend, a.frames, (a.height, a.width), device,
        bootstrap_stride=a.stride, seed=a.seed, recover=not a.no_recover,
        quality=a.quality, fb=a.fb, preset=a.preset, ba_every=a.ba_every,
        ba_window=a.ba_window)
    if not a.quiet:
        for r in result.records:
            harness.emit(dict(frame=r.frame, status=r.status,
                              n_inliers=r.n_inliers, n_tracked=r.n_tracked,
                              wall_ms=r.wall_ms))
    harness.emit({**summary, **fields})
    return 0


if __name__ == "__main__":
    sys.exit(main())
