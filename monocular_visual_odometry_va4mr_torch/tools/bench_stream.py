"""Sustained long-sequence throughput of the block driver, counterpart of
``tools/bench_stream.py``.

``tools/bench.py`` times one block of 88 frames; this streams a longer
sequence in fixed blocks with the state carried across them: the textured
KITTI-geometry corridor (seed 11, 384 frames at 376x1241, ~1 m a frame),
``kitti_tuned_config()`` with the KLT bootstrap and ``quality_level=0.01``
(the JAX tool's), a bootstrap over frames 0..4, one untimed block of
``--block`` frames (warm-up; the state it leaves is the timed stream's
start), then ``scan_driver.run_streaming`` with recovery over the rest,
timed.

Health, as the JAX tool: 0 LOST, a finite trajectory, ATE RMSE (Sim(3)
aligned) over the timed frames within 2% of their path.  The JAX tool's
reference-CPU bound needs cv2 and the reference's code: ``ref_*`` are
``null``.  The line has the JAX keys plus ``klt_lk``'s launches against 3
per step and hop, device ms and launches per step over 8 streamed frames
under ``torch.profiler`` (``null`` on the CPU) and the card's
``nvidia-smi`` name and power limit.  Exit code 2 when unhealthy.

    python -m monocular_visual_odometry_va4mr_torch.tools.bench_stream \\
        [--frames 384] [--block 64]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from . import harness

IMAGE_SHAPE = (376, 1241)
SEED = 11
BOOTSTRAP_STRIDE = 4


def render_scene(n):
    from ..dataio import synthetic

    scene = synthetic.make_textured_scene(seed=SEED, num_frames=n,
                                          image_shape=IMAGE_SHAPE, step=1.0)
    H, W = IMAGE_SHAPE
    frames = synthetic.render_all_cached(
        scene, f"stream-s{SEED}-f{n}-{H}x{W}",
        render=lambda sc: harness.render_frames(sc, sc.num_frames))
    return scene, frames


def make_vo(scene, device):
    from ..core.camera import Camera
    from ..core.config import kitti_tuned_config
    from ..pipeline.vo import VisualOdometry

    cfg = kitti_tuned_config().replace(image_shape=scene.image_shape,
                                       bootstrap_method="klt")
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.01))
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=384)
    ap.add_argument("--block", type=int, default=64)
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)

    from ..ops import klt_pallas2 as k2
    from ..pipeline import runner, scan_driver

    N, b = args.frames, BOOTSTRAP_STRIDE
    scene, frames = render_scene(N)
    vo = make_vo(scene, device)
    dev = vo.device
    up = [torch.as_tensor(f).to(dev) for f in frames[:b + 1]]
    with harness.CallCounts(vo) as counts:
        k2.klt_lk.launches = 0
        state = vo.bootstrap(up[0], up[b], intermediate=up[1:b],
                             generator=runner.frame_generator(0, 0, dev))
        warm = ((i, frames[i]) for i in range(b + 1, b + 1 + args.block))
        state, _, _, _ = scan_driver.run_streaming(vo, state, warm, 0,
                                                   block=args.block)
        harness.sync(dev)
        start = b + 1 + args.block
        t0 = time.perf_counter()
        _, outs, ids, info = scan_driver.run_streaming(
            vo, state, ((i, frames[i]) for i in range(start, N)), 0,
            block=args.block, recover=True, bootstrap_stride=b)
        harness.sync(dev)
        dt = time.perf_counter() - t0
    launches, expected = k2.klt_lk.launches, counts.expected_lk()
    if launches != expected:
        raise RuntimeError(f"klt_lk launched {launches} times, expected "
                           f"{expected}")
    prof_ids = ids[:harness.PROFILE_FRAMES]
    prof = harness.profile_steps(
        lambda: scan_driver.run_streaming(
            vo, state, ((i, frames[i]) for i in prof_ids), 0,
            block=len(prof_ids)), len(prof_ids), dev)
    est = harness.positions_of(outs.T_CW)
    h = harness.trajectory_health(scene, ids, est, list(outs.status))
    healthy = harness.healthy(h)
    harness.emit({
        "streamed_frames": len(ids), "block": args.block,
        "sustained_fps": len(ids) / dt, "lost": h["lost"],
        "ate_rmse": h["ate"], "path_m": h["path"], "ref_ate": None,
        "ref_completed": None, "ate_bound": h["ate_bound"],
        "healthy": healthy, "recoveries": info.recoveries,
        "wall_s": dt, "step_ms": 1e3 * dt / len(ids),
        "tracker": vo.klt_backend, "steps": counts.steps,
        "hops": counts.hops, "klt_lk_launches": launches,
        "klt_lk_launches_expected": expected, **prof, **fields})
    return 0 if healthy else 2


if __name__ == "__main__":
    sys.exit(main())
