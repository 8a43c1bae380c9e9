"""ATE and frames/s of configuration variants on the bench scene,
counterpart of ``tools/exp_ate.py``.

``tools/bench.py``'s scene and operating point (100 frames at 376x1241, a
bootstrap over frames 0..4, steps to frame 12) under ``kitti_config()``
with the KLT bootstrap and ``quality_level=0.03``, changed by each named
variant (``VARIANTS``: in-step BA cadence, window and iterations, table
capacities, KLT iteration budgets, the JAX tool's list); then
``scan_driver.make_scan_step`` over frames 12..99 in one call, once to warm
and best of 3 timed.

One JSON line a variant with the JAX tool's keys (``variant``, ``ate``,
``lost``, ``fps``: ATE RMSE over every frame from the bootstrap on, LOST
over the same), plus ``klt_lk``'s launches of the timed calls against 3 a
step, and the card's ``nvidia-smi`` name and power limit.

    python -m monocular_visual_odometry_va4mr_torch.tools.exp_ate ba4 ba2 base
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from . import bench, harness

REPS = 3


def _ba(c, **kw):
    return c.replace(ba=dataclasses.replace(c.ba, **kw))


def _klt(c, **kw):
    return c.replace(klt=dataclasses.replace(c.klt, **kw))


def _caps(c, lm, cand, corners=None):
    c = c.replace(capacity=dataclasses.replace(
        c.capacity, max_landmarks=lm, max_candidates=cand))
    if corners:
        c = c.replace(detector=dataclasses.replace(c.detector,
                                                   max_corners=corners))
    return c


def _fast(every, **klt):
    return lambda c: _caps(_klt(_ba(c, every=every), num_iters=6,
                                fb_iters=4, **klt), 512, 512, 768)


VARIANTS = {
    "base": lambda c: c,
    "ba4": lambda c: _ba(c, every=4),
    "ba2": lambda c: _ba(c, every=2),
    "ba2w16": lambda c: _ba(c, every=2, window=16),
    "ba1": lambda c: _ba(c, every=1),
    "ba2i4": lambda c: _ba(c, every=2, iters=4),
    "ba4c512": lambda c: _caps(_ba(c, every=4), 512, 512),
    "ba4c768": lambda c: _caps(_ba(c, every=4), 768, 768),
    "ba4c512d768": lambda c: _caps(_ba(c, every=4), 512, 512, 768),
    "ba8c512": lambda c: _caps(_ba(c, every=8), 512, 512),
    "ba4fb8": lambda c: _klt(_ba(c, every=4), fb_iters=8),
    "ba4it6": lambda c: _klt(_ba(c, every=4), num_iters=6),
    "ba4c512it6": lambda c: _caps(_klt(_ba(c, every=4), num_iters=6),
                                  512, 512),
    "ba4c512fb2": lambda c: _caps(_klt(_ba(c, every=4), fb_iters=2),
                                  512, 512),
    "fast4": _fast(4),
    "fast8": _fast(8),
    "fast6": _fast(6),
    "fast8m3": _fast(8, mid_iters=3),
    "fast8a40": lambda c: _fast(8)(c.replace(landmarks=dataclasses.replace(
        c.landmarks, reanchor_age=40))),
    "fast8m3r3": lambda c: _fast(8, mid_iters=3)(c.replace(
        pnp=dataclasses.replace(c.pnp, refine_iters=3))),
}


def run_variant(name, scene, frames, mutate, device):
    """One variant's line."""
    from ..core.camera import Camera
    from ..core.config import kitti_config
    from ..evalx import ate
    from ..ops import klt_pallas2 as k2
    from ..pipeline import runner, scan_driver
    from ..pipeline.vo import VisualOdometry

    cfg = kitti_config().replace(image_shape=scene.image_shape,
                                 bootstrap_method="klt")
    cfg = mutate(cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.03)))
    vo = VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)
    dev = vo.device
    up = [torch.as_tensor(f).to(dev) for f in frames]
    b, start = bench.BOOTSTRAP_STRIDE, bench.TIMED_START
    state = vo.bootstrap(up[0], up[b], intermediate=up[1:b],
                         generator=runner.frame_generator(0, 0, dev))
    statuses, poses, ids = [int(state.status)], [state.T_CW.cpu().numpy()], [b]
    for i in range(b + 1, start):
        state = vo.step(state, up[i],
                        generator=runner.frame_generator(0, i, dev))
        statuses.append(int(state.status))
        poses.append(state.T_CW.cpu().numpy())
        ids.append(i)
    images = torch.stack(up[start:])
    timed = list(range(start, len(frames)))
    run = scan_driver.make_scan_step(vo)

    def call():
        gens = [runner.frame_generator(0, i, dev) for i in timed]
        out = run(state, images, gens)
        harness.sync(dev)
        return out

    call()
    k2.klt_lk.launches = 0
    dt = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        _, outs = call()
        dt = min(dt, time.perf_counter() - t0)
    statuses += [int(s) for s in outs.status.cpu()]
    poses += list(outs.T_CW.cpu().numpy())
    ids += timed
    est = harness.positions_of(poses)
    gt = scene.poses_WC[ids, :3, 3]
    a = (float(ate.ate_rmse(est, gt)) if np.all(np.isfinite(est))
         else float("nan"))
    return dict(variant=name, ate=a, lost=sum(1 for s in statuses if s),
                fps=len(timed) / dt, tracker=vo.klt_backend,
                klt_lk_launches=k2.klt_lk.launches,
                klt_lk_launches_expected=(3 * len(timed) * REPS
                                          if harness.launches_lk(vo) else 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"of {', '.join(VARIANTS)} (default ba4 ba2)")
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    names = args.variants or ["ba4", "ba2"]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    scene, frames = bench.render_scene()
    for name in names:
        harness.emit({**run_variant(name, scene, frames, VARIANTS[name],
                                    device), **fields})
    return 0


if __name__ == "__main__":
    sys.exit(main())
