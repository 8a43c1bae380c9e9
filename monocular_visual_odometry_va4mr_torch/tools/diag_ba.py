"""Step-by-step in-step BA diagnostic, counterpart of
``tools/diag_ba_tpu.py``: find the first frame whose step (with its BA
trigger) leaves a non-finite pose or landmark, and dump the statistics of
the window that fed it.

``tools/bench.py``'s scene (its first ``frames`` frames, 376x1241) under
``kitti_config()`` with the KLT bootstrap, ``quality_level=0.03`` and
in-step BA every ``every`` frames; a bootstrap over frames 0..4 (the bench
operating point), then one ``step`` a frame, each checked.  At the first
non-finite frame: its status and inliers, and on the step's input state
the landmarks eligible for the window (seen by their current slot tenant in
>= ``ba.min_obs`` ring rows), the most observations, their depth range in
the camera, whether the input pose and ring were finite, and the largest
landmark coordinate.  One JSON line; ``first_nonfinite_frame`` is ``null``
when every frame stays finite, as the JAX tool's "no NaN" line.

    python -m monocular_visual_odometry_va4mr_torch.tools.diag_ba [every] [frames]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from . import bench, harness


def make_vo(scene, every, device):
    from ..core.camera import Camera
    from ..core.config import kitti_config
    from ..pipeline.vo import VisualOdometry

    cfg = kitti_config().replace(image_shape=scene.image_shape,
                                 bootstrap_method="klt")
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.03),
        ba=dataclasses.replace(cfg.ba, every=every))
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)


def window_stats(vo, prev):
    """The window that fed the step after ``prev``."""
    n = lambda t: t.cpu().numpy()  # noqa: E731
    gen, bag, bam = n(prev.lm_gen), n(prev.ba_gen), n(prev.ba_mask)
    mw = bam & (bag == gen[None, :])
    n_obs = mw.sum(0)
    part = (n_obs >= vo.config.ba.min_obs) & n(prev.lm_valid)
    Xp, Tc = n(prev.lm_xyz), n(prev.T_CW)
    Z = (Xp @ Tc[:3, :3].T + Tc[:3, 3])[:, 2]
    return dict(
        eligible=int(part.sum()), n_obs_max=int(n_obs.max()),
        depth_min=float(Z[part].min()) if part.any() else None,
        depth_max=float(Z[part].max()) if part.any() else None,
        prev_T_finite=bool(np.all(np.isfinite(Tc))),
        prev_ba_T_finite=bool(np.all(np.isfinite(n(prev.ba_T)))),
        lm_xyz_abs_max=float(np.abs(Xp[part]).max()) if part.any() else None)


def diagnose(vo, frames, n):
    """Step frames 5..n-1; the first non-finite frame and its window."""
    from ..pipeline import runner

    dev = vo.device
    b = bench.BOOTSTRAP_STRIDE
    up = [torch.as_tensor(f).to(dev) for f in frames[:n]]
    st = vo.bootstrap(up[0], up[b], intermediate=up[1:b],
                      generator=runner.frame_generator(0, 0, dev))
    runs0 = vo.ba_runs
    for i in range(b + 1, n):
        prev = st
        st = vo.step(st, up[i], generator=runner.frame_generator(0, i, dev))
        lmv = st.lm_valid.cpu().numpy()
        fin_T = bool(torch.isfinite(st.T_CW).all())
        fin_X = bool(np.all(np.isfinite(st.lm_xyz.cpu().numpy()[lmv])))
        if not (fin_T and fin_X):
            return dict(first_nonfinite_frame=i, finite_T=fin_T,
                        finite_X=fin_X, status=int(st.status),
                        n_inliers=int(st.n_inliers),
                        ba_runs=vo.ba_runs - runs0,
                        window=window_stats(vo, prev))
    return dict(first_nonfinite_frame=None, final_status=int(st.status),
                ba_runs=vo.ba_runs - runs0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("every", type=int, nargs="?", default=4,
                    help="in-step BA cadence (default 4)")
    ap.add_argument("frames", type=int, nargs="?", default=60,
                    help="frames of the bench scene (default 60)")
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    scene, frames = bench.render_scene()
    n = min(args.frames, len(frames))
    vo = make_vo(scene, args.every, device)
    res = diagnose(vo, frames, n)
    harness.emit(dict(every=args.every, frames=n, tracker=vo.klt_backend,
                      **res, **fields))
    return 0


if __name__ == "__main__":
    sys.exit(main())
