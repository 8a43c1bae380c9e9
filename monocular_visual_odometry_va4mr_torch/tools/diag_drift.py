"""Drift instrumentation, counterpart of ``tools/diag_drift.py``: per frame,
the pose error at metric scale and the landmarks' reprojection error under
the GROUND-TRUTH pose, which tells a tracker feeding bad pixels from a map
holding bad 3D points from PnP producing bad poses.

The textured scene (seed 11, ``--frames`` 45 at 480x640 by default) under
the preset (``--preset``, ``parking``) with the KLT bootstrap over frames
0..``--stride``, ``quality_level=0.03`` and the tracker ``--backend``
(``xla`` by default, as the JAX tool; ``pallas2`` / ``pallas`` run the
kernels on the card).  The map is scaled by the ground-truth bootstrap
baseline.  One JSON line a frame: landmarks, inliers, candidates,
promotions, the promotion gates on the previous state's candidates (old
enough, wide enough), status, pose error and step length (m), and the
landmarks' reprojection error under the true pose (median, p90) with their
median depth.  The first line is the bootstrap's.

``--root R --start S`` reads the frames S.. of a KITTI-layout sequence
instead (``tools/make_kitti_seq.py``'s, with its ground-truth poses and
``load_kitti``'s K), to look into a stretch of the long stream; frame
numbers are the sequence's, the pose error is measured from frame S.

    python -m monocular_visual_odometry_va4mr_torch.tools.diag_drift \\
        [--backend xla] [--frames 45] [--preset parking] [--root R --start S]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from . import harness

SEED = 11
QUALITY = 0.03


def make_vo(scene, preset, backend, device, quality=QUALITY):
    from ..core.camera import Camera
    from ..core.config import PRESETS
    from ..pipeline.vo import VisualOdometry

    cfg = PRESETS[preset]().replace(image_shape=scene.image_shape,
                                    bootstrap_method="klt")
    cfg = cfg.replace(
        klt=dataclasses.replace(cfg.klt, backend=backend),
        detector=dataclasses.replace(cfg.detector, quality_level=quality))
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, device, seed=0)


def frame_row(vo, scene, i, prev, state, s, prev_pos):
    """The JAX tool's per-frame quantities."""
    from ..ops import triangulate as tri

    n = lambda t: t.cpu().numpy()  # noqa: E731
    cfg = vo.config
    T_CW = n(state.T_CW).astype(np.float64)
    est_pos = -T_CW[:3, :3].T @ T_CW[:3, 3] * s
    gt_pos = scene.poses_WC[i][:3, 3]
    pv = n(prev.cand_valid)
    age_p = prev.host_frame_idx() + 1 - n(prev.cand_first_frame)
    ang = n(tri.bearing_angle_deg(vo.cam, prev.cand_first_uv, state.cand_uv,
                                  prev.cand_T_CW_first[:, :3, :3],
                                  state.T_CW[:3, :3]))
    lv = n(state.lm_valid)
    X = n(state.lm_xyz)[lv].astype(np.float64) * s
    uv = n(state.lm_uv)[lv]
    T_gt = scene.pose_CW(i)
    Xc = X @ T_gt[:3, :3].T + T_gt[:3, 3]
    z = Xc[:, 2]
    K = scene.K
    pu = K[0, 0] * Xc[:, 0] / np.maximum(z, 1e-6) + K[0, 2]
    pv_ = K[1, 1] * Xc[:, 1] / np.maximum(z, 1e-6) + K[1, 2]
    rp = np.sqrt((pu - uv[:, 0]) ** 2 + (pv_ - uv[:, 1]) ** 2)
    ok = z > 0.5
    return est_pos, dict(
        frame=i, lm=int(lv.sum()), inl=int(state.n_inliers),
        cand=int(n(state.cand_valid).sum()),
        promo=int((n(state.lm_gen) > n(prev.lm_gen)).sum()),
        old=int((pv & (age_p > cfg.landmarks.min_baseline_frames)).sum()),
        ang_ok=int((pv & (ang >= cfg.landmarks.min_baseline_angle_deg))
                   .sum()),
        st=int(state.status),
        pose_err=float(np.linalg.norm(est_pos - gt_pos)),
        step=(float(np.linalg.norm(est_pos - prev_pos))
              if prev_pos is not None else None),
        lm_gt_reproj_med=float(np.median(rp[ok])) if ok.any() else None,
        lm_gt_reproj_p90=(float(np.percentile(rp[ok], 90)) if ok.any()
                          else None),
        zmed=float(np.median(z[ok])) if ok.any() else None)


class SequenceScene:
    """Frames ``start``.. of a KITTI-layout sequence as a scene: frame i of
    the stretch is the sequence's frame ``start + i``, its poses rebased so
    that frame ``start`` is the world origin."""

    def __init__(self, spec, start, frames):
        T = np.tile(np.eye(4), (frames, 1, 1))
        T[:, :3, :] = spec.gt_poses[start:start + frames]
        self.poses_WC = np.linalg.inv(T[0]) @ T
        self.K = spec.K
        self.image_shape = spec.load_frame(start).shape
        self.images = [spec.load_frame(start + i) for i in range(frames)]

    def pose_CW(self, i):
        return np.linalg.inv(self.poses_WC[i])


def drift(backend="xla", frames=45, image_shape=(480, 640), stride=4,
          quality=QUALITY, seed=SEED, preset="parking", device="cuda",
          root=None, start=0):
    """The bootstrap line, then one line a frame."""
    from ..dataio import datasets, synthetic
    from ..pipeline import runner

    if root is None:
        scene = synthetic.make_textured_scene(
            seed=seed, num_frames=frames, image_shape=image_shape, step=1.0)
        imgs = synthetic.render_all_cached(
            scene, f"textured-s{seed}-f{frames}-{image_shape[0]}x"
            f"{image_shape[1]}",
            render=lambda sc: harness.render_frames(sc, frames))
    else:
        scene = SequenceScene(datasets.load_kitti(root, "05"), start, frames)
        imgs = scene.images
    vo = make_vo(scene, preset, backend, device, quality)
    dev = vo.device
    up = [torch.as_tensor(f).to(dev) for f in imgs]
    state = vo.bootstrap(up[0], up[stride], intermediate=up[1:stride],
                         generator=runner.frame_generator(0, 0, dev))
    # Bootstrap translation is unit-norm; the true baseline is metres.
    s = float(np.linalg.norm(scene.poses_WC[stride][:3, 3]
                             - scene.poses_WC[0][:3, 3]))
    rows = [dict(bootstrap=True, lm=int(state.lm_valid.sum()), scale=s,
                 tracker=vo.klt_backend, start=start)]
    prev_pos = None
    for i in range(stride + 1, frames):
        prev = state
        state = vo.step(state, up[i],
                        generator=runner.frame_generator(0, i, dev))
        prev_pos, r = frame_row(vo, scene, i, prev, state, s, prev_pos)
        r["frame"] += start
        rows.append(r)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="xla")
    ap.add_argument("--frames", type=int, default=45)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--preset", default="parking")
    ap.add_argument("--root", default=None,
                    help="a KITTI-layout sequence to read instead of the "
                         "textured scene")
    ap.add_argument("--start", type=int, default=0,
                    help="with --root: the first frame of the stretch")
    harness.add_device_arg(ap)
    a = ap.parse_args(argv)
    device = harness.resolve_device(a.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    for r in drift(backend=a.backend, frames=a.frames, stride=a.stride,
                   image_shape=(a.height, a.width), preset=a.preset,
                   device=device, root=a.root, start=a.start):
        harness.emit({**r, **fields})
    return 0


if __name__ == "__main__":
    sys.exit(main())
