"""Tracker A/B of the port, counterpart of ``tools/diag_tracker.py``:
``pallas2``, ``pallas`` and ``xla`` on the same corners of one frame pair of
the textured scene (seed 11, pair (10, 11), 480x640).

Every tracker starts from the same Shi-Tomasi corners (512, quality 0.03,
cell 10).  Reported per tracker: features accepted, and the error of the
accepted ones against the exact ground-truth flow (``gt_flow``: the depth of
each pixel ray-cast in the first frame, reprojected into the second; every
pixel of a textured plane has one) and against the ``xla`` oracle (the
gather tracker over a 5-level Gaussian pyramid, window 15, 20 iterations).
Trackers: ``xla``; ``pallas`` and ``pallas2`` (one level at full
resolution behind the /16 coarse prior, 8 iterations); ``pallas2_ml`` (the
/16 -> /4 -> full chain the step runs); ``pallas2_fb`` and ``xla_fb`` (with
the forward-backward check of ``pipeline/vo.py``, 1 px).  On the card the
kernel trackers launch their CUDA kernels; with ``--device cpu`` the
wrappers run their plain versions.

Prints one JSON object: the corner count, the ground-truth flow's median,
p90 and max (px), and for each tracker ``accepted``, ``gt_overlap``,
``err_vs_gt_median``, ``err_vs_gt_p90``, ``err_vs_gt_over_3px`` (the JAX
tool's columns) and ``err_vs_xla_median`` / ``_p90`` / ``_max`` over the
features both accept.

    python -m monocular_visual_odometry_va4mr_torch.tools.diag_tracker \\
        [--f0 10 --f1 11 --height 480 --width 640]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import harness

LK = dict(eps=0.01, min_eig_threshold=1e-4, max_residual=20.0)


def gt_flow(scene, frame0, frame1, uv):
    """Exact correspondence of pixels ``uv`` of ``frame0`` in ``frame1``:
    the first surface each pixel's ray hits (ground, walls, pillars),
    reprojected.  Returns ((N, 2) positions, (N,) hit mask)."""
    K = scene.K
    T0 = scene.poses_WC[frame0]
    T1_CW = scene.pose_CW(frame1)
    d_cam = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0],
                      (uv[:, 1] - K[1, 2]) / K[1, 1],
                      np.ones(len(uv))], axis=-1)
    d = d_cam @ T0[:3, :3].T
    cam = T0[:3, 3]
    INF = 1e18
    best_t = np.full(len(uv), INF)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (scene.ground_y - cam[1]) / d[:, 1]
        ok = (d[:, 1] > 1e-9) & (t > 0.2)
        best_t = np.where(ok & (t < best_t), t, best_t)
        for sgn in (-1.0, 1.0):
            t = (sgn * scene.half_width - cam[0]) / d[:, 0]
            p = cam + t[:, None] * d
            ok = ((np.abs(d[:, 0]) > 1e-9) & (t > 0.2)
                  & (p[:, 1] < scene.ground_y))
            best_t = np.where(ok & (t < best_t), t, best_t)
        for pz, x0, x1, y0, y1 in scene.pillars:
            t = (pz - cam[2]) / d[:, 2]
            p = cam + t[:, None] * d
            ok = ((np.abs(d[:, 2]) > 1e-9) & (t > 0.2)
                  & (p[:, 0] >= x0) & (p[:, 0] <= x1)
                  & (p[:, 1] >= y0) & (p[:, 1] <= y1))
            best_t = np.where(ok & (t < best_t), t, best_t)
    X = cam + best_t[:, None] * d
    Xc = X @ T1_CW[:3, :3].T + T1_CW[:3, 3]
    z = Xc[:, 2]
    u1 = K[0, 0] * Xc[:, 0] / z + K[0, 2]
    v1 = K[1, 1] * Xc[:, 1] / z + K[1, 2]
    return np.stack([u1, v1], -1), best_t < INF


def track_all(f0, f1, uv, valid):
    """{tracker: (positions, ok)} as numpy, on the device of ``f0``."""
    from ..ops import image as imops
    from ..ops import klt, klt_pallas, klt_pallas2

    multi0, multi1 = imops.build_pyramid(f0, 5), imops.build_pyramid(f1, 5)
    flat0 = imops.build_flat_pyramid(f0, 16)
    flat1 = imops.build_flat_pyramid(f1, 16)

    def np_(p, ok):
        return p.cpu().numpy(), ok.cpu().numpy()

    out = {}
    p, ok, _ = klt.track_features(multi0, multi1, uv, valid, window=15,
                                  num_iters=20, **LK)
    out["xla"] = np_(p, ok)
    for name, fn in (("pallas", klt_pallas.track_features_pallas),
                     ("pallas2", klt_pallas2.track_features_pallas2)):
        p, ok, _ = fn(flat0, flat1, uv, valid, num_iters=8, **LK)
        out[name] = np_(p, ok)
    p, ok, _ = klt_pallas2.track_multilevel(flat0, flat1, uv, valid,
                                            num_iters=8, **LK)
    out["pallas2_ml"] = np_(p, ok)
    pb, okb, _ = klt_pallas2.track_multilevel(flat1, flat0, p, ok,
                                              num_iters=8, **LK)
    fb2 = torch.sum((pb - uv) ** 2, -1)
    out["pallas2_fb"] = np_(p, ok & okb & (fb2 < 1.0))
    px, okx = (torch.as_tensor(a, device=uv.device) for a in out["xla"])
    pb, okb, _ = klt.track_features(multi1, multi0, px, okx, window=15,
                                    num_iters=20, **LK)
    fb2 = torch.sum((pb - uv) ** 2, -1)
    out["xla_fb"] = np_(px, okx & okb & (fb2 < 1.0))
    return out


def errors(p, ok, ref, ref_ok):
    """Median, p90 and count over 3 px of ``|p - ref|`` where both hold."""
    m = ok & ref_ok
    err = np.linalg.norm(p - ref, axis=1)[m]
    if not m.any():
        return int(m.sum()), None, None, None, 0
    return (int(m.sum()), float(np.median(err)),
            float(np.percentile(err, 90)), float(err.max()),
            int((err > 3).sum()))


def diagnose(pair=(10, 11), image_shape=(480, 640), seed=11, num_frames=20,
             device="cuda"):
    from ..dataio import synthetic
    from ..ops import corners

    scene = synthetic.make_textured_scene(seed=seed, num_frames=num_frames,
                                          image_shape=image_shape, step=1.0)
    f0 = torch.as_tensor(scene.render(pair[0])).to(device, torch.float32)
    f1 = torch.as_tensor(scene.render(pair[1])).to(device, torch.float32)
    uv_t, _, valid_t = corners.detect_corners(
        f0, max_corners=512, quality_level=0.03, cell=10, block_size=3,
        use_harris=False, harris_k=0.04)
    uv, valid = uv_t.cpu().numpy(), valid_t.cpu().numpy()
    gt, gt_ok = gt_flow(scene, pair[0], pair[1], uv)
    mag = np.linalg.norm(gt - uv, axis=1)[valid & gt_ok]
    res = dict(pair=list(pair), image_shape=list(image_shape), seed=seed,
               corners=int(valid.sum()),
               gt_flow_px=dict(median=float(np.median(mag)),
                               p90=float(np.percentile(mag, 90)),
                               max=float(mag.max())),
               trackers={})
    results = track_all(f0, f1, uv_t, valid_t)
    px, okx = results["xla"]
    for name, (p, ok) in results.items():
        n_gt, med, p90, _, over3 = errors(p, ok, gt, gt_ok)
        n_x, xmed, xp90, xmax, _ = errors(p, ok, px, okx)
        res["trackers"][name] = dict(
            accepted=int(ok.sum()), gt_overlap=n_gt, err_vs_gt_median=med,
            err_vs_gt_p90=p90, err_vs_gt_over_3px=over3, xla_overlap=n_x,
            err_vs_xla_median=xmed, err_vs_xla_p90=xp90, err_vs_xla_max=xmax)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f0", type=int, default=10)
    ap.add_argument("--f1", type=int, default=11)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    res = diagnose((args.f0, args.f1), (args.height, args.width),
                   device=device)
    res["device"] = harness.device_label(device)
    harness.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
