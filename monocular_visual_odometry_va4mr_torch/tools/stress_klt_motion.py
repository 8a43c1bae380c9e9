"""Tracker stress under growing motion, counterpart of
``tools/stress_klt_motion.py``: where the ``pallas2`` multilevel chain
leaves the ``xla`` oracle at the Malaga geometry (600x800).

A pure camera yaw moves the image almost uniformly sideways, so each pair is
a crop of one wide render (seed-5 textured scene, 600x1408) and the same
crop shifted by ``dx`` px: the exact flow is (dx, 0).  512 points drawn from
a seeded generator are tracked for dx in 20..280 px by the chain the step
runs (/16 coarse prior, /4 LK, full-res LK; 8 iterations) and by the
gather tracker over a 6-level pyramid (window 15, 20 iterations, the
cv2-style envelope).  The coarse prior searches +-10 px at /16, so the
chain's envelope is 160 px.

Per dx one JSON line: for each tracker ``accepted``, ``good`` (accepted
within 1 px), ``gross_outliers`` (accepted and over 3 px off) and
``median_err_px``.  Then the JAX tool's summary: healthy inside the envelope
(``good`` > 60% and gross outliers < 3.5% of the points at dx <= 160) and
bounded beyond it (gross outliers < 8% at dx > 180), plus
``pallas2_cliff_dx``, the first dx where the chain's ``good`` falls under
60% of the points.  Exit code 2 when either fails, as the JAX tool.

    python -m monocular_visual_odometry_va4mr_torch.tools.stress_klt_motion
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import harness

SHAPE = (600, 1408)  # wide render: 800-wide crops stay textured to 300 px
MARGIN = 304
N = 512
DXS = (20, 40, 80, 120, 150, 160, 180, 220, 280)
ENVELOPE_PX = 160


def base_frame(shape=None):
    """The wide render the crops are cut from (float32)."""
    from ..dataio import synthetic

    scene = synthetic.make_textured_scene(
        seed=5, num_frames=2, image_shape=shape or SHAPE, step=0.0)
    return np.asarray(scene.render(0), np.float32)


def yaw_pair(base, dx, margin=None):
    """(i0, i1): a crop of ``base`` and the crop whose content moved +dx
    px."""
    m = MARGIN if margin is None else margin
    W = base.shape[1]
    return base[:, m:W - m], base[:, m - dx:W - m - dx]


def points(i0, n=None):
    rng = np.random.default_rng(0)
    n = N if n is None else n
    return np.stack([rng.uniform(40, i0.shape[1] - 40, n),
                     rng.uniform(40, i0.shape[0] - 40, n)],
                    1).astype(np.float32)


def stats(out, ok, gt):
    ok = ok.cpu().numpy()
    err = np.linalg.norm(out.cpu().numpy() - gt, axis=1)
    return {"accepted": int(ok.sum()), "good": int((ok & (err < 1.0)).sum()),
            "gross_outliers": int((ok & (err > 3.0)).sum()),
            "median_err_px": float(np.median(err[ok])) if ok.any()
            else float("nan")}


def sweep(device, base=None):
    """One row per dx of ``DXS``."""
    from ..ops import image as imops
    from ..ops import klt, klt_pallas2

    base = base_frame() if base is None else base
    i0 = base[:, MARGIN:base.shape[1] - MARGIN]
    pts = points(i0)
    pts_t = torch.as_tensor(pts, device=device)
    valid = torch.ones(len(pts), dtype=torch.bool, device=device)
    t0 = torch.as_tensor(np.ascontiguousarray(i0), device=device)
    rows = []
    for dx in DXS:
        _, i1 = yaw_pair(base, dx)
        t1 = torch.as_tensor(np.ascontiguousarray(i1), device=device)
        out_p, ok_p, _ = klt_pallas2.track_multilevel(
            imops.build_flat_pyramid(t0, 16), imops.build_flat_pyramid(t1, 16),
            pts_t, valid, num_iters=8)
        out_x, ok_x, _ = klt.track_features(
            imops.build_pyramid(t0, 6), imops.build_pyramid(t1, 6), pts_t,
            valid, window=15, num_iters=20, eps=0.01, min_eig_threshold=1e-4,
            max_residual=20.0)
        gt = pts + np.array([dx, 0.0], np.float32)
        rows.append({"dx": dx, "pallas2": stats(out_p, ok_p, gt),
                     "xla": stats(out_x, ok_x, gt)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def verdict(rows, n):
    """The JAX tool's envelope claim on ``rows`` of ``n`` points."""
    inside = [r for r in rows if r["dx"] <= ENVELOPE_PX]
    beyond = [r for r in rows if r["dx"] > 180]
    ok_inside = all(r["pallas2"]["good"] > 0.6 * n
                    and r["pallas2"]["gross_outliers"] < 0.035 * n
                    for r in inside)
    safe_beyond = all(r["pallas2"]["gross_outliers"] < 0.08 * n
                      for r in beyond)
    cliff = next((r["dx"] for r in rows if r["pallas2"]["good"] <= 0.6 * n),
                 None)
    return {"envelope_px": ENVELOPE_PX, "healthy_inside": ok_inside,
            "bounded_beyond": safe_beyond, "pallas2_cliff_dx": cliff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    rows = sweep(device)
    res = verdict(rows, N)
    res["device"] = harness.device_label(device)
    harness.emit(res)
    return 0 if res["healthy_inside"] and res["bounded_beyond"] else 2


if __name__ == "__main__":
    sys.exit(main())
