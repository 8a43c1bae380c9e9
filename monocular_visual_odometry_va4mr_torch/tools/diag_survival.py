"""Track-survival probe, counterpart of ``tools/diag_survival.py``: detect
corners at frame ``--f0``, chain-track them over consecutive frames with a
forward-backward check, and report per hop how many survive and where the
others die (the forward gate or the round trip).

The textured scene (seed 11, 80 frames at 480x640); Shi-Tomasi corners
(1024, ``--quality``, cell 10).  ``--backend pallas2`` (the default) or
``pallas`` runs the step's tracker, the multilevel chain on the flat
pyramid (``klt_pallas2.track_multilevel``: /16 prior, /4 and full-res LK,
8 iterations) with the ``klt_lk`` or ``klt_v1`` kernel on the card (their
plain versions on the CPU); ``xla`` runs the gather tracker on a 5-level
Gaussian pyramid (window 15, 20 iterations).  The JAX tool picks the kernel
chain only on a TPU and the gather tracker elsewhere; here the backend
picks.

One JSON line a hop (``alive``, ``fwd_ok``, ``back_ok``, ``fb_pass``,
``fb_med``: the median round-trip error in px), after a line with the
starting corners and the kernels' launches.

    python -m monocular_visual_odometry_va4mr_torch.tools.diag_survival \\
        [--f0 10] [--hops 8] [--backend pallas2]
"""
from __future__ import annotations

import argparse
import sys

import torch

from . import harness

SEED = 11
NUM_FRAMES = 80
IMAGE_SHAPE = (480, 640)


def survival(f0=10, hops=8, image_shape=IMAGE_SHAPE, seed=SEED,
             num_frames=NUM_FRAMES, quality=0.03, fb_thresh=1.0,
             backend="pallas2", device="cuda"):
    """The start line, then one line a hop."""
    from ..dataio import synthetic
    from ..ops import corners, image as imops, klt, klt_pallas, klt_pallas2

    scene = synthetic.make_textured_scene(seed=seed, num_frames=num_frames,
                                          image_shape=image_shape, step=1.0)
    frames = synthetic.render_all_cached(
        scene, f"textured-s{seed}-f{num_frames}-{image_shape[0]}x"
        f"{image_shape[1]}",
        render=lambda sc: harness.render_frames(sc, num_frames))
    dev = torch.device(device)
    chain = backend != "xla"

    def pyr(i):
        img = torch.as_tensor(frames[i], dtype=torch.float32).to(dev)
        return (imops.build_flat_pyramid(img, 16) if chain
                else imops.build_pyramid(img, 5))

    def track(p0, p1, pts, valid):
        if chain:
            fn = (klt_pallas2.track_features_pallas2 if backend == "pallas2"
                  else klt_pallas.track_features_pallas)
            return klt_pallas2.track_multilevel(
                p0, p1, pts, valid, track_fn=fn, num_iters=8, eps=0.02,
                min_eig_threshold=1e-4, max_residual=20.0)
        return klt.track_features(p0, p1, pts, valid, window=15,
                                  num_iters=20, eps=0.02,
                                  min_eig_threshold=1e-4, max_residual=20.0)

    img0 = torch.as_tensor(frames[f0], dtype=torch.float32).to(dev)
    uv, _, valid = corners.detect_corners(img0, max_corners=1024,
                                          quality_level=quality, cell=10,
                                          block_size=3, use_harris=False,
                                          harris_k=0.04)
    klt_pallas2.klt_lk.launches = klt_pallas.klt_v1.launches = 0
    rows = [dict(start=int(valid.sum()),
                 tracker=f"ml-{backend}" if chain else "xla")]
    p_prev, pts, ok = pyr(f0), uv, valid
    for h in range(hops):
        p_next = pyr(f0 + h + 1)
        new_pts, fwd_ok, _ = track(p_prev, p_next, pts, ok)
        back_pts, back_ok, _ = track(p_next, p_prev, new_pts, fwd_ok)
        fb2 = torch.sum((back_pts - pts) ** 2, -1)
        both = fwd_ok & back_ok
        fb_pass = both & (fb2 < fb_thresh ** 2)
        rows.append(dict(
            hop=h, alive=int(ok.sum()), fwd_ok=int(fwd_ok.sum()),
            back_ok=int(both.sum()), fb_pass=int(fb_pass.sum()),
            fb_med=(float(torch.median(torch.sqrt(fb2[both])))
                    if both.any() else None)))
        pts, ok, p_prev = new_pts, fb_pass, p_next
    rows[0].update(klt_lk_launches=klt_pallas2.klt_lk.launches,
                   klt_v1_launches=klt_pallas.klt_v1.launches)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f0", type=int, default=10)
    ap.add_argument("--hops", type=int, default=8)
    ap.add_argument("--quality", type=float, default=0.03)
    ap.add_argument("--fb", type=float, default=1.0)
    ap.add_argument("--backend", default="pallas2",
                    choices=["pallas2", "pallas", "xla"])
    harness.add_device_arg(ap)
    a = ap.parse_args(argv)
    device = harness.resolve_device(a.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    for r in survival(f0=a.f0, hops=a.hops, image_shape=IMAGE_SHAPE,
                      num_frames=NUM_FRAMES, quality=a.quality,
                      fb_thresh=a.fb, backend=a.backend, device=device):
        harness.emit({**r, **fields})
    return 0


if __name__ == "__main__":
    sys.exit(main())
