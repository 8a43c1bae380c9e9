"""The windowed BA at the in-step sizes, timed on one device, counterpart
of ``tools/profile_ba.py``.

A plausible window (W=10 poses moving 1 m a frame along +z, L=256
landmarks 5-60 m ahead, exact observations, landmarks displaced by 0.05 m)
at the KITTI camera.  Rows: ``run_ba`` with 2 and 1 Gauss-Newton iterations
(``n_fixed=2``), its stages alone on the same window
(``build_normal_blocks``, ``solve_camera_system``, ``apply_updates``), then
``run_ba`` with 2 iterations on the L=1024 window (the 256 landmarks four
times), the size without the in-step compaction.  The JAX tool drew the
landmarks with ``jax.random``; here numpy draws them from the same
distributions (seed 0).

Each row: ``ms``, the median host time of 20 calls with a device sync
around each (``harness.host_ms``), and from ``torch.profiler`` over 3 calls
``device_ms`` and ``launches`` (device events) per call; both ``null`` on
the CPU.  One JSON line per row.

    python -m monocular_visual_odometry_va4mr_torch.tools.profile_ba
"""
from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from . import harness

W, L, L_FULL = 10, 256, 1024
KITTI_CAM = (718.856, 718.856, 607.19, 185.22)  # fx, fy, cx, cy


def make_window(device, W=W, L=L, seed=0):
    """(BAWindow, Camera): the JAX tool's forward-motion window."""
    from ..backend import ba
    from ..core.camera import Camera

    cam = Camera(*KITTI_CAM)
    rng = np.random.default_rng(seed)
    lm = np.stack([rng.uniform(-20, 20, L), rng.uniform(-5, 5, L),
                   rng.uniform(5, 60, L)], -1).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
    T[:, 2, 3] = -np.arange(W, dtype=np.float32)
    Xc = np.einsum("wij,lj->wli", T[:, :3, :3], lm) + T[:, None, :3, 3]
    uv = np.stack([cam.fx * Xc[..., 0] / Xc[..., 2] + cam.cx,
                   cam.fy * Xc[..., 1] / Xc[..., 2] + cam.cy],
                  -1).astype(np.float32)
    mask = Xc[..., 2] > 1.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ba.BAWindow(T_CW=t(T), lm_xyz=t(lm + 0.05), obs_uv=t(uv),
                       obs_mask=t(mask)), cam


def tile_window(win, reps):
    """The window with its landmarks ``reps`` times over."""
    from ..backend import ba

    return ba.BAWindow(T_CW=win.T_CW, lm_xyz=win.lm_xyz.repeat(reps, 1),
                       obs_uv=win.obs_uv.repeat(1, reps, 1),
                       obs_mask=win.obs_mask.repeat(1, reps))


def row(name, fn, device, **extra):
    """One row: host ms, and device ms, launches (device events) and host
    dispatches per call on the card."""
    ms = harness.host_ms(fn, device)
    dev_ms = launches = dispatches = None
    if torch.device(device).type == "cuda":
        dev_ms, launches, dispatches = harness.profile_calls(fn)
    return dict(case=name, ms=ms, device_ms=dev_ms, launches=launches,
                dispatches=dispatches, **extra)


def profile(device):
    from ..backend import ba

    win, cam = make_window(device)
    ba2 = functools.partial(ba.run_ba, iters=2, n_fixed=2)
    ba1 = functools.partial(ba.run_ba, iters=1, n_fixed=2)
    rows = [row("run_ba", lambda: ba2(win, cam), device, W=W, L=L, iters=2),
            row("run_ba", lambda: ba1(win, cam), device, W=W, L=L, iters=1)]
    S, rhs, Hpp_inv, Hcp, b_p, _ = ba.build_normal_blocks(win, cam)
    delta_c = ba.solve_camera_system(S, rhs, n_fixed=2)
    rows += [
        row("build_normal_blocks",
            lambda: ba.build_normal_blocks(win, cam), device, W=W, L=L),
        row("solve_camera_system",
            lambda: ba.solve_camera_system(S, rhs, n_fixed=2), device, W=W,
            L=L),
        row("apply_updates",
            lambda: ba.apply_updates(win, delta_c, Hpp_inv, Hcp, b_p),
            device, W=W, L=L)]
    full = tile_window(win, L_FULL // L)
    rows.append(row("run_ba", lambda: ba2(full, cam), device, W=W, L=L_FULL,
                    iters=2))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    for r in profile(device):
        harness.emit({**r, **fields})
    return 0


if __name__ == "__main__":
    sys.exit(main())
