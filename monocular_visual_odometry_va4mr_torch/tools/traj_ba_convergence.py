"""Iterations to convergence against the segment count D of the
keyframe-sharded trajectory BA (``parallel/traj_ba.py``), counterpart of
``tools/traj_ba_convergence.py``.

``traj_ba`` is block-Jacobi with a one-segment halo an iteration, so a
correction crosses one segment an iteration; this records how many
iterations the distributed solve needs to reach the centralised solution
of the same problem.  The centralised solution: the same observations as
ONE window (``global_window``: the block-sparse mask, the two anchors
frozen), 80 Gauss-Newton iterations at damping 0.1 (``backend.ba.run_ba``).
The distributed solve runs 2, 4, .. ``--max-iters`` iterations, each from
the start, on a world of D ranks (one segment a rank); it has converged
when its camera centres are within ``--tol`` of the centralised ones, or
its error against the ground truth is within 1.1x the centralised one's.

Beside them, the ms of one iteration of the distributed solve (``iters``
iterations, the converged count or ``--max-iters``; the median of
``REPS`` synced calls over ``iters``): ``ms_per_iter`` as it runs (on the
card one replay of the iteration's CUDA graph, its collectives inside,
``replayed`` true) and ``ms_per_iter_eager`` op by op
(``core.graphs.eager()``; on the CPU both are op by op).

Worlds (``harness.run_world``): D = 1 on the card (NCCL; one card has one
rank), D = 1, 2, 4, 8 gloo processes on the CPU.  One JSON line per D with
the JAX tool's keys, then a summary.

    python -m monocular_visual_odometry_va4mr_torch.tools.traj_ba_convergence \\
        [--tol 0.02] [--max-iters 64] [--worlds 1,2,4,8]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import harness

REPS = 5
TIMES = dict(ms_per_iter=None, ms_per_iter_eager=None)


def cam_positions(T_CW):
    T = np.asarray(T_CW, np.float64)
    return np.stack([-t[:3, :3].T @ t[:3, 3] for t in T])


def global_window(noisy, D, S, L):
    """The same problem as one dense-masked window: 2 + D*S poses (the
    anchors first), D*L landmarks, each segment's observations in its rows
    (a segment's halo rows land on its left neighbour's poses)."""
    from ..backend import ba

    n_poses = 2 + D * S
    uv = noisy.obs_uv.cpu().numpy()
    m = noisy.obs_mask.cpu().numpy()
    obs_uv = np.zeros((n_poses, D * L, 2), np.float32)
    obs_mask = np.zeros((n_poses, D * L), bool)
    for d in range(D):
        for r in range(S + 2):
            g = d * S + r
            obs_uv[g, d * L:(d + 1) * L] = uv[d, r]
            obs_mask[g, d * L:(d + 1) * L] = m[d, r]
    return ba.BAWindow(
        T_CW=torch.cat([noisy.anchor_T_CW, noisy.T_CW]).cpu(),
        lm_xyz=noisy.lm_xyz.cpu(), obs_uv=torch.from_numpy(obs_uv),
        obs_mask=torch.from_numpy(obs_mask))


def centralised(noisy, D, S, L, cam, device="cuda"):
    """Camera centres of the local keyframes after the centralised solve."""
    from ..backend import ba

    window = ba.BAWindow(*(t.to(device)
                           for t in global_window(noisy, D, S, L)))
    ref, _ = ba.run_ba(window, cam, iters=80, n_fixed=2, damping=0.1)
    return cam_positions(ref.T_CW.cpu())[2:]


def worker(rank, world, S, L, tol, max_iters, device):
    """One rank: the centralised solve (every rank, so every rank takes the
    same decisions), then the distributed one until it converges."""
    from ..core import graphs
    from ..parallel import multihost, traj_ba

    dev = torch.device(device)
    D = world
    noisy, gt, cam = traj_ba.build_synthetic_traj(D, S, L, seed=1)
    ref_pos = centralised(noisy, D, S, L, cam, dev)
    gt_pos = cam_positions(gt.T_CW)
    ref_gt_err = float(np.abs(ref_pos - gt_pos).max())
    local = traj_ba.shard_segments(noisy, rank, world)
    local = type(local)(*(t.to(dev) for t in local))
    it_needed = dist_last = gt_err_last = None
    for iters in range(2, max_iters + 1, 2):
        out, _ = traj_ba.run_traj_ba(local, cam, iters=iters)
        full = torch.cat(multihost.all_gather(out.T_CW.contiguous()))
        pos = cam_positions(full.cpu())
        dist_last = float(np.abs(pos - ref_pos).max())
        gt_err_last = float(np.abs(pos - gt_pos).max())
        if dist_last < tol or gt_err_last <= 1.1 * ref_gt_err:
            it_needed = iters
            break
    iters = it_needed or max_iters

    def solve():
        return traj_ba.run_traj_ba(local, cam, iters=iters)

    def eager():
        with graphs.eager():
            return solve()

    return {"D": D, "kf": D * S, "iters_to_match_global": it_needed,
            "traj_ba_gt_err": gt_err_last, "global_gt_err": ref_gt_err,
            "dist_to_global": dist_last, "timed_iters": iters,
            "replayed": graphs.replaying(dev),
            "ms_per_iter": harness.host_ms(solve, dev, reps=REPS) / iters,
            "ms_per_iter_eager": harness.host_ms(eager, dev,
                                                 reps=REPS) / iters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tol", type=float, default=0.02)
    ap.add_argument("--max-iters", type=int, default=64)
    ap.add_argument("--segment-kf", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=512)
    ap.add_argument("--worlds", default=None,
                    help="segment counts D, one rank each (default 1 on the "
                         "card, 1,2,4,8 on the CPU)")
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)
    worlds = harness.parse_worlds(args.worlds, device)
    if device.type == "cuda" and max(worlds) > torch.cuda.device_count():
        raise RuntimeError(f"worlds {worlds} need more cards than the "
                           f"{torch.cuda.device_count()} present")
    rows = []
    for D in worlds:
        ranks = harness.run_world(worker, D, args.segment_kf, args.landmarks,
                                  args.tol, args.max_iters, device.type)
        # Each rank times its own calls; everything else is every rank's.
        if any(dict(r, **TIMES) != dict(ranks[0], **TIMES) for r in ranks):
            raise RuntimeError(f"the ranks of D={D} disagree: {ranks}")
        rows.append(ranks[0])
        harness.emit({**ranks[0], **fields})
    its = [r["iters_to_match_global"] for r in rows]
    harness.emit(dict(summary="traj_ba_convergence",
                      D=[r["D"] for r in rows], iters_to_match_global=its,
                      all_converged=all(i is not None for i in its),
                      **fields))
    return 0


if __name__ == "__main__":
    sys.exit(main())
