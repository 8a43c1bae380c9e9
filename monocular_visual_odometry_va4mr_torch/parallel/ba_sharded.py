"""Distributed bundle adjustment: landmarks sharded over the ranks, the
reduced camera system all-reduced (port of ``parallel/ba_sharded.py``).

Decomposition (see ``backend/ba.py`` for the math):
  * the landmark axis L is embarrassingly parallel for everything except the
    reduced camera system: Hpp (3x3 blocks), Hcp, b_p and the landmark
    back-substitution touch only local landmarks;
  * the only cross-rank quantities are S (W,W,6,6), rhs (W,6) and the cost,
    summed by ONE all-reduce of one packed float32 buffer per Gauss-Newton
    iteration: 4 * (36 W^2 + 6 W + 1) bytes, independent of L.

Each rank runs the same solve on the same summed system, so every rank
holds the same poses; each keeps its own landmark block.  The camera
damping goes on rank 0's S only, so the summed system is the single-device
one.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..backend import ba
from ..core.camera import Camera
from . import multihost


def shard_window(window: ba.BAWindow, rank: int, world: int) -> ba.BAWindow:
    """Rank ``rank``'s block of the landmark axis: ceil(L / world) landmarks,
    the last block padded with unobserved zero landmarks (they take a zero
    update), poses whole."""
    L = window.lm_xyz.shape[0]
    n = -(-L // world)
    lo, hi = rank * n, min((rank + 1) * n, L)
    pad = n - max(hi - lo, 0)

    def block(x, axis):
        x = x.narrow(axis, min(lo, L), max(hi - lo, 0))
        if pad:
            shape = list(x.shape)
            shape[axis] = pad
            x = torch.cat([x, x.new_zeros(shape)], axis)
        return x

    return ba.BAWindow(T_CW=window.T_CW, lm_xyz=block(window.lm_xyz, 0),
                       obs_uv=block(window.obs_uv, 1),
                       obs_mask=block(window.obs_mask, 1))


def run_ba_sharded(window_local: ba.BAWindow, cam: Camera, *, group=None,
                   iters: int = 5, huber_px: float = 3.0,
                   damping: float = 1e-4, n_fixed: int = 2):
    """``backend.ba.run_ba`` over the landmark blocks of the group's ranks;
    each rank passes its block (``shard_window``).  Returns (the window
    with the refined poses and this rank's refined landmarks, costs (iters,)
    summed over ranks)."""
    rank = dist.get_rank(group)
    W = window_local.T_CW.shape[0]
    window = window_local
    costs = []
    for _ in range(iters):
        S, rhs, Hpp_inv, Hcp, b_p, cost = ba.build_normal_blocks(
            window, cam, huber_px=huber_px, damping=damping,
            camera_damping=damping if rank == 0 else 0.0)
        # The only collective: the camera system and the cost, packed.
        packed = multihost.all_reduce(
            torch.cat([S.reshape(-1), rhs.reshape(-1), cost.reshape(1)]),
            group)
        S = packed[:36 * W * W].reshape(W, W, 6, 6)
        rhs = packed[36 * W * W:-1].reshape(W, 6)
        delta_c = ba.solve_camera_system(S, rhs, n_fixed=n_fixed)
        window = ba.apply_updates(window, delta_c, Hpp_inv, Hcp, b_p)
        costs.append(packed[-1])
    return window, torch.stack(costs)
