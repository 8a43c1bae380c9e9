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

The loop is ``core.graphs.scan`` of :func:`gn_iteration`, the
counterpart of the reference's ``lax.scan`` inside its ``shard_map``: on a
CUDA device one graph of the iteration, its all-reduce inside, replayed
once an iteration; on the CPU (gloo) and inside ``core.graphs.eager()``
the iteration op by op, with the same bits.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..backend import ba
from ..core import graphs
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


def gn_iteration(cam: Camera, huber_px: float, damping: float,
                 n_fixed: int, first: bool, group, T_CW, lm_xyz, obs_uv,
                 obs_mask):
    """One Gauss-Newton iteration of :func:`run_ba_sharded` on this rank's
    landmark block, the body of its loop: ((new T_CW, new lm_xyz), (cost
    summed over the ranks,)).  ``first``: whether this rank puts the
    camera damping on S (rank 0).  It reads nothing on the host, so a
    CUDA graph holds it with its all-reduce."""
    window = ba.BAWindow(T_CW, lm_xyz, obs_uv, obs_mask)
    W = T_CW.shape[0]
    S, rhs, Hpp_inv, Hcp, b_p, cost = ba.build_normal_blocks(
        window, cam, huber_px=huber_px, damping=damping,
        camera_damping=damping if first else 0.0)
    # The only collective: the camera system and the cost, packed.
    packed = multihost.all_reduce(
        torch.cat([S.reshape(-1), rhs.reshape(-1), cost.reshape(1)]), group)
    S = packed[:36 * W * W].reshape(W, W, 6, 6)
    rhs = packed[36 * W * W:-1].reshape(W, 6)
    delta_c = ba.solve_camera_system(S, rhs, n_fixed=n_fixed)
    window = ba.apply_updates(window, delta_c, Hpp_inv, Hcp, b_p)
    return (window.T_CW, window.lm_xyz), (packed[-1],)


def run_ba_sharded(window_local: ba.BAWindow, cam: Camera, *, group=None,
                   iters: int = 5, huber_px: float = 3.0,
                   damping: float = 1e-4, n_fixed: int = 2):
    """``backend.ba.run_ba`` over the landmark blocks of the group's ranks;
    each rank passes its block (``shard_window``).  Returns (the window
    with the refined poses and this rank's refined landmarks, costs (iters,)
    summed over ranks).

    On a CUDA device one graph of :func:`gn_iteration` per camera,
    ``huber_px``, ``damping``, ``n_fixed``, rank 0 or not, process group
    (a graph holds its NCCL communicator) and shapes, replayed ``iters``
    times: every rank captures at its first call of a key, so the ranks
    call alike."""
    pg = group if group is not None else dist.group.WORLD
    first = dist.get_rank(group) == 0
    body = functools.partial(gn_iteration, cam, float(huber_px),
                             float(damping), n_fixed, first, group)
    (T_CW, lm_xyz), (costs,) = graphs.scan(
        ("ba_sharded", cam, float(huber_px), float(damping), n_fixed, first,
         pg), body, (window_local.T_CW, window_local.lm_xyz),
        (window_local.obs_uv, window_local.obs_mask), iters)
    return window_local._replace(T_CW=T_CW, lm_xyz=lm_xyz), costs
