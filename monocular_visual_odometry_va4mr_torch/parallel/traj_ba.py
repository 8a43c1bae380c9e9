"""Keyframe-axis trajectory bundle adjustment: contiguous keyframe segments,
one per rank, with a boundary-pose halo exchange (port of
``parallel/traj_ba.py``).

Global keyframes 0 .. D*S+1 (D ranks, S per rank + 2 global anchors):
  kf 0,1        — global gauge anchor, frozen everywhere
  rank d owns kf [2+d*S .. 1+(d+1)*S]
  rank d's halo = kf [d*S, d*S+1]
                = the global anchors     (d = 0)
                = rank d-1's last two    (d > 0), sent by rank d-1

Each rank runs Schur-complement Gauss-Newton (``backend/ba.py``) on its
(2 + S)-pose window with the two halo poses frozen (``n_fixed=2`` pins both
the rigid and the monocular-scale gauge of the segment to its left
neighbour).  The halo is exchanged EVERY iteration, so corrections
propagate left to right one segment per iteration: block-Jacobi relaxation.
Communication per iteration and rank: one send and one receive of (2,4,4)
float32 poses, 128 bytes, and one all-reduce of the 4-byte cost.

The loop is ``core.graphs.scan`` of :func:`gn_iteration`: on a CUDA device
one graph of the iteration, the halo exchange and the all-reduce inside,
replayed once an iteration; on the CPU (gloo) and inside
``core.graphs.eager()`` the iteration op by op, with the same bits.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend import ba
from ..core import graphs, lie
from ..core.camera import Camera
from . import multihost


class TrajSegments(NamedTuple):
    """A keyframe-sharded trajectory BA problem; as a whole (D segments) or
    one rank's part (``shard_segments``: D = 1).

    obs rows 0..1 of each segment are the halo keyframes' observations of
    the segment's OWN landmarks; rows 2.. are the local keyframes'.
    """

    anchor_T_CW: torch.Tensor  # (2, 4, 4) global gauge keyframes (frozen)
    T_CW: torch.Tensor  # (D*S, 4, 4) local keyframes
    lm_xyz: torch.Tensor  # (D*L, 3) per-segment landmarks
    obs_uv: torch.Tensor  # (D, S+2, L, 2)
    obs_mask: torch.Tensor  # (D, S+2, L)


def shard_segments(seg: TrajSegments, rank: int, world: int) -> TrajSegments:
    """Rank ``rank``'s segment of a problem of ``world`` segments."""
    S = seg.T_CW.shape[0] // world
    L = seg.lm_xyz.shape[0] // world
    return TrajSegments(anchor_T_CW=seg.anchor_T_CW,
                        T_CW=seg.T_CW[rank * S:(rank + 1) * S],
                        lm_xyz=seg.lm_xyz[rank * L:(rank + 1) * L],
                        obs_uv=seg.obs_uv[rank:rank + 1],
                        obs_mask=seg.obs_mask[rank:rank + 1])


def gn_iteration(cam: Camera, huber_px: float, damping: float, group,
                 T_local, lm_local, anchor_T_CW, obs_uv, obs_mask):
    """One halo-exchanged Gauss-Newton iteration of :func:`run_traj_ba` on
    this rank's segment, the body of its loop: ((new T_local, new
    lm_local), (cost summed over the ranks,)).  Whether the rank receives a
    halo is its rank's (``rank > 0``), known on the host; it reads nothing
    on the host, so a CUDA graph holds it with its collectives."""
    # Halo: the left neighbour's last two poses; rank 0 uses the anchors.
    halo = torch.empty_like(anchor_T_CW)
    got = multihost.shift_right(T_local[-2:], halo, group)
    window = ba.BAWindow(T_CW=torch.cat([halo if got else anchor_T_CW,
                                         T_local]),
                         lm_xyz=lm_local, obs_uv=obs_uv, obs_mask=obs_mask)
    S_blk, rhs, Hpp_inv, Hcp, b_p, cost = ba.build_normal_blocks(
        window, cam, huber_px=huber_px, damping=damping)
    delta_c = ba.solve_camera_system(S_blk, rhs, n_fixed=2)
    new_window = ba.apply_updates(window, delta_c, Hpp_inv, Hcp, b_p)
    return ((new_window.T_CW[2:], new_window.lm_xyz),
            (multihost.all_reduce(cost.reshape(1), group)[0],))


def run_traj_ba(seg_local: TrajSegments, cam: Camera, *, group=None,
                iters: int = 8, huber_px: float = 3.0,
                damping: float = 1e-2):
    """Run ``iters`` halo-exchanged Gauss-Newton iterations on this rank's
    segment.

    ``damping`` defaults an order stronger than single-window BA: the halo
    poses move between iterations (block-Jacobi), and undamped GN steps
    taken against a moving gauge oscillate and can diverge (the reference
    measured damping 1e-4 diverging on the synthetic trajectory, 1e-2
    converging).

    On a CUDA device one graph of :func:`gn_iteration` per camera,
    ``huber_px``, ``damping``, rank, process group and shapes, replayed
    ``iters`` times.

    Returns (the segment with updated T_CW / lm_xyz, costs (iters,) summed
    over ranks)."""
    pg = group if group is not None else dist.group.WORLD
    body = functools.partial(gn_iteration, cam, float(huber_px),
                             float(damping), group)
    (T_local, lm_local), (costs,) = graphs.scan(
        ("traj_ba", cam, float(huber_px), float(damping),
         dist.get_rank(group), pg), body,
        (seg_local.T_CW, seg_local.lm_xyz),
        (seg_local.anchor_T_CW, seg_local.obs_uv[0], seg_local.obs_mask[0]),
        iters)
    return seg_local._replace(T_CW=T_local, lm_xyz=lm_local), costs


def build_synthetic_traj(D: int, S: int, L: int, *, seed: int = 0,
                         noise_pose: float = 0.02, noise_px: float = 0.3,
                         image_shape=(480, 640)):
    """Ground-truth trajectory + per-segment landmark/observation tensors for
    tests and the scaling harness.  Returns (TrajSegments noisy, TrajSegments
    ground truth, Camera), CPU tensors."""
    rng = np.random.default_rng(seed)
    H, W = image_shape
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]])
    cam = Camera.from_matrix(K)

    n_kf = D * S + 2
    # Forward trajectory with gentle yaw; extrinsics T_CW = inv(T_WC).
    T_WC = np.tile(np.eye(4), (n_kf, 1, 1))
    for i in range(n_kf):
        yaw = 0.004 * i
        cy, sy = np.cos(yaw), np.sin(yaw)
        T_WC[i, :3, :3] = [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]
        T_WC[i, :3, 3] = [0.1 * i, 0.0, 0.8 * i]
    T_CW = np.linalg.inv(T_WC)

    obs_uv = np.zeros((D, S + 2, L, 2), np.float32)
    obs_mask = np.zeros((D, S + 2, L), bool)
    lm = np.zeros((D * L, 3), np.float32)
    for d in range(D):
        kfs = [d * S, d * S + 1] + list(range(2 + d * S, 2 + (d + 1) * S))
        z0 = 0.8 * (2 + d * S)
        X = np.stack([
            rng.uniform(-8, 8, L) + 0.1 * d * S,
            rng.uniform(-2, 2, L),
            rng.uniform(z0 + 3, z0 + 0.8 * S + 25, L),
        ], 1)
        lm[d * L:(d + 1) * L] = X
        for row, kf in enumerate(kfs):
            Xc = X @ T_CW[kf, :3, :3].T + T_CW[kf, :3, 3]
            z = Xc[:, 2]
            u = K[0, 0] * Xc[:, 0] / np.maximum(z, 1e-6) + K[0, 2]
            v = K[1, 1] * Xc[:, 1] / np.maximum(z, 1e-6) + K[1, 2]
            ok = (z > 0.5) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
            obs_uv[d, row, :, 0] = u + rng.normal(0, noise_px, L)
            obs_uv[d, row, :, 1] = v + rng.normal(0, noise_px, L)
            obs_mask[d, row] = ok

    f32 = torch.float32
    gt = TrajSegments(
        anchor_T_CW=torch.as_tensor(T_CW[:2], dtype=f32),
        T_CW=torch.as_tensor(T_CW[2:], dtype=f32),
        lm_xyz=torch.from_numpy(lm),
        obs_uv=torch.from_numpy(obs_uv),
        obs_mask=torch.from_numpy(obs_mask),
    )
    # Perturb everything except the anchors.
    se3_noise = rng.normal(0, noise_pose, (n_kf - 2, 6)).astype(np.float32)
    T_noisy = lie.se3_exp(torch.from_numpy(se3_noise)) @ gt.T_CW
    noisy = gt._replace(
        T_CW=T_noisy,
        lm_xyz=gt.lm_xyz + torch.from_numpy(
            rng.normal(0, 0.05, lm.shape).astype(np.float32)),
    )
    return noisy, gt, cam
