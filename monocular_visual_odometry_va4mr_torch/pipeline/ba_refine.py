"""Sliding-window BA refinement woven into the host loop (port of
``pipeline/ba_refine.py``, the runner's ``--ba-every``).

A landmark keeps its slot for its whole life, so a window of ``lm_uv``
snapshots is the (W, L, 2) observation grid of a ``backend.ba.BAWindow``.

Host flow (``pipeline/runner.py``):
  * every frame, push (T_CW, lm_uv, lm_valid & lm_inlier, lm_gen) onto a
    host-side ring;
  * every ``ba_every`` frames, build a window from the ring and the current
    ``lm_xyz``, run ``backend.ba.run_ba`` (``refine_window``: on a CUDA
    device the replay of its graph, as the reference jits it) and write the
    refined current pose and landmarks back into the state (and the refined
    poses into the ring).

Only landmarks observed in >= ``min_obs`` window frames by their current
slot tenant participate; everything else passes through unchanged.  With a
1-D device mesh or a process group (``mesh=``), every rank runs
``parallel.ba_sharded.run_ba_sharded`` on its block of the landmark axis,
and one all-gather of the refined blocks folds them back into the
replicated state.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..backend import ba
from ..core import graphs
from ..core.camera import Camera
from ..core.state import FrameState


@dataclasses.dataclass
class BARing:
    """Host-side ring of per-frame observation snapshots (numpy)."""

    window: int
    poses: List[np.ndarray] = dataclasses.field(default_factory=list)
    obs_uv: List[np.ndarray] = dataclasses.field(default_factory=list)
    obs_mask: List[np.ndarray] = dataclasses.field(default_factory=list)
    obs_gen: List[np.ndarray] = dataclasses.field(default_factory=list)

    def push(self, state: FrameState) -> None:
        self.poses.append(state.T_CW.cpu().numpy())
        self.obs_uv.append(state.lm_uv.cpu().numpy())
        self.obs_mask.append((state.lm_valid & state.lm_inlier).cpu().numpy())
        self.obs_gen.append(state.lm_gen.cpu().numpy())
        if len(self.poses) > self.window:
            for lst in (self.poses, self.obs_uv, self.obs_mask, self.obs_gen):
                lst.pop(0)

    def __len__(self):
        return len(self.poses)


def refine(state: FrameState, ring: BARing, cam: Camera, *, iters: int = 4,
           huber_px: float = 3.0, min_obs: int = 3, mesh=None) -> FrameState:
    """Run windowed BA over the ring and fold the result into the state.

    Returns the state with refined ``T_CW`` and ``lm_xyz`` (only landmarks
    that participated are touched), and rewrites ``ring.poses`` with the
    refined window poses.  ``mesh``: a 1-D device mesh or process group
    whose ranks share the solve (every rank calls this with the same
    state and ring)."""
    W = len(ring)
    if W < 3:
        return state
    dev = state.lm_xyz.device
    obs_mask = np.stack(ring.obs_mask)  # (W, L)
    # Slot-reuse guard: only observations of the slot's CURRENT tenant
    # (generation) count.
    gen_now = state.lm_gen.cpu().numpy()
    obs_mask &= np.stack(ring.obs_gen) == gen_now[None, :]
    participate = ((obs_mask.sum(0) >= min_obs)
                   & state.lm_valid.cpu().numpy())
    window = ba.BAWindow(
        T_CW=torch.from_numpy(np.stack(ring.poses)).to(dev, torch.float32),
        lm_xyz=state.lm_xyz,
        obs_uv=torch.from_numpy(np.stack(ring.obs_uv)).to(dev),
        obs_mask=torch.from_numpy(obs_mask & participate[None, :]).to(dev))
    if mesh is None:
        T_CW, lm_out = refine_window(window, cam, iters=iters,
                                     huber_px=huber_px)
    else:
        out = _run_sharded(window, cam, mesh, iters=iters, huber_px=huber_px)
        T_CW, lm_out = out.T_CW, out.lm_xyz

    part = torch.from_numpy(participate).to(dev)
    lm_xyz = torch.where(part[:, None], lm_out, state.lm_xyz)
    refined = T_CW.cpu().numpy()
    for k in range(W):
        ring.poses[k] = refined[k]
    return state.replace(T_CW=T_CW[-1], lm_xyz=lm_xyz)


def refine_window(window: ba.BAWindow, cam: Camera, *, iters: int,
                  huber_px: float):
    """``backend.ba.run_ba`` of one window: (refined T_CW (W, 4, 4),
    refined lm_xyz (L, 3)).  On a CUDA device the replay of its graph in
    ``core.graphs.shared`` (the counterpart of the reference's
    ``jax.jit(run_ba)``): one graph per camera, ``iters``, ``huber_px`` and
    window shape (W, L), over static copies of the window; on the CPU
    (and inside ``core.graphs.eager()``) ``run_ba`` op by op.  The same
    bits either way."""
    dev = window.T_CW.device
    if not graphs.replaying(dev):
        out, _ = ba.run_ba(window, cam, iters=iters, huber_px=huber_px)
        return out.T_CW, out.lm_xyz

    def solve(*tensors):
        out, _ = ba.run_ba(ba.BAWindow(*tensors), cam, iters=iters,
                           huber_px=huber_px)
        return out.T_CW, out.lm_xyz

    return tuple(graphs.shared(dev).call(
        ("run_ba", cam, iters, float(huber_px)), solve, tuple(window)))


def _run_sharded(window: ba.BAWindow, cam: Camera, mesh, **kw) -> ba.BAWindow:
    """``run_ba`` with the landmark axis split over the ranks of ``mesh``;
    the refined blocks are gathered back into the whole window."""
    import torch.distributed as dist

    from ..parallel import ba_sharded, multihost

    group = multihost.as_group(mesh)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    local = ba_sharded.shard_window(window, rank, world)
    out, _ = ba_sharded.run_ba_sharded(local, cam, group=group, **kw)
    blocks = multihost.all_gather(out.lm_xyz.contiguous(), group)
    lm_xyz = torch.cat(blocks)[:window.lm_xyz.shape[0]]
    return window._replace(T_CW=out.T_CW, lm_xyz=lm_xyz)
