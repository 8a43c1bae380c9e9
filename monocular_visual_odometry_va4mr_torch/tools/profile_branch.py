"""The in-step BA branch body alone, at the bench shapes, counterpart of
``tools/profile_branch.py``.

On ``profile_trigger.build``'s state (``kitti_config()`` at 376x1241, BA
every 4 frames over a window of 10, after frame 13), with the ring as the
step leaves it and the newest frame taken as frame 16:

* ``branch``: ``VisualOdometry._run_ba_branch``, the body the step runs at
  a trigger: the compaction to the ``ba.max_landmarks`` best-observed
  landmarks (a stable top-k), the gathers, ``run_ba`` with the
  accept-if-improves guard, and the scatters back;
* ``compaction``: the top-k and the gathers alone;
* ``run_ba``: ``run_ba`` alone on the compacted window (no guard), as the
  JAX tool times it.

Each row: host ms (median of 20 synced calls), device ms and launches per
call from ``torch.profiler`` (``null`` on the CPU).  One JSON line per row.

    python -m monocular_visual_odometry_va4mr_torch.tools.profile_branch
"""
from __future__ import annotations

import argparse
import functools
import sys

import torch

from . import harness
from .profile_ba import row
from .profile_trigger import ba_on, build

NEW_FRAME = 16


def profile(device):
    from ..backend import ba as ba_mod
    from ..core.slots import stable_top_k

    vo, state, _ = build(ba_on, device)
    cfg = vo.config.ba
    Wb, Kba = cfg.window, cfg.max_landmarks
    slot = NEW_FRAME % Wb
    lm_valid, lm_gen = state.lm_valid, state.lm_gen

    def branch():
        return vo._run_ba_branch(state.ba_T, state.ba_uv, state.ba_mask,
                                 state.ba_gen, state.lm_xyz, lm_gen,
                                 lm_valid, slot)

    order = torch.tensor([(slot + 1 + i) % Wb for i in range(Wb)],
                         device=vo.device)

    def compact():
        uvw = state.ba_uv[order]
        mw = state.ba_mask[order] & (state.ba_gen[order] == lm_gen[None, :])
        n_obs = mw.sum(0)
        part = (n_obs >= cfg.min_obs) & lm_valid
        _, sel = stable_top_k(
            torch.where(part, n_obs, torch.full_like(n_obs, -1)), Kba)
        return state.lm_xyz[sel], uvw[:, sel], mw[:, sel], part[sel]

    lmx, uvs, mws, parts = compact()
    win = ba_mod.BAWindow(T_CW=state.ba_T[order], lm_xyz=lmx, obs_uv=uvs,
                          obs_mask=mws & parts)
    run = functools.partial(ba_mod.run_ba, iters=cfg.iters,
                            huber_px=cfg.huber_px, n_fixed=2)
    shape = dict(W=Wb, L=int(lmx.shape[0]), iters=cfg.iters)
    return [row("branch", branch, device, **shape),
            row("compaction", compact, device, **shape),
            row("run_ba", lambda: run(win, vo.cam), device, **shape)]


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
