"""A recorded drive processed as fast as the card allows: the bootstrap
over the first ``bootstrap_stride + 1`` frames, then
``scan_driver.run_streaming`` over the rest (the frames a pass completes),
in blocks of the traffic's ``block``, with its ``recover`` and
``landmarks`` (the landmark snapshots the check reads)."""
from __future__ import annotations

import numpy as np

from vobench.drivers import pass_seed
from vobench.reference.check import Pass


class Driver:
    def __init__(self, vo, frames, config, traffic, seed):
        self.vo, self.frames, self.seed = vo, frames, seed
        self.t = traffic
        self.stride = config["bootstrap_stride"]

    def run_pass(self, index: int):
        from monocular_visual_odometry_va4mr_torch.pipeline import scan_driver
        from monocular_visual_odometry_va4mr_torch.pipeline.runner import (
            frame_generator)

        t, b, fr = self.t, self.stride, self.frames
        seed = pass_seed(self.seed, index)
        state = self.vo.bootstrap(
            fr[0], fr[b], intermediate=list(fr[1:b]),
            generator=frame_generator(seed, 0, self.vo.device))
        _, outs, ids, info = scan_driver.run_streaming(
            self.vo, state, ((i, fr[i]) for i in range(b + 1, len(fr))),
            seed, block=t["block"], emit_landmarks=t["landmarks"],
            recover=t["recover"], bootstrap_stride=b)
        ids = np.asarray(ids)
        p = Pass(ids=ids, T_CW=np.asarray(outs.T_CW), index=index,
                 status=np.asarray(outs.status))
        if t["landmarks"]:
            valid = np.asarray(outs.lm_valid)
            p.uv = [outs.lm_uv[k][valid[k]] for k in range(len(ids))]
            p.lm = [(outs.lm_uv[k][valid[k]], outs.lm_z[k][valid[k]])
                    for k in range(len(ids))]
        return [p], len(ids), dict(recoveries=info.recoveries)
