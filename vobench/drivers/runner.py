"""One camera, one estimator waiting for each pose: ``runner.run_sequence``
over the whole drive with the traffic's ``recover``, frames handed one at
a time, each frame's latency from its hand-over to its pose record on the
host (``on_frame``): a closed loop."""
from __future__ import annotations

import time

import numpy as np

from vobench.drivers import pass_seed
from vobench.reference.check import Pass


class Driver:
    def __init__(self, vo, frames, config, traffic, seed):
        self.vo, self.frames, self.seed = vo, frames, seed
        self.t = traffic
        self.stride = config["bootstrap_stride"]

    def run_pass(self, index: int):
        from monocular_visual_odometry_va4mr_torch.pipeline import runner

        vo, stamps = self.vo, {}
        ids, T, status, uv, xyz, lat, ba = [], [], [], [], [], [], []
        ba_runs = [vo.ba_runs]

        def handed():
            for i, f in enumerate(self.frames):
                stamps[i] = time.perf_counter()
                yield i, f

        def on_frame(records, snap):
            t = time.perf_counter()
            r = records[-1]
            lat.append(1e3 * (t - stamps[r.frame]))
            ba.append(vo.ba_runs != ba_runs[0])
            ba_runs[0] = vo.ba_runs
            ids.append(r.frame)
            T.append(r.T_WC)
            status.append(r.status)
            uv.append(np.concatenate([snap["inlier_uv"], snap["outlier_uv"]]))
            xyz.append(snap["landmark_xyz"])

        runner.run_sequence(
            vo, handed(), seed=pass_seed(self.seed, index),
            bootstrap_stride=self.stride, recover=self.t["recover"],
            on_frame=on_frame)
        boot_ms = 1e3 * (stamps[self.stride + 1] - stamps[0])
        T_WC = np.asarray(T, np.float64)
        T_CW = np.linalg.inv(T_WC) if len(T_WC) else T_WC.reshape(0, 4, 4)
        p = Pass(ids=np.asarray(ids), T_CW=T_CW, status=np.asarray(status),
                 uv=uv, lm_world=xyz, index=index)
        return [p], len(ids), dict(latency_ms=lat, ba=ba,
                                   bootstrap_ms=[boot_ms])
