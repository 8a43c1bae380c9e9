"""The hard-realism scenario of ``chip_smoke.py``'s phase D through both
packages' runners on the CPU, with the same RANSAC draws: the JAX package's
``xla`` path, and the port's ``xla`` and ``pallas2`` paths fed the JAX
runner's own draws (``JaxSeedDraws``), the latter twice: with the port's
LK (the true image read) and with ``stress_diag.reference_read_lk``, which
reads what the reference's ``_klt2_kernel`` reads feature for feature
(``tests/test_torch_klt.py``), so that run stands for the JAX package's
``pallas2`` path, whose Pallas kernel is too slow to run a trajectory in
interpret mode.  Run as a script,
it prints one JSON line per runner seed (ATE, LOST and the tracked count
of each step, per path) and a summary line:

    JAX_PLATFORMS=cpu python tests/test_torch_stress_tail.py [--seeds 0,1,2]

The test checks what the script relies on: for any runner seed, the draws
the port's generator of a call leads ``JaxSeedDraws`` to are the JAX
runner's for the same call.
"""
import argparse
import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from monocular_visual_odometry_va4mr_tpu.core import config as jconfig  # noqa
from monocular_visual_odometry_va4mr_tpu.core.camera import (  # noqa: E402
    Camera as JCamera)
from monocular_visual_odometry_va4mr_tpu.ops import ransac as jransac  # noqa
from monocular_visual_odometry_va4mr_tpu.pipeline import (  # noqa: E402
    runner as jrunner)
from monocular_visual_odometry_va4mr_tpu.pipeline.vo import (  # noqa: E402
    VisualOdometry as JVO)
from monocular_visual_odometry_va4mr_torch.evalx import ate  # noqa: E402
from monocular_visual_odometry_va4mr_torch.pipeline import runner  # noqa

PATHS = ("jax_xla", "port_xla", "port_pallas2", "port_refread")


class JaxSeedDraws:
    """A sampler that gives each RANSAC call the bank the JAX runner draws
    for it: the call's generator was seeded with ``runner.frame_seed(seed,
    stream)``, and the JAX runner's key of that call is ``fold_in(PRNGKey(
    seed), stream)`` (the step's PnP bank the first half of its split)."""

    def __call__(self, generator, valid, n, k):
        full = generator.initial_seed()
        seed = full >> 32
        stream = ((full & 0xFFFFFFFF) - seed * 0x9E3779B1) & 0xFFFFFFFF
        key = jax.random.fold_in(jax.random.PRNGKey(seed), stream)
        if k == 3:
            key = jax.random.split(key)[0]
        idx, ok = jransac.sample_minimal_sets(key, jnp.asarray(valid.numpy()),
                                              n, k)
        return (torch.from_numpy(np.array(idx)).long(),
                torch.from_numpy(np.array(ok)))


def test_jax_seed_draws_are_the_jax_runners():
    valid = np.ones(40, bool)
    valid[::3] = False
    for seed, stream, k in ((0, 12, 5), (5, 17, 3), (19, 3, 5)):
        gen = runner.frame_generator(seed, stream, "cpu")
        idx, ok = JaxSeedDraws()(gen, torch.from_numpy(valid), 64, k)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), stream)
        if k == 3:
            key = jax.random.split(key)[0]
        jidx, jok = jransac.sample_minimal_sets(key, jnp.asarray(valid), 64,
                                                k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def jax_config(cfg):
    """The JAX package's counterpart of the port's stress config ``cfg``
    (``chip_smoke.stress_vo``) on the gather tracker."""
    j = jconfig.parking_config().replace(image_shape=cfg.image_shape,
                                         bootstrap_method="klt")
    return j.replace(
        detector=dataclasses.replace(j.detector,
                                     quality_level=cfg.detector.quality_level),
        klt=dataclasses.replace(j.klt, backend="xla"))


def summary(scene, res):
    recs = res.records
    ids = [r.frame for r in recs]
    pos = np.stack([r.T_WC[:3, 3] for r in recs])
    return dict(ate=float(ate.ate_rmse(pos, scene.poses_WC[ids, :3, 3])),
                lost=sum(r.status != 0 for r in recs),
                tracked=[int(r.n_tracked) for r in recs[1:]])


def main():
    import chip_smoke as cs
    import stress_diag
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7,8,9")
    args = ap.parse_args()
    torch.set_num_threads(4)
    cs.DEVICE = "cpu"
    scene, frames, cfg, b, max_ate = stress_diag.scenario("hard_realism", 0)
    jvo = JVO(JCamera.from_matrix(scene.K), jax_config(cfg))
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        row = dict(seed=seed)
        row["jax_xla"] = summary(scene, jrunner.run_sequence(
            jvo, enumerate(frames), seed=seed, bootstrap_stride=b))
        for path, backend, lk in (
                ("port_xla", "xla", k2.klt_lk),
                ("port_pallas2", "pallas2", k2.klt_lk),
                ("port_refread", "pallas2", stress_diag.reference_read_lk)):
            own, k2.klt_lk = k2.klt_lk, lk
            try:
                vo = stress_diag.make_vo(scene, cfg, "cpu", JaxSeedDraws(),
                                         backend)
                row[path] = summary(scene, runner.run_sequence(
                    vo, enumerate(frames), seed=seed, bootstrap_stride=b))
            finally:
                k2.klt_lk = own
        print("hard_realism " + json.dumps(row), flush=True)
        rows.append(row)
    tracked = {p: [n for r in rows for n in r[p]["tracked"]] for p in PATHS}
    print("summary " + json.dumps(dict(
        max_ate=max_ate, ates={p: [r[p]["ate"] for r in rows] for p in PATHS},
        over_max_ate={p: sum(not r[p]["ate"] <= max_ate for r in rows)
                      for p in PATHS},
        lost={p: [r[p]["lost"] for r in rows] for p in PATHS},
        tracked_median={p: float(np.median(t)) for p, t in tracked.items()},
        tracked_p95={p: float(np.percentile(t, 95))
                     for p, t in tracked.items()})), flush=True)


if __name__ == "__main__":
    main()
