"""Where the card's runs part from the CPU's.

Runs one scenario over the runner's seeds in the ways below: a scenario of
``chip_smoke.py``'s phase D (default ``hard_realism``), or ``kitti_preset``,
the first ``--frames`` frames of phase B's loop scene under the untuned
KITTI preset, as phase C's CLI runs them without ``--tuned``.  Each way is
a step loop like ``runner.run_sequence`` without its recovery, or with
``--recover`` the runner itself.  The ways:

  card          the card path as phase D runs it: ``klt_lk``, the card's
                generator;
  card_cpudraw  the card path with every RANSAC bank drawn on a CPU
                generator seeded as the call's own (``chip_smoke.CpuDraws``),
                so it draws as the CPU run does;
  card_plain    as ``card_cpudraw`` with the plain LK (``klt_lk_plain``) in
                place of the kernel;
  cpu           the CPU path (the plain LK) with the same draws (it rounds
                alike on any number of threads).

With ``cpu`` among the ways and no ``--recover``, every step of the ``cpu``
run is replayed on the card from the CPU's own state, image and draws
(``chip_smoke.replay``, for ``card_cpudraw`` and ``card_plain``), so each
step's difference is one step's rounding and not what came before.  Prints
one JSON line per seed and a summary line.  With no card it runs the CPU
way only.

    python3 stress_diag.py [--scenario hard_realism|clean|
        photometric_occluder|kitti_preset] [--seeds 0,1,2,3,4] [--frames N]
        [--ways card,card_cpudraw,card_plain,cpu] [--recover]
        [--backend pallas2|pallas|xla]
        [--write-kitti DIR]

``--write-kitti DIR`` writes the ``kitti_preset`` frames as PNG files in
the KITTI layout, for the CLIs of both packages: ``python -m
monocular_visual_odometry_va4mr_tpu.run --dataset kitti --data-root DIR
--seed S`` runs the JAX reference on them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def scenario(name, num_frames):
    """(scene, frames, config, bootstrap stride, ATE limit or None): a
    scenario of phase D, or ``kitti_preset``, the first ``num_frames`` of
    phase B's loop scene as uint8 frames under the KITTI preset untuned, as
    phase C's CLI would run it (SIFT bootstrap, stride 2)."""
    import chip_smoke as cs
    from monocular_visual_odometry_va4mr_torch.dataio import (datasets,
                                                              synthetic)

    if name == "kitti_preset":
        scene = synthetic.make_loop_scene(seed=cs.SEED,
                                          num_frames=cs.LOOP_FRAMES,
                                          laps=cs.LOOP_LAPS,
                                          image_shape=cs.IMAGE_SHAPE)
        frames = [np.clip(np.rint(f), 0, 255).astype(np.uint8)
                  .astype(np.float32)
                  for f in cs.render_frames(scene, num_frames)]
        return scene, frames, datasets.kitti_config(), 2, None
    for n, scene_kw, tag, aug_kw, max_lost, max_ate in cs.STRESS:
        if n != name:
            continue
        scene = synthetic.make_textured_scene(
            seed=7, num_frames=cs.STRESS_FRAMES, image_shape=cs.STRESS_SHAPE,
            step=1.0, **scene_kw)
        frames = synthetic.render_all_cached(
            scene, "e2e-s7-f{}-{}x{}{}".format(cs.STRESS_FRAMES,
                                              *cs.STRESS_SHAPE, tag),
            render=lambda sc: cs.render_frames(sc, sc.num_frames))
        if aug_kw:
            frames = synthetic.augment_frames(frames, seed=3, **aug_kw)
        return (scene, frames, cs.stress_vo(scene).config, cs.STRESS_STRIDE,
                max_ate)
    raise SystemExit(f"no scenario {name!r}")


def make_vo(scene, config, device, sampler, backend="pallas2"):
    """A VO of ``config`` on ``device`` with the tracker ``backend`` there
    too (``pallas2`` runs the plain LK on the CPU)."""
    from monocular_visual_odometry_va4mr_torch.core.camera import Camera
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    cfg = config.replace(klt=dataclasses.replace(config.klt,
                                                 backend=backend))
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, device,
                          sampler=sampler, seed=0)


def runner_loop(vo, frames, seed, b):
    """``runner.run_sequence`` itself, recovery included: (frame ids,
    positions, statuses, inliers, tracked, re-bootstraps that tracked)."""
    import chip_smoke as cs
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    boots = cs.CountingBootstrap(vo)
    res = runner.run_sequence(vo, enumerate(frames), seed=seed,
                              bootstrap_stride=b)
    recs = res.records
    return ([r.frame for r in recs], res.positions, [r.status for r in recs],
            [r.n_inliers for r in recs], [r.n_tracked for r in recs],
            boots.recoveries)


def summary(scene, run):
    from monocular_visual_odometry_va4mr_torch.evalx import ate

    ids, pos, stat, inl, trk, _ = run
    gt = scene.poses_WC[ids, :3, 3]
    lost = [f for f, s in zip(ids, stat) if s != 0]
    out = dict(ate=float(ate.ate_rmse(pos, gt)), lost=len(lost),
               first_lost=lost[:8])
    if isinstance(run[5], int):
        out["recoveries"] = run[5]
    return out


def parting(a, b, tol=1e-3):
    """First frame where two runs' positions differ by more than ``tol``
    metres, and the largest difference."""
    d = np.linalg.norm(a[1] - b[1], axis=1)
    far = np.nonzero(d > tol)[0]
    return dict(first_frame=int(a[0][far[0]]) if far.size else None,
                max_m=float(d.max()),
                inliers_differ=sum(x != y for x, y in zip(a[3], b[3])),
                tracked_differ=sum(x != y for x, y in zip(a[4], b[4])))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="hard_realism")
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--ways", default="card,card_cpudraw,card_plain,cpu",
                    help="which of the ways to run on a card")
    ap.add_argument("--backend", default="pallas2",
                    choices=("pallas2", "pallas", "xla"),
                    help="the tracker of every way")
    ap.add_argument("--recover", action="store_true",
                    help="card ways through runner.run_sequence, recovery "
                    "included (no replay)")
    ap.add_argument("--frames", type=int, default=320,
                    help="frames of the kitti_preset scenario")
    ap.add_argument("--write-kitti", default=None, metavar="DIR",
                    help="write the kitti_preset frames and poses in the "
                    "KITTI layout into DIR (a new directory) and exit")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from chip_smoke import CpuDraws, replay, step_loop
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2

    card = torch.cuda.is_available()
    cs.DEVICE = "cuda" if card else "cpu"
    scene, frames, cfg, b, max_ate = scenario(args.scenario, args.frames)
    if args.write_kitti:
        if args.scenario != "kitti_preset":
            raise SystemExit("--write-kitti writes the kitti_preset frames")
        cs.write_kitti(args.write_kitti, [f.astype(np.uint8) for f in frames],
                       scene.poses_WC[:len(frames)])
        return
    ways = args.ways.split(",") if card else ["cpu"]
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        row = dict(seed=seed)
        cpu = None
        loop = runner_loop if args.recover else step_loop
        if "cpu" in ways:
            vo = make_vo(scene, cfg, "cpu", CpuDraws(), args.backend)
            cpu = (runner_loop(vo, frames, seed, b) if args.recover
                   else step_loop(vo, frames, seed, b, keep_states=card))
            row["cpu"] = summary(scene, cpu)
        if "card" in ways:
            vo = make_vo(scene, cfg, "cuda", None, args.backend)
            row["card"] = summary(scene, loop(vo, frames, seed, b))
        for way, lk in (("card_cpudraw", k2.klt_lk),
                        ("card_plain", k2.klt_lk_plain)):
            if way not in ways:
                continue
            kernel, k2.klt_lk = k2.klt_lk, lk
            try:
                vo = make_vo(scene, cfg, "cuda", CpuDraws(), args.backend)
                run = loop(vo, frames, seed, b)
                row[way] = summary(scene, run)
                if cpu is not None and not args.recover:
                    row[way]["parts_from_cpu"] = parting(run, cpu)
                    row[way]["replay"] = replay(vo, frames, seed, cpu)
            finally:
                k2.klt_lk = kernel
        row["s"] = time.perf_counter() - t0
        print(f"{args.scenario} " + json.dumps(row), flush=True)
        rows.append(row)
    print("summary " + json.dumps(dict(
        scenario=args.scenario, max_ate=max_ate,
        ates={w: [r[w]["ate"] for r in rows] for w in ways},
        lost={w: [r[w]["lost"] for r in rows] for w in ways})), flush=True)


if __name__ == "__main__":
    main()
