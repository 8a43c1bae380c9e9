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
  card_refread  as ``card_cpudraw`` with ``reference_read_lk`` in place of
                the kernel: a plain LK that reads what the JAX package's
                ``_klt2_kernel`` reads, where the port reads the true image
                (a diagnostic of this script, for the attribution of the
                hard-realism ATE tail; the package has no such option);
  card_xla      as ``card_cpudraw`` on the gather tracker (``xla``);
  cpu           the CPU path (the plain LK) with the same draws (it rounds
                alike on any number of threads).

With ``cpu`` among the ways and no ``--recover``, every step of the ``cpu``
run is replayed on the card from the CPU's own state, image and draws
(``chip_smoke.replay``, for ``card_cpudraw`` and ``card_plain``), so each
step's difference is one step's rounding and not what came before.  Prints
one JSON line per seed (per way: ATE, LOST, the tracked count of each step)
and a summary line (per way: the ATEs, how many pass the scenario's ATE
limit, LOST, and the median and 95th percentile of the tracked counts over
every step of every seed).  With no card it runs the CPU way only.

    python3 stress_diag.py [--scenario hard_realism|clean|
        photometric_occluder|kitti_preset] [--seeds 0,1,2,3,4] [--frames N]
        [--ways card,card_cpudraw,card_plain,card_refread,card_xla,cpu]
        [--recover] [--backend pallas2|pallas|xla]
        [--write-kitti DIR]

The attribution of the hard-realism ATE tail on the card (the seeds
written out):

    python3 stress_diag.py --seeds 0,1,...,19 \
        --ways card_refread,card_cpudraw,card_xla

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


SLAB_ROWS = 32  # rows of the reference kernel's search slab
GROUP = 4  # features the reference kernel sums in one 128-lane tile


def slab_top(qy):
    """Image row of the first row of the reference kernel's search slab
    for the integer search origin ``qy`` (window top-left row): the
    8-aligned padded row at or above ``qy + PAD - 8`` (``_prep_plane``'s
    ``y0``).  A search read of row y >= slab_top + SLAB_ROWS reads row
    y - SLAB_ROWS there, for the registration and the search shifts roll
    the slab circularly (``klt_pallas2.py:119-120, :191-193``)."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2

    return torch.div(qy + (k2.PAD - 8), 8, rounding_mode="floor") * 8 - k2.PAD


def group_sums(s):
    """Per-feature window sums ``s`` (N,) as the reference kernel returns
    them: it sums the lanes of GROUP features (4k .. 4k+3) with one matmul
    by a block-diagonal 0/1 matrix (``gsum``, ``klt_pallas2.py:151-155``),
    so one feature's sum that is not finite meets the zeros of the other
    columns, and inf * 0 makes all GROUP sums NaN."""
    import torch

    bad = ~torch.isfinite(s)
    n = s.shape[0]
    bad = torch.cat([bad, bad.new_zeros((-n) % GROUP)])
    bad = bad.view(-1, GROUP).any(1).repeat_interleave(GROUP)[:n]
    return torch.where(bad, torch.full_like(s, float("nan")), s)


def reference_read_lk(tmpl, srch, feat, valid, *, win, num_iters, eps,
                      min_eig_threshold, max_residual):
    """``klt_lk_plain`` reading what the reference kernel reads: search rows
    past its slab 32 rows up (``slab_top``), and sums NaN across a group
    where one is not finite (``group_sums``).  Same inputs and (N, 5)
    output as ``klt_lk``; ``tests/test_torch_klt.py`` holds it against the
    reference kernel feature for feature.  Its groups are the call's
    features 4k .. 4k+3, as the reference's are of its table, which it pads
    to a multiple of 128."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1

    tx, ty, phx, phy, qx, qy, gx, gy = feat.unbind(1)
    ring = (slab_top(qy), SLAB_ROWS)
    Tb = v1.sample_patches(tmpl, ty - 1, tx - 1, phy, phx, win + 2)
    WT = Tb[:, 1:-1, 1:-1]
    Ix = 0.5 * (Tb[:, 1:-1, 2:] - Tb[:, 1:-1, :-2])
    Iy = 0.5 * (Tb[:, 2:, 1:-1] - Tb[:, :-2, 1:-1])
    gxx = (Ix * Ix).sum((1, 2))
    gxy = (Ix * Iy).sum((1, 2))
    gyy = (Iy * Iy).sum((1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det,
                                                 min=0.0)))
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det,
                          torch.zeros_like(det))

    def sample_window(gy, gx):
        ny = torch.floor(gy).clamp(-8.0, 7.0)
        nx = torch.floor(gx).clamp(-8.0, 7.0)
        return v1.sample_patches(srch, qy + ny, qx + nx, gy - ny, gx - nx, win,
                                 row_ring=ring)

    frozen = torch.zeros_like(valid)
    for _ in range(num_iters):
        diff = sample_window(gy, gx) - WT
        b0 = group_sums((diff * Ix).sum((1, 2)))
        b1 = group_sums((diff * Iy).sum((1, 2)))
        d0 = -(gyy * b0 - gxy * b1) * inv_det
        d1 = -(-gxy * b0 + gxx * b1) * inv_det
        gx = torch.where(frozen, gx, gx + d0)
        gy = torch.where(frozen, gy, gy + d1)
        frozen = frozen | ((d0 * d0 + d1 * d1) < eps * eps)

    resid = group_sums((sample_window(gy, gx) - WT).abs().sum((1, 2))) / (
        win * win)
    drift_ok = (gx > -7.99) & (gx < 7.99) & (gy > -7.99) & (gy < 7.99)
    eig_ok = (min_eig / (win * win)) > min_eig_threshold
    ok = drift_ok & eig_ok & (resid < max_residual) & valid
    return torch.stack([gx, gy, ok.to(torch.float32), resid, min_eig], 1)


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
    # trk[0] is the bootstrap's; the rest are the steps' tracked counts.
    out = dict(ate=float(ate.ate_rmse(pos, gt)), lost=len(lost),
               first_lost=lost[:8], tracked=list(trk[1:]))
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
                    help="which of the ways to run on a card (card, "
                    "card_cpudraw, card_plain, card_refread, card_xla, "
                    "cpu)")
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
        for way, lk, backend in (
                ("card_cpudraw", k2.klt_lk, args.backend),
                ("card_plain", k2.klt_lk_plain, args.backend),
                ("card_refread", reference_read_lk, args.backend),
                ("card_xla", k2.klt_lk, "xla")):
            if way not in ways:
                continue
            kernel, k2.klt_lk = k2.klt_lk, lk
            try:
                vo = make_vo(scene, cfg, "cuda", CpuDraws(), backend)
                run = loop(vo, frames, seed, b)
                row[way] = summary(scene, run)
                if (cpu is not None and not args.recover
                        and way in ("card_cpudraw", "card_plain")):
                    row[way]["parts_from_cpu"] = parting(run, cpu)
                    row[way]["replay"] = replay(vo, frames, seed, cpu)
            finally:
                k2.klt_lk = kernel
        row["s"] = time.perf_counter() - t0
        print(f"{args.scenario} " + json.dumps(row), flush=True)
        rows.append(row)
    tracked = {w: [n for r in rows for n in r[w]["tracked"]] for w in ways}
    print("summary " + json.dumps(dict(
        scenario=args.scenario, max_ate=max_ate,
        ates={w: [r[w]["ate"] for r in rows] for w in ways},
        over_max_ate=None if max_ate is None else {
            w: sum(not r[w]["ate"] <= max_ate for r in rows) for w in ways},
        lost={w: [r[w]["lost"] for r in rows] for w in ways},
        tracked_median={w: float(np.median(t)) for w, t in tracked.items()},
        tracked_p95={w: float(np.percentile(t, 95))
                     for w, t in tracked.items()})), flush=True)


if __name__ == "__main__":
    main()
