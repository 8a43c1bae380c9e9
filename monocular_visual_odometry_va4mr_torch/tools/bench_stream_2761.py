"""The reference's own workload, end to end, counterpart of
``tools/bench_stream_2761.py``: 2761 frames streamed from PNG files through
the native decoder into the block driver, with recovery, block-boundary
checkpoints and the Sim(3) pose graph.

The reference's ``main.py:17`` streams KITTI seq 05 for 2761 frames from
PNG files.  There is no real dataset here, so the sequence is the rendered
loop-room world in the KITTI layout (``tools/make_kitti_seq.py``: 3 laps of
~2.8 km, viewpoint revisits), read by ``dataio.datasets.load_kitti`` and the
native decoder as the real dataset would be.

The JAX procedure, step for step: ``load_kitti(root, "05")``;
``kitti_tuned_config()`` with ``quality_level=0.03`` and the KLT bootstrap
(tracker ``auto``: ``pallas2`` on the card); a KLT bootstrap over frames
0..8; ``keep_every`` keeping every 8th frame for the keyframe bank;
``scan_driver.run_streaming`` (blocks of 64, recovery, landmark snapshots,
a checkpoint every 8 blocks); ``bank_from_stream`` and
``refine_stream_trajectory(method="sim3")``; the health gate (LOST at most
2% of the frames, the better of the raw and the refined ATE at most 2% of
the path); the dashboard.  The reference-CPU run of the JAX tool needs cv2
and the reference's code, which the port does not carry: every ``ref_*``
field is ``null``.

The line has the JAX result's keys, unrounded, plus ``klt_lk``'s launches
against 3 per step and bootstrap hop (the run raises when they differ),
the steps and hops run, the chunks among the steps and the step's graphs
captured with their seconds (``step_graphs``), the checkpoints written,
the process's peak RSS,
the card's ``nvidia-smi`` name and power limit, where the error grows
(``drift_windows``: per 256 streamed frames the globally aligned error,
raw and refined, and the stretch's own ATE against 2% of its path), and
the JAX tool's TPU record (``BENCH_stream_2761.json``) beside it as
``jax_*`` fields, read only, and the post-pass's seconds by stage beside
its total (``posegraph_split``: bank SIFT, retrieval, verification, the
graph, the GN solves with their capture seconds and replays, the
recomposition; ``refine``).  Exit code 2 when the run is unhealthy, as
the JAX tool.

Nothing is written outside ``build/`` by default: the line goes to
``--out`` (``build/stream_2761.json``), the trajectories and the dashboard
beside it (``build/stream_2761_traj.npz``, ``_dashboard.png``: drawn where
matplotlib is installed; the line says when it is not), checkpoints to
``--checkpoint-dir`` (``build/stream2761_ck``).

    python -m monocular_visual_odometry_va4mr_torch.tools.make_kitti_seq
    python -m monocular_visual_odometry_va4mr_torch.tools.bench_stream_2761 \\
        [--root build/kitti_loop_2761] [--frames N] [--block 64] \\
        [--posegraph-every 8] [--no-instep-ba]
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time

import numpy as np

from . import harness

JAX_RECORD = harness.REPO / "BENCH_stream_2761.json"
LOST_FRAC = 0.02  # the gate's LOST share of the streamed frames
WINDOW = 256  # frames a stretch of the drift profile
CHECKPOINT_EVERY_BLOCKS = 8


def make_vo(K, shape, device, *, instep_ba=True):
    """The JAX tool's configuration."""
    from ..core.camera import Camera
    from ..core.config import kitti_tuned_config
    from ..pipeline.vo import VisualOdometry

    cfg = kitti_tuned_config().replace(image_shape=tuple(shape),
                                       bootstrap_method="klt")
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.03))
    if not instep_ba:
        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, every=0))
    return VisualOdometry(Camera.from_matrix(K), cfg, device, seed=0)


def stream_sequence(vo, spec, *, bootstrap=8, block=64, posegraph_every=0,
                    checkpoint_dir=None, checkpoint_every_blocks=0, seed=0,
                    verbose=False):
    """Steps 3-5 of the procedure on ``spec`` (a ``SequenceSpec`` of PNG
    files): a KLT bootstrap over the first ``bootstrap + 1`` decoded frames,
    then ``run_streaming`` over the rest with recovery and landmark
    snapshots, every ``posegraph_every``-th frame kept for the keyframe bank
    (0: none) and a checkpoint every ``checkpoint_every_blocks`` blocks.
    Frames go up as uint8 (the PNGs are 8-bit, so this is exact).

    Returns the final state, the outputs, frame ids and ``StreamInfo``, the
    kept keyframe images, the bootstrap's status (a failed bootstrap is
    streamed on: the stream's recovery re-bootstraps), the stream's wall
    time and rate (the bootstrap left out, as the JAX tool), and
    ``klt_lk``'s launches against 3 per step and hop (raises when they
    differ)."""
    from ..ops import klt_pallas2 as k2
    from ..pipeline import posegraph_runner, runner, scan_driver

    dev = vo.device
    frames = ((i, img.astype(np.uint8)) for i, img in
              spec.frames(prefetch=True))
    head = [next(frames)[1] for _ in range(bootstrap + 1)]
    kf_images = {}
    src = (posegraph_runner.keep_every(frames, posegraph_every, kf_images)
           if posegraph_every else frames)
    with harness.CallCounts(vo) as counts:
        harness.sync(dev)
        k2.klt_lk.launches = 0
        t0 = time.perf_counter()
        state0 = vo.bootstrap(head[0], head[bootstrap],
                              intermediate=head[1:bootstrap],
                              generator=runner.frame_generator(seed, 0, dev))
        harness.sync(dev)
        t1 = time.perf_counter()
        state, outs, ids, info = scan_driver.run_streaming(
            vo, state0, src, seed, block=block, emit_landmarks=True,
            recover=True, bootstrap_stride=bootstrap,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every_blocks=checkpoint_every_blocks, verbose=verbose)
        harness.sync(dev)
        t2 = time.perf_counter()
    launches, expected = k2.klt_lk.launches, counts.expected_lk()
    if launches != expected:
        raise RuntimeError(f"klt_lk launched {launches} times, expected "
                           f"{expected}: 3 per step ({counts.steps}) and "
                           f"per bootstrap hop ({counts.hops})")
    return dict(state=state, outs=outs, ids=ids, info=info,
                kf_images=kf_images, bootstrap_status=int(state0.status),
                bootstrap_ms=1e3 * (t1 - t0),
                wall_s=t2 - t1, fps=len(ids) / (t2 - t1),
                steps=counts.steps, chunks=counts.chunks, hops=counts.hops,
                bootstraps=counts.bootstraps, klt_lk_launches=launches,
                klt_lk_launches_expected=expected)


# The post-pass's stages in ``posegraph_split``, in order; their seconds add
# up to ``posegraph_wall_s`` (the capture seconds are part of the first
# solve's, the solves' parts of ``solve_s``).
SPLIT_STAGES = ("bank_sift_s", "retrieval_s", "verification_s", "graph_s",
                "solve_s", "recompose_s")
SPLIT_PARTS = ("solve_first_s", "solve_loo_s", "solve_final_s", "capture_s")
SPLIT_COUNTS = ("suspects", "captures", "replays")


def refine(vo, run, every):
    """Step 6: the keyframe bank of the stream and its Sim(3) pose graph;
    (bank, refined positions or None, seconds, the split by stage).  The
    split (``refine_trajectory``'s trace): the bank's SIFT, the retrieval,
    the verification, building the graph, the GN solves (the first, the
    leave-one-out ones, the final one, the capture seconds within the
    first; the suspects, the graphs captured and the replays) and the
    records' recomposition, each ended by a device sync; a stage the run
    did not reach reads 0."""
    from ..pipeline import posegraph_runner

    t0 = time.perf_counter()
    bank = posegraph_runner.bank_from_stream(vo, run["outs"], run["ids"],
                                             run["kf_images"], every=every)
    harness.sync(vo.device)
    trace = {"bank_sift_s": time.perf_counter() - t0}
    refined = posegraph_runner.refine_stream_trajectory(
        run["outs"], run["ids"], bank, vo.cam, method="sim3", verbose=True,
        trace=trace)
    harness.sync(vo.device)
    split = {k: float(trace.get(k, 0.0)) for k in SPLIT_STAGES + SPLIT_PARTS}
    split.update({k: int(trace.get(k, 0)) for k in SPLIT_COUNTS})
    return bank, refined, time.perf_counter() - t0, split


def drift_profile(ids, est, gt, status, refined=None, window=WINDOW):
    """Where the error grows: per stretch of ``window`` streamed frames, the
    RMSE of the whole run's Sim(3)-aligned error (raw, and refined when
    given), the stretch's own Sim(3)-aligned ATE against 2% of its path,
    and its LOST frames."""
    from ..evalx import ate

    def aligned_err(x):
        s, R, t = ate.umeyama_alignment(x, gt)
        return np.linalg.norm(s * x @ R.T + t - gt, axis=1)

    raw = aligned_err(est)
    ref = aligned_err(refined) if refined is not None else None
    out = []
    for a in range(0, len(ids), window):
        b = min(a + window, len(ids))
        if b - a < 8:
            break
        path = float(np.sum(np.linalg.norm(np.diff(gt[a:b], axis=0),
                                           axis=1)))
        out.append(dict(
            first=int(ids[a]), last=int(ids[b - 1]),
            err_raw=float(np.sqrt(np.mean(raw[a:b] ** 2))),
            err_refined=(float(np.sqrt(np.mean(ref[a:b] ** 2)))
                         if ref is not None else None),
            ate_local=float(ate.ate_rmse(est[a:b], gt[a:b])),
            bound_local=harness.ATE_BOUND_FRAC * path,
            lost=int(np.sum(np.asarray(status[a:b]) != 0))))
    return out


def jax_record():
    """The JAX tool's TPU record as ``jax_*`` fields (read only)."""
    with open(JAX_RECORD) as f:
        return {f"jax_{k}": v for k, v in json.load(f).items()}


def dashboard(spec, run, est, gt, path):
    """Step 8: the reference's dashboard of the run, offline; the path, or
    None where matplotlib is not installed (the card's machine)."""
    if importlib.util.find_spec("matplotlib") is None:
        return None
    from ..evalx.ate import umeyama_alignment
    from ..viz.dashboard import render_dashboard

    s, R, t = umeyama_alignment(est, gt)
    est_al = s * est @ R.T + t
    traj = np.stack([est_al[:, 0], est[:, 1], est_al[:, 2]], axis=1)
    outs, ids = run["outs"], run["ids"]
    last = np.asarray(outs.lm_valid[-1])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    render_dashboard(
        image=spec.load_frame(ids[-1]),
        inlier_uv=np.asarray(outs.lm_uv[-1])[last],
        outlier_uv=np.zeros((0, 2)), trajectory=traj,
        landmark_xyz=np.zeros((0, 3)),
        num_tracked=np.asarray(outs.n_inliers), frame_index=ids[-1],
        out_path=str(path), gt_xz=gt[:, [0, 2]])
    return str(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(harness.BUILD / "kitti_loop_2761"))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--posegraph-every", type=int, default=8)
    ap.add_argument("--bootstrap", type=int, default=8,
                    help="bootstrap pair stride (the loop-room scene's "
                         "strong corners are far-field)")
    ap.add_argument("--no-instep-ba", action="store_true",
                    help="in-step BA off (the JAX tool's switch for this "
                         "scene; a run with it is not the default's "
                         "verdict)")
    ap.add_argument("--out", default=str(harness.BUILD / "stream_2761.json"))
    ap.add_argument("--checkpoint-dir",
                    default=str(harness.BUILD / "stream2761_ck"))
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    fields = harness.device_fields(device)

    from ..dataio import datasets
    from ..evalx import ate
    from ..pipeline import checkpoint

    spec = datasets.load_kitti(args.root, "05", last_frame=args.frames)
    H, W = spec.load_frame(0).shape
    print(f"sequence: {spec.num_frames} frames @ {W}x{H}", file=sys.stderr,
          flush=True)
    vo = make_vo(spec.K, (H, W), device, instep_ba=not args.no_instep_ba)
    ck = os.path.join(os.path.abspath(args.checkpoint_dir), "checkpoint.pt")
    if os.path.exists(ck):
        os.remove(ck)  # a stale checkpoint must not pass for this run's
    run = stream_sequence(vo, spec, bootstrap=args.bootstrap,
                          block=args.block,
                          posegraph_every=args.posegraph_every,
                          checkpoint_dir=args.checkpoint_dir,
                          checkpoint_every_blocks=CHECKPOINT_EVERY_BLOCKS,
                          verbose=True)
    if run["bootstrap_status"] != 0:  # the JAX tool's assert
        raise RuntimeError("bootstrap failed")
    info, ids, outs = run["info"], run["ids"], run["outs"]
    print(f"streamed {len(ids)} frames in {run['wall_s']:.1f}s = "
          f"{run['fps']:.1f} fps (lost {info.lost}, recoveries "
          f"{info.recoveries})", file=sys.stderr, flush=True)
    bank, refined, pg_wall, pg_split = refine(vo, run,
                                              args.posegraph_every)

    est = harness.positions_of(outs.T_CW)
    gt = spec.gt_poses[ids][:, :3, 3]
    finite = bool(np.all(np.isfinite(est)))
    ate_raw = float(ate.ate_rmse(est, gt)) if finite else float("nan")
    ate_pg = (float(ate.ate_rmse(refined, gt)) if refined is not None
              else float("nan"))
    best = (min(x for x in (ate_raw, ate_pg) if np.isfinite(x))
            if finite else float("nan"))
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    bound = harness.ATE_BOUND_FRAC * path
    healthy = bool(finite and info.lost <= LOST_FRAC * len(ids)
                   and np.isfinite(best) and best <= bound)
    stem = os.path.splitext(args.out)[0]
    dash = dashboard(spec, run, est, gt, stem + "_dashboard.png") \
        if finite else None
    windows = (drift_profile(ids, est, gt, outs.status, refined)
               if finite else [])
    over = [w["first"] for w in windows if w["ate_local"] > w["bound_local"]]
    every = CHECKPOINT_EVERY_BLOCKS
    result = {
        "frames": len(ids), "resolution": [H, W], "block": args.block,
        "sustained_fps": run["fps"], "wall_s": run["wall_s"],
        "lost": info.lost, "recoveries": info.recoveries,
        "ate_rmse_raw": ate_raw,
        "ate_rmse_posegraph": ate_pg if np.isfinite(ate_pg) else None,
        "keyframes": len(bank.keyframes), "posegraph_wall_s": pg_wall,
        "posegraph_split": pg_split,
        "path_m": path, "ref_fps": None, "ref_ate": None,
        "ref_completed": None, "ref_died_at": None, "ate_bound": bound,
        "healthy": healthy,
        "instep_ba": not args.no_instep_ba, "bootstrap": args.bootstrap,
        "posegraph_every": args.posegraph_every,
        "tracker": vo.klt_backend, "bootstrap_ms": run["bootstrap_ms"],
        "blocks": info.blocks, "steps": run["steps"], "chunks": run["chunks"],
        "step_graphs": harness.step_graphs(vo), "hops": run["hops"],
        "klt_lk_launches": run["klt_lk_launches"],
        "klt_lk_launches_expected": run["klt_lk_launches_expected"],
        "checkpoint_every_blocks": every,
        "checkpoints_written": info.blocks // every if every else 0,
        "checkpoint_frame": checkpoint.saved_frame(args.checkpoint_dir),
        "dashboard": dash, "peak_rss_mb": harness.peak_rss_mb(),
        "drift_windows": windows,
        "first_window_over_bound": over[0] if over else None,
        **fields, **jax_record(),
    }
    if dash is None:
        result["dashboard_note"] = ("not drawn: matplotlib is not "
                                    "installed" if finite else
                                    "not drawn: non-finite trajectory")
    harness.emit(result)
    harness.write_json(args.out, result)
    np.savez_compressed(
        stem + "_traj.npz", frame_ids=np.array(ids),
        est=est, gt=gt, status=np.asarray(outs.status),
        refined=refined if refined is not None else np.zeros((0, 3)))
    return 0 if healthy else 2


if __name__ == "__main__":
    sys.exit(main())
