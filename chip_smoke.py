#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; every check raises, so any failure
exits nonzero:

1. The device (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``monocular_visual_odometry_va4mr_torch/csrc`` (one
   ``nvcc`` per source, all started together), with compile times and the
   ``ptxas`` register and spill lines.
2. The packed LK kernel (``klt_lk``) against its plain PyTorch version on
   the card, at the main path's shapes: the full-res 376x1241 plane (N=1024
   features, win 15, 6 iterations), the /4 plane (94x310) and the backward
   pass (planes swapped, 4 iterations).  Agreement; the kernel's
   ``device_ms``, the device time of one call (calls queued behind a spin
   kernel, so the wrapper's host work falls outside the CUDA events), and
   its ``call_ms``, the median of 20 single calls between two events on an
   idle card, host work included; ``plain_ms``, the plain version's time
   measured as ``call_ms`` (it waits on the card inside, so no spin can
   cover its enqueue).
3. The main path, as ``bench.py`` drives it: the 100-frame textured
   KITTI-geometry scene (seed 11), ``kitti_tuned_config()`` with the KLT
   bootstrap and ``detector.quality_level=0.03`` (``klt.backend="auto"``, i.e.
   ``pallas2`` on the card), a bootstrap over frames 0..4, then one ``step``
   per frame.  ``klt_lk`` must have launched 3 times per bootstrap hop plus
   3 times per step.  Health: 0 LOST frames, a finite trajectory, ATE <= 2%
   of the path (``bench.py``'s gate without its reference-CPU term).
   ``torch.profiler`` traces 8 of the steps (left out of the step times):
   device time per step, all kernels and ``klt_lk``'s alone.
4. The block driver on the same path: ``scan_driver.run_streaming`` over
   frames 5..99 uploaded as uint8, blocks of 16 with a padded tail.
   ``klt_lk`` must have launched 3 times per frame; statuses equal to, and
   positions within 1e-3 of the path of, a step loop over the same frames
   with the same per-frame generators; the health gate of phase 3.
5. The v1 LK kernel (``klt_v1``) against its plain version, the same three
   shapes and tolerances.
6. The CLI in a subprocess: ``python -m monocular_visual_odometry_va4mr_torch
   .run --dataset synthetic`` over 40 frames with host-side BA every 8 and a
   checkpoint at frame 20, then again with ``--resume``; both exit 0 and the
   resumed final position matches the uninterrupted one.
7. ``klt.backend="xla"`` (the gather tracker) through ``runner.run_sequence``
   over the scene's first 20 frames at full width: health reported, the
   trajectory must be finite.
8. The v1 path: ``runner.run_sequence`` over the same 100 frames with
   ``klt.backend="pallas"``, stride 4, recovery on.  ``klt_v1`` must have
   launched 3 times per bootstrap hop (re-bootstraps included) plus 3 times
   per step, ``klt_lk`` never; the health gate of phase 3.

The last lines are a JSON object describing the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Without a card, or
outside a checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_FRAMES = 100
IMAGE_SHAPE = (376, 1241)
BOOTSTRAP_STRIDE = 4
SEED = 11
ATE_BOUND_FRAC = 0.02
TIMED_START = 12  # frames before this warm up the step (bench.py)
N_FEATURES = 1024  # 512 landmark + 512 candidate slots at the bench point
POS_TOL_PX = 1e-3  # kernel vs plain version, features both accept
OK_AGREE = 0.99  # kernel vs plain ok flags (the rest sit on a gate threshold)
XLA_FRAMES = 20
CLI_FRAMES = 40
CLI_RESUME_TOL = 1e-3  # resumed vs uninterrupted final position, x path length
STREAM_BLOCK = 16  # 95 frames: 5 full blocks and one of 15 + 1 padded
# Streamed vs step-loop positions, x path length: the same kernels and draws
# in the same order, so only nondeterministic CUDA scatters may differ.
STREAM_POS_TOL = 1e-3
DEVICE_REPS = 50  # kernel calls queued behind one spin (device_time_ms)
SPIN_CYCLES = 1 << 22  # first spin, ~2 ms at the H100's ~1.98 GHz
PROFILE_START, PROFILE_STEPS = 40, 8  # main-path steps under torch.profiler
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PKG = "monocular_visual_odometry_va4mr_torch"
DEVICE = "cuda"
KERNELS = {
    "klt_lk": dict(source=f"{PKG}/csrc/klt_lk.cu",
                   replaces="monocular_visual_odometry_va4mr_tpu/ops/"
                            "klt_pallas2.py:61"),
    "klt_v1": dict(source=f"{PKG}/csrc/klt_v1.cu",
                   replaces="monocular_visual_odometry_va4mr_tpu/ops/"
                            "klt_pallas.py:146"),
}


def _import_port():
    sys.path.insert(0, REPO)
    try:
        import monocular_visual_odometry_va4mr_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run from a checkout of the repo ({e})")


def _render(args):
    scene, i = args
    return scene.render(i)


def render_scene():
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic

    scene = synthetic.make_textured_scene(
        seed=SEED, num_frames=NUM_FRAMES, image_shape=IMAGE_SHAPE, step=1.0)
    workers = max(1, min(8, os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        frames = pool.map(_render, [(scene, i) for i in range(NUM_FRAMES)])
    return scene, frames


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0]


def build_kernels():
    """One nvcc per kernel source, all started together."""
    from monocular_visual_odometry_va4mr_torch import _build

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        futs = {name: pool.submit(_build.build, name) for name in KERNELS}
        for name, fut in futs.items():
            lib, log, build_s = fut.result()
            print(f"build {name} {build_s:.2f} s -> "
                  f"{os.path.relpath(lib, REPO)}")
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "stack" in line:
                    print("  ptxas " + line.strip())


def call_time_ms(fn, runs=20):
    """Median over ``runs`` calls, each between two CUDA events on an idle
    card: the wrapper's host work before the launch falls inside."""
    import torch

    fn()  # warm
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_time_ms(fn, reps=DEVICE_REPS):
    """Device time of one call: ``reps`` calls queued behind a spin kernel
    that holds the stream while the host enqueues them.  The start event is
    recorded after the spin and the end event after the last call, so no
    host work falls inside the window.  The spin doubles until the start
    event is still pending once everything is queued."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
        if cycles >= SPIN_CYCLES << 6:
            raise RuntimeError("the spin never covered the host's enqueue")
        cycles *= 2


# Operation counts of one LK feature at win 15 (225 window pixels), the same
# for both kernels: a bilinear blend is 8 multiplies + 3 adds; the template
# takes 5 blends, 2 x (subtract, halve) for the gradients and 3
# multiply-adds for the structure tensor (65 per pixel); a Gauss-Newton
# iteration a blend, a difference and 2 multiply-adds (16 per pixel); the
# final residual a blend, a difference, an abs and an add (14 per pixel).
OPS_TEMPLATE_PX, OPS_ITER_PX, OPS_RESID_PX = 65, 16, 14
# Bytes of one feature, each pixel read once: the template block with its
# one-pixel gradient ring and the bilinear corner, (15 + 3)^2 px, and one
# (15 + 1)^2 search block, all float32.
BYTES_PIXELS = ((15 + 3) ** 2 + (15 + 1) ** 2) * 4


def bound_ms(n, iters, in_row_bytes, out_row_bytes):
    """The least time the card could take for one call: the larger of the
    bytes over HBM bandwidth and the float32 operations over the f32 peak.
    ``iters``: (N,) iterations each feature ran before it froze."""
    px = 15 * 15
    ops = n * px * (OPS_TEMPLATE_PX + OPS_RESID_PX) + px * OPS_ITER_PX * int(
        np.sum(iters))
    nbytes = n * (BYTES_PIXELS + in_row_bytes + out_row_bytes)
    t_bytes = 1e3 * nbytes / PEAK_BYTES_S
    t_ops = 1e3 * ops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def iterations_run(plain, offset_cols, num_iters):
    """Per feature, the Gauss-Newton iterations the kernel runs: the first k
    at which the plain version's offset equals its offset after num_iters
    (the update that freezes a feature is the last one it runs)."""
    import torch

    final = plain(num_iters)[:, offset_cols]
    iters = torch.full((final.shape[0],), num_iters, dtype=torch.int64,
                       device=final.device)
    for k in range(num_iters - 1, -1, -1):
        same = (plain(k)[:, offset_cols] == final).all(1)
        iters = torch.where(same, torch.full_like(iters, k), iters)
    return iters.cpu().numpy()


def kernel_case(name, kernel, plain, args, n, offset_cols, *, num_iters,
                in_row_bytes, extra):
    """One kernel against its plain version on one plane pair."""
    import torch

    out_k = kernel(*args, num_iters=num_iters, **extra)
    out_p = plain(*args, num_iters=num_iters, **extra)
    torch.cuda.synchronize()
    ok_k, ok_p = out_k[:, 2] > 0.5, out_p[:, 2] > 0.5
    both = ok_k & ok_p
    d = (out_k[both, :2] - out_p[both, :2]).abs().amax(1)
    iters = iterations_run(
        lambda k: plain(*args, num_iters=k, **extra), offset_cols, num_iters)
    b_ms, b_by, nbytes, ops = bound_ms(n, iters, in_row_bytes, 5 * 4)

    def run_kernel():
        kernel(*args, num_iters=num_iters, **extra)

    def run_plain():
        plain(*args, num_iters=num_iters, **extra)

    dev_ms = device_time_ms(run_kernel)
    res = dict(
        name=name, shape=list(args[0].shape), n=n,
        both_ok=int(both.sum()), ok_agree=float((ok_k == ok_p).float().mean()),
        pos_max=float(d.max()), pos_median=float(d.median()),
        resid_max=float((out_k[both, 3] - out_p[both, 3]).abs().max()),
        iters_mean=float(np.mean(iters)), bytes=nbytes, ops=ops,
        bound_ms=b_ms, bound_by=b_by, device_ms=dev_ms,
        bound_share=b_ms / dev_ms, call_ms=call_time_ms(run_kernel),
        plain_ms=call_time_ms(run_plain))
    print("kernel_vs_plain " + json.dumps(res), flush=True)
    if not (res["both_ok"] > 0.2 * n and res["pos_max"] < POS_TOL_PX
            and res["ok_agree"] >= OK_AGREE):
        raise RuntimeError(f"kernel disagrees with its plain version: {res}")
    return res


def bench_inputs(frames, vo):
    """Frames 12 and 13 of the scene as the main path sees them: flat
    pyramids, the main path's own corners (filled to N with random
    positions) and the coarse prior."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1

    dev = vo.device
    pyr_a = vo.make_pyramid(vo._as_image(frames[TIMED_START]))
    pyr_b = vo.make_pyramid(vo._as_image(frames[TIMED_START + 1]))
    uv, _, det_valid = vo._detect(pyr_a[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    H, W = IMAGE_SHAPE
    fill = torch.rand((N_FEATURES - uv.shape[0], 2), generator=gen,
                      device=dev) * torch.tensor([W, H], device=dev)
    pts = torch.cat([uv, fill], 0)
    valid = torch.cat([det_valid, torch.ones(fill.shape[0], dtype=torch.bool,
                                             device=dev)])
    flow = v1.coarse_flow_volume(pyr_a[2], pyr_b[2])
    prior = v1.sample_map_onehot(flow, pts / 16.0) * 16.0
    return pyr_a, pyr_b, pts, valid, prior


def case_planes(pyr_a, pyr_b, pts, prior):
    """(name, template plane, search plane, positions, prior, iterations) of
    the three main-path calls: /4 and full-res forward, full-res backward."""
    return [("full_res_forward", pyr_a[0], pyr_b[0], pts, prior, 6),
            ("quarter_res_forward", pyr_a[1], pyr_b[1], pts / 4.0,
             prior / 4.0, 6),
            ("full_res_backward_swap", pyr_b[0], pyr_a[0], pts + prior,
             -prior, 4)]


def kernel_calls(name, inputs):
    """The main path's three calls of kernel ``name`` on ``inputs``: (case,
    wrapper, plain version, args, iterations, keyword args, bytes of one
    input row)."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2

    pyr_a, pyr_b, pts, valid, prior = inputs
    gates = dict(eps=0.01, min_eig_threshold=1e-4, max_residual=20.0)
    calls = []
    for case, tmpl, srch, p, pr, iters in case_planes(pyr_a, pyr_b, pts,
                                                      prior):
        if name == "klt_lk":
            po, pp = k2._origin_and_phase(p, 15)
            qo, qp = k2._origin_and_phase(p + pr, 15)
            feat = torch.cat([po, pp, qo, qp], 1).contiguous()
            calls.append((case, k2.klt_lk, k2.klt_lk_plain,
                          (tmpl, srch, feat, valid), iters,
                          dict(win=15, **gates), k2.FEAT_COLS * 4 + 1))
        else:
            q = p + pr
            meta = torch.stack([p[:, 1], p[:, 0], q[:, 1], q[:, 0],
                                valid.to(torch.float32)], 1).contiguous()
            calls.append((case, v1.klt_v1, v1.klt_v1_plain,
                          (tmpl, srch, meta), iters, gates,
                          v1.META_COLS * 4))
    return calls


def phase_kernels(name, inputs):
    """Kernel ``name`` against its plain version at the main path's three
    calls."""
    return [kernel_case(case, kernel, plain, args, args[2].shape[0], [0, 1],
                        num_iters=iters, in_row_bytes=row_bytes, extra=extra)
            for case, kernel, plain, args, iters, extra, row_bytes
            in kernel_calls(name, inputs)]


def trajectory_health(scene, frame_ids, est, statuses):
    """LOST count, finiteness and ATE of camera positions ``est``."""
    from monocular_visual_odometry_va4mr_torch.evalx import ate

    gt = scene.poses_WC[list(frame_ids), :3, 3]
    finite = bool(np.all(np.isfinite(est)))
    ate_rmse = float(ate.ate_rmse(est, gt)) if finite else float("nan")
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    return dict(frames=len(statuses), lost=sum(1 for s in statuses if s != 0),
                finite=finite, ate=ate_rmse, ate_bound=ATE_BOUND_FRAC * path,
                path=path)


def healthy(res):
    return (not res["lost"] and res["finite"]
            and res["ate"] <= res["ate_bound"])


def device_profile(prof, steps, kernel):
    """Device time per step from a finished ``torch.profiler`` window: all
    kernels together and those whose name holds ``kernel`` (ms, calls)."""
    total_us = kernel_us = 0.0
    calls = 0
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        total_us += us
        if kernel in evt.key:
            kernel_us += us
            calls += evt.count
    return dict(steps=steps, device_ms_per_step=total_us / 1e3 / steps,
                kernel=kernel, kernel_ms_per_step=kernel_us / 1e3 / steps,
                kernel_calls_per_step=calls / steps,
                kernel_ms_per_call=kernel_us / 1e3 / calls if calls else None,
                device_time_seen=total_us > 0)


def phase_main_path(scene, frames, vo):
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2

    dev_frames = [torch.as_tensor(f).to(vo.device) for f in frames]
    torch.cuda.synchronize()
    b = BOOTSTRAP_STRIDE
    k2.klt_lk.launches = 0
    t0 = time.perf_counter()
    state = vo.bootstrap(dev_frames[0], dev_frames[b],
                         intermediate=dev_frames[1:b])
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    statuses = [int(state.status)]
    poses = [state.T_CW.cpu().numpy()]
    step_ms = []
    profiled = range(PROFILE_START, PROFILE_START + PROFILE_STEPS)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    for i in range(b + 1, NUM_FRAMES):
        if i == profiled.start:
            prof.start()
        t0 = time.perf_counter()
        state = vo.step(state, dev_frames[i])
        torch.cuda.synchronize()
        if i >= TIMED_START and i not in profiled:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        statuses.append(int(state.status))
        poses.append(state.T_CW.cpu().numpy())
        if i == profiled[-1]:
            prof.stop()
    launches = k2.klt_lk.launches
    n_steps = NUM_FRAMES - b - 1
    expected = 3 * b + 3 * n_steps  # 3 per bootstrap hop + 3 per step
    if launches != expected:
        raise RuntimeError(f"LK kernel launched {launches} times on the main "
                           f"path, expected {expected}")
    est = np.stack([-P[:3, :3].T @ P[:3, 3] for P in poses])
    res = trajectory_health(scene, range(b, NUM_FRAMES), est, statuses)
    res.update(ba_triggers=vo.ba_runs, bootstrap_s=boot_s,
               step_ms_median=statistics.median(step_ms),
               step_ms_mean=statistics.fmean(step_ms),
               launches=launches, launches_expected=expected,
               profile=device_profile(prof, PROFILE_STEPS, "klt_lk_kernel"))
    print("main_path " + json.dumps(res), flush=True)
    if not healthy(res):
        raise RuntimeError(f"main path unhealthy: {res}")
    return res


def phase_stream(scene, frames, vo):
    """``scan_driver.run_streaming`` over the main path's frames uploaded as
    uint8, in blocks with a padded tail, against a step loop over the same
    frames with the same per-frame generators."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from monocular_visual_odometry_va4mr_torch.pipeline import (
        runner, scan_driver)

    b = BOOTSTRAP_STRIDE
    u8 = [np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in frames]
    state0 = vo.bootstrap(u8[0], u8[b], intermediate=u8[1:b],
                          generator=runner.frame_generator(0, 0, vo.device))
    ids = list(range(b + 1, NUM_FRAMES))
    torch.cuda.synchronize()
    k2.klt_lk.launches = 0
    v1.klt_v1.launches = 0
    t0 = time.perf_counter()
    final, outs, fids, info = scan_driver.run_streaming(
        vo, state0, ((i, u8[i]) for i in ids), 0, block=STREAM_BLOCK)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(klt_lk=k2.klt_lk.launches, klt_v1=v1.klt_v1.launches)
    state, loop_T, loop_status = state0, [], []
    for i in ids:
        state = vo.step(state, u8[i],
                        generator=runner.frame_generator(0, i, vo.device))
        loop_T.append(state.T_CW.cpu().numpy())
        loop_status.append(int(state.status))

    def positions(Ts):
        return np.stack([-T[:3, :3].T @ T[:3, 3]
                         for T in np.asarray(Ts, np.float64)])

    est = positions([state0.T_CW.cpu().numpy()] + list(outs.T_CW))
    res = trajectory_health(scene, [b] + fids,
                            est, [int(state0.status)] + list(outs.status))
    diff = float(np.abs(positions(outs.T_CW) - positions(loop_T)).max())
    res.update(blocks=info.blocks, block=STREAM_BLOCK, wall_s=wall_s,
               ms_per_frame=1e3 * wall_s / len(ids), launches=launches,
               launches_expected=3 * len(ids), loop_pos_diff=diff,
               loop_tol=STREAM_POS_TOL * res["path"],
               statuses_equal=list(outs.status) == loop_status)
    print("stream_path " + json.dumps(res), flush=True)
    if (fids != ids or launches["klt_lk"] != 3 * len(ids)
            or launches["klt_v1"]):
        raise RuntimeError(f"stream path ran other frames or kernels: {res}")
    if not (res["statuses_equal"] and diff <= res["loop_tol"]
            and torch.equal(final.T_CW.cpu(), torch.from_numpy(outs.T_CW[-1]))):
        raise RuntimeError(f"stream path differs from the step loop: {res}")
    if not healthy(res):
        raise RuntimeError(f"stream path unhealthy: {res}")
    return res


class CountingBootstrap:
    """Wraps ``vo.bootstrap`` to count its calls and KLT hops."""

    def __init__(self, vo):
        self.inner = vo.bootstrap
        self.calls = []  # (hops, status) per call
        vo.bootstrap = self

    def __call__(self, img0, img1, intermediate=(), generator=None):
        state = self.inner(img0, img1, intermediate=intermediate,
                           generator=generator)
        self.calls.append((len(intermediate) + 1, int(state.status)))
        return state


def run_path(scene, frames, vo, num_frames):
    """``runner.run_sequence`` over the first ``num_frames`` frames; the
    kernels' counts are zeroed just before and read just after."""
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    boots = CountingBootstrap(vo)
    k2.klt_lk.launches = 0
    v1.klt_v1.launches = 0
    t0 = time.perf_counter()
    result = runner.run_sequence(
        vo, ((i, frames[i]) for i in range(num_frames)), seed=0,
        bootstrap_stride=BOOTSTRAP_STRIDE, recover=True)
    wall_s = time.perf_counter() - t0
    counts = dict(klt_lk=k2.klt_lk.launches, klt_v1=v1.klt_v1.launches)
    recs = result.records
    res = trajectory_health(scene, [r.frame for r in recs], result.positions,
                            [r.status for r in recs])
    step_ms = [r.wall_ms for r in recs[1:] if r.frame >= TIMED_START]
    hops = sum(h for h, _ in boots.calls)
    res.update(
        backend=vo.klt_backend, wall_s=wall_s, launches=counts,
        launches_expected=3 * hops + 3 * (len(recs) - 1),
        bootstrap_calls=len(boots.calls),
        recoveries=sum(1 for _, s in boots.calls[1:] if s == 0),
        step_ms_median=statistics.median(step_ms),
        step_ms_p10_p90=[float(np.percentile(step_ms, 10)),
                         float(np.percentile(step_ms, 90))])
    return res


def phase_xla(scene, frames, cfg, cam):
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    vo = VisualOdometry(cam, cfg.replace(klt=dataclasses.replace(
        cfg.klt, backend="xla")), DEVICE, seed=0)
    res = run_path(scene, frames, vo, XLA_FRAMES)
    print("xla_path " + json.dumps(res), flush=True)
    if not res["finite"]:
        raise RuntimeError(f"xla path gave a non-finite trajectory: {res}")
    if res["launches"]["klt_lk"] or res["launches"]["klt_v1"]:
        raise RuntimeError(f"the xla path launched an LK kernel: {res}")
    return res


def phase_v1_path(scene, frames, cfg, cam):
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    vo = VisualOdometry(cam, cfg.replace(klt=dataclasses.replace(
        cfg.klt, backend="pallas")), DEVICE, seed=0)
    res = run_path(scene, frames, vo, NUM_FRAMES)
    print("v1_path " + json.dumps(res), flush=True)
    if res["launches"]["klt_v1"] != res["launches_expected"]:
        raise RuntimeError(f"klt_v1 launched {res['launches']['klt_v1']} "
                           f"times, expected {res['launches_expected']}")
    if res["launches"]["klt_lk"]:
        raise RuntimeError("the v1 path launched klt_lk")
    if not healthy(res):
        raise RuntimeError(f"v1 path unhealthy: {res}")
    return res


def phase_cli():
    """The CLI in a subprocess on the card, then resumed from its
    checkpoint; the two final positions must agree."""
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        base = [sys.executable, "-m", f"{PKG}.run", "--dataset", "synthetic",
                "--max-frames", str(CLI_FRAMES), "--ba-every", "8", "--quiet",
                "--device", DEVICE]
        runs = {}
        for name, extra in (
                ("full", ["--checkpoint-dir", ckpt, "--checkpoint-every",
                          str(CLI_FRAMES // 2)]),
                ("resumed", ["--resume", ckpt])):
            metrics = os.path.join(tmp, f"{name}.jsonl")
            t0 = time.perf_counter()
            proc = subprocess.run(base + extra + ["--metrics-json", metrics],
                                  cwd=REPO, capture_output=True, text=True,
                                  timeout=600)
            wall = time.perf_counter() - t0
            tail = proc.stdout.strip().splitlines()[-6:]
            print(f"cli {name} rc={proc.returncode} {wall:.1f} s | "
                  + " | ".join(tail), flush=True)
            if proc.returncode != 0:
                raise RuntimeError(f"CLI {name} run failed:\n{proc.stdout}"
                                   f"\n{proc.stderr[-4000:]}")
            with open(metrics) as f:
                runs[name] = [json.loads(line) for line in f]
    full, resumed = runs["full"], runs["resumed"]
    pos_f = np.array([r["position"] for r in full])
    pos_r = np.array([r["position"] for r in resumed])
    path = float(np.sum(np.linalg.norm(np.diff(pos_f, axis=0), axis=1)))
    diff = float(np.abs(pos_f[-1] - pos_r[-1]).max())
    res = dict(frames=len(full), resumed_frames=len(resumed),
               lost=sum(r["status"] != 0 for r in full), path=path,
               final_pos_diff=diff, tol=CLI_RESUME_TOL * path)
    print("cli_resume " + json.dumps(res), flush=True)
    if len(full) != len(resumed) or not diff <= CLI_RESUME_TOL * path:
        raise RuntimeError(f"resumed run differs from the full one: {res}")
    return res


def kernel_entry(name, cases, launches):
    """The kernel's line: its numbers at full resolution, the device time at
    every main-path shape beside them.  ``ms`` keeps the meaning it has had
    since the first kernel line, one call with the host's work included, and
    equals ``call_ms``; ``device_ms`` is the kernel on the card alone."""
    full = cases[0]
    return dict(name=name, route="cuda", **KERNELS[name], launches=launches,
                launches_per_step=3,
                max_abs_err=max(c["pos_max"] for c in cases),
                ms=full["call_ms"], device_ms=full["device_ms"],
                call_ms=full["call_ms"], plain_ms=full["plain_ms"],
                bound_ms=full["bound_ms"], bound_by=full["bound_by"],
                bound_share=full["bound_share"], library_ms=None,
                device_ms_by_shape={c["name"]: c["device_ms"] for c in cases})


def main_path_vo(scene):
    """``bench.py``'s configuration on ``scene``: (config, camera, a
    ``VisualOdometry`` on the card)."""
    from monocular_visual_odometry_va4mr_torch.core.camera import Camera
    from monocular_visual_odometry_va4mr_torch.core.config import (
        kitti_tuned_config)
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    cfg = kitti_tuned_config().replace(image_shape=scene.image_shape,
                                       bootstrap_method="klt")
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector,
                                                   quality_level=0.03))
    cam = Camera.from_matrix(scene.K)
    return cfg, cam, VisualOdometry(cam, cfg, DEVICE, seed=0)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    _import_port()
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    build_kernels()

    t0 = time.perf_counter()
    scene, frames = render_scene()
    print(f"scene {NUM_FRAMES} frames {IMAGE_SHAPE} rendered in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg, cam, vo = main_path_vo(scene)
    inputs = bench_inputs(frames, vo)
    lk_cases = phase_kernels("klt_lk", inputs)
    main_res = phase_main_path(scene, frames, vo)
    phase_stream(scene, frames, vo)
    v1_cases = phase_kernels("klt_v1", inputs)
    phase_cli()
    phase_xla(scene, frames, cfg, cam)
    v1_res = phase_v1_path(scene, frames, cfg, cam)

    print(json.dumps({"kernels": [
        kernel_entry("klt_lk", lk_cases, main_res["launches"]),
        kernel_entry("klt_v1", v1_cases, v1_res["launches"]["klt_v1"])]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
