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
   pass (planes swapped, 4 iterations), and an input built so that the
   reference kernel's search slab wraps on every feature (``wrap_call``:
   sub = 7, each search starting 7 px down; the port reads the true rows
   there).  Agreement; the kernel's
   ``device_ms``, the device time of one call (calls queued behind a spin
   kernel, so the wrapper's host work falls outside the CUDA events), and
   its ``call_ms``, the median of 20 single calls between two events on an
   idle card, host work included; ``plain_ms``, the plain version's time
   measured as ``call_ms`` (it waits on the card inside, so no spin can
   cover its enqueue).  Then the batched case: the full-res forward call of
   4 consecutive frame pairs (12->13 .. 15->16) stacked on a batch axis, one
   launch of 4 x 1024 features, held against the batched plain version
   (``POS_TOL_PX``, ``OK_AGREE``) and against the 4 solo launches, which it
   must equal bit for bit; its ``device_ms`` beside its bound over all 4096
   features.
3. The main path, as ``bench.py`` drives it: the 100-frame textured
   KITTI-geometry scene (seed 11), ``kitti_tuned_config()`` with the KLT
   bootstrap and ``detector.quality_level=0.03`` (``klt.backend="auto"``, i.e.
   ``pallas2`` on the card), a bootstrap over frames 0..4, then one ``step``
   per frame.  ``klt_lk`` must have launched 3 times per bootstrap hop plus
   3 times per step.  Health: 0 LOST frames, a finite trajectory, ATE <= 2%
   of the path (``bench.py``'s gate without its reference-CPU term).
   ``torch.profiler`` traces 8 of the steps (left out of the step times):
   device time per step, all kernels and ``klt_lk``'s alone (its device
   events must be 3 a step), and the host's dispatches.  On the card ``step`` replays the captured step (a CUDA
   graph); the same frames then run through its body ``_step_impl`` op by
   op on a VO of the same seed (``eager_path``), and the poses must be bit
   for bit the replayed ones, with a skip graph and a BA graph captured
   and more than one BA run.  The ``step_graph`` line: host ms, host
   dispatches, device events and device ms a frame, replayed and eager;
   capture seconds per graph; peak device memory of the replayed run.
3a. The main path's bootstrap as graphs (``bootstrap_graph``): the KLT
   bootstrap over frames 0..4 replayed (``bootstrap``: a graph for the
   first frame's pyramid and corners, one a hop, the geometry captured in
   segments around torch's ``eigh`` and ``svd``, which read their error
   codes on the host) against the same work op by op
   (``bootstrap_eager``), with one generator: bit for bit equal, 3
   ``klt_lk`` launches a replayed hop; host ms, host dispatches, device
   events and device ms of each (here and in phases A and B: the replay's
   host ms over 5 synced calls, the op-by-op host ms over one, the rest
   from ``torch.profiler`` over one call of each).
3b. A preset at its own geometry: ``tools/bench_datasets``' Malaga run
   (``tune_for_tpu(malaga_config())``, the only preset with ``mid_iters=4``,
   KLT bootstrap, quality 0.03) on a 95-frame textured scene (seed 11) at
   600x800: bootstrap over frames 0..4, steps to frame 12, then the block
   driver over frames 12..94, best of 3, and 8 frames under the profiler.
   ``klt_lk`` must have launched 3 times per step plus 3 per bootstrap hop;
   health: 0 LOST, a finite trajectory and ATE <= 2% of the path over the
   timed frames, and no LOST warm-up frame.  Then ``klt_lk`` against its
   plain version at the preset's three calls, as in phase 2: the 600x800
   plane (6 iterations), the 150x200 mid plane (4), the backward pass (4)
   and the forced wrap at 600x800.  The JAX record of the same run (``BENCH_datasets.json``) is
   printed beside it, read only.
4. The block driver on the same path: ``scan_driver.run_streaming`` over
   frames 5..99 uploaded as uint8, blocks of 16 with a padded tail: each
   block's frames in chunks of 8 (``ba.every``), one replay of a chunk's
   CUDA graph each (one graph per pattern of in-step BA frames among the
   8: one, the BA at the same place in every chunk), the first 8 frames
   (no BA frame: the ring is not yet full) and the last block's 7 frames
   past its chunk replayed one by one.
   ``klt_lk`` must have launched 3 times per frame; statuses equal to, and
   positions within 1e-3 of the path of, a step loop over the same frames
   with the same per-frame generators; the health gate of phase 3.  A
   block of 8 frames under the profiler (frames 13..20, one chunk with its
   BA frame, from the step loop's state at frame 12): host dispatches and
   device events a frame, with 3 ``klt_lk`` device events a frame.  The ``block_graph``
   line: chunk replays and frames replayed one by one, the chunk graphs
   (segments, host-wait calls between them, capture seconds, replays),
   peak device memory of the stream with its captures, the largest
   position difference from the step loop and whether it is bit for bit,
   and host dispatches and device ms a frame of the profiled block beside
   a loop of ``step`` over the same 8 frames; it fails without chunk
   replays or with more than 2 host dispatches a frame.
5. The v1 LK kernel (``klt_v1``) against its plain version, the same three
   shapes and tolerances, and an input whose every template meets the
   reference's template row wrap (``wrap_call``: slab row yi % 8 == 0);
   the batched case of phase 2 on the v1 kernel.
6. The CLI in a subprocess: ``python -m monocular_visual_odometry_va4mr_torch
   .run --dataset synthetic`` over 40 frames with host-side BA every 8 and a
   checkpoint at frame 20, then again with ``--resume``; both exit 0 and the
   resumed final position matches the uninterrupted one.  Then
   (``cli_ba_graph``) the full run once more in this process (``run.main``):
   each of its windowed BAs (``ba_refine.refine_window``, the replay of its
   graph, the counterpart of ``jax.jit(run_ba)``) held bit for bit against
   the same window op by op, at least 3 of them, each a replay; host ms of
   each side, graphs captured and replayed.
7. ``klt.backend="xla"`` (the gather tracker) through ``runner.run_sequence``
   over the scene's first 20 frames at full width: health reported, the
   trajectory must be finite.
8. The v1 path: ``runner.run_sequence`` over the same 100 frames with
   ``klt.backend="pallas"``, stride 4, recovery on.  ``klt_v1`` must have
   launched 3 times per bootstrap hop (re-bootstraps included, counted
   around each bootstrap call) plus 3 times per step, ``klt_lk`` never;
   the health gate of phase 3.
A. The SIFT bootstrap: ``runner.run_sequence`` over the same 100 frames with
   ``kitti_tuned_config()``'s own ``bootstrap_method="sift"``, stride 4,
   recovery on, ``pallas2``.  ``klt_lk`` 3 launches per step (a SIFT
   bootstrap tracks nothing); the health gate of phase 3.  Also
   ``detect_and_compute`` at full resolution (the ``sift`` line): its host
   ms, device ms and device events per call, those of ``sift_graph``'s op
   by op run below, valid features and ratio matches of the bootstrap pair, the share of
   keypoints whose orientation differs from the same call on the CPU (the
   card sums the histogram in its own fixed order), and the bootstrap's
   landmarks.  Then (``sift_graph``) SIFT replayed
   (``VisualOdometry.sift_features``) against op by op, at the
   bootstrap's 512 rows and as a bank keyframe (read back to the host),
   and the SIFT bootstrap replayed against ``bootstrap_eager``: each bit
   for bit equal, with host ms, dispatches, device events and device ms;
   two eager calls on one image bit for bit equal.
B. The loop stream with the pose graph: ``make_loop_scene`` (seed 11, 640
   frames, 1.25 laps of an 81 m circle, KITTI-05 K) at 376x1241,
   ``kitti_tuned_config()`` with the KLT bootstrap (stride 8) and in-step
   BA off, streamed as uint8 by ``scan_driver.run_streaming`` (blocks of
   64, landmark snapshots, recovery) through ``keep_every``; then
   ``bank_from_stream`` (512 SIFT features a keyframe) and
   ``refine_stream_trajectory(method="sim3")``, whose loop verifier takes
   each chunk of 8 candidate pairs in one batched call (its seconds and
   calls printed).  Gates: ``klt_lk`` 3
   launches per step run plus 3 per bootstrap hop (re-bootstraps and the
   re-run of a block's tail after a recovery included); LOST <= 2% of the
   frames; a finite trajectory; >= 70 keyframes; >= 2 verified loop edges
   between keyframes >= 400 frames apart; a finite refinement.  Then
   ``tests/test_posegraph_pipeline.py``'s scale-drift test at this width: a
   compounding drift of 1.004 a frame injected into the trajectory and the
   bank (``T_CW``, ``lm_z``); the Sim(3) refinement's ATE must be below 0.85
   of the drifted ATE (the SE(3) one is printed).  Then
   (``posegraph_graph``) every pose-graph solve of phase B, which replays
   one graph of the GN iteration a key once an iteration (the counterpart
   of the reference's ``lax.scan`` body), run once more op by op: phase
   B's ``optimize_consistent`` (the first, leave-one-out and final Sim(3)
   solves) and the drift graphs' Sim(3) refinement and SE(3) solve, nodes,
   costs and dropped edges bit for bit, and phase B's solves, capture
   included, faster than op by op; capture seconds, replays, host ms a
   solve and an iteration both ways, device ms, events and dispatches of
   a replayed solve and of an iteration both ways, peak device memory.
   The ``loop_posegraph`` line carries the refinement's seconds by stage
   (``split``: retrieval, verification, graph, solves, recomposition).
   The same stream on float32 frames is run for its ATE.  Then (``phase_b_repeat``) the loop
   closure once more in this process on the same stream
   (``tools/diag_loop_repeat.loop_closure``: a bank of its own, the
   verifier, the edges, the Sim(3) refinement): equal to the first run at
   every stage, else the first stage where they differ; and the
   verifier's first chunk replayed against op by op on the same draws,
   bit for bit equal, with host ms, dispatches, device events and device
   ms of each.
C. The disk stream: phase B's 640 uint8 frames written as 8-bit gray PNGs
   (rows filtered None, Sub, Up, Average, Paeth in turn, by
   ``dataio.native_io.write_kitti``) with ``poses/05.txt`` in the KITTI
   layout under ``build/``; the native decoder built from
   ``csrc/mvo_io.cpp``.  Gates: every frame the ``PrefetchingReader``
   decodes equals its source; decode frames/s at least phase B's streamed
   frames/s; ``tools.bench_stream_2761.stream_sequence`` (the 2761-frame
   tool's stream: ``run_streaming`` over ``load_kitti(root).frames()`` cast
   to uint8) with phase B's VO, stride and generators and a block
   checkpoint every 2 blocks under ``build/`` writes its checkpoint and
   reproduces phase B's poses bit for bit, with 3 ``klt_lk`` launches per
   step run plus 3 per bootstrap hop; the CLI (``run.py --dataset kitti --data-root --tuned``: the
   preset's SIFT bootstrap at the benched operating point of
   ``tune_for_tpu``, as the main path and phase B run) in a subprocess
   exits 0 with LOST <= 2% and a finite trajectory, and its positions equal
   an in-process ``run_sequence`` over the same files within
   ``STREAM_POS_TOL`` (ATE reported, not gated).  Untuned, the preset loses
   frames around 446-525 on some draws: 1-27 of 638 on the card, 1-15 on
   the CPU, 2-6 in the JAX reference on the CPU (PERF.md;
   ``stress_diag.py --scenario kitti_preset``).
D. The realism stress of ``tests/test_tpu_e2e.py``: textured scene seed 7,
   40 frames at 480x640 through ``render_all_cached`` (spawn pool) and
   ``augment_frames(seed=3)``, ``parking_config()`` with the KLT bootstrap
   and ``quality_level=0.02``, stride 4, ``runner.run_sequence`` on
   ``pallas2``: clean, photometric + occluder, hard realism, each run with
   the runner's seeds 0, 1, 2 on RANSAC banks drawn on the CPU (the draws
   of the same runs on the CPU) and once with seed 0 on the card's own
   generator; LOST <= 2 / 4 / 2 in every run, ATE < 1.5 / 2.0 / 1.6 m in
   every run on the CPU's draws (the card-generator run's ATE reported),
   3 ``klt_lk`` launches per step and hop.  The hard-realism run of seed 0
   runs on the CPU too, and each of its steps is replayed on the card from
   the CPU's state: every step's inlier and tracked counts and status
   equal, the median position change <= ``REPLAY_MEDIAN_TOL``.
E. ``parallel/`` on the card: ``multi_seq.run_sequences_dp`` on the batched
   step (one replay a frame for every sequence) over S = 2 376x1241
   sequences (the main scene's frames 0-23, phase B's 0-23, KITTI-05 K),
   then over S = 11 (the KITTI 00-10 count), 11 windows of 24 frames of
   phase B's stream.  Each sequence is held against the same sequence run
   alone in a batch of one (``step_batch``, the same draws: statuses equal,
   positions within ``STREAM_POS_TOL``; a sequence must not depend on its
   batch-mates) and against its solo ``run_sequence`` (the libraries'
   arithmetic) on the ground truth: finite, its ATE at most the solo run's
   plus the health gate's 2% of the path.  ``klt_lk`` 3 launches per batched
   step plus 3 per bootstrap hop; ms per batched frame, frames/s over all
   sequences, device events, host dispatches and device ms per batched step
   beside a batch of one's (the events within 10%: nothing runs per
   sequence) and a solo step's (the libraries' arithmetic, fewer kernels),
   peak device memory and capture seconds; then a
   one-rank NCCL group
   (``FileStore`` under ``build/``): ``run_ba_sharded`` against ``run_ba``
   and ``run_traj_ba`` against the per-segment BA, with the collectives
   each call issued; then both again replayed (one CUDA graph of the GN
   iteration a function, its all-reduce inside, replayed once an
   iteration) and op by op (``graphs.eager()``): bit for bit, replays
   equal to the iterations, one capture a function, the same collectives
   counted, with host ms, dispatches, device events and device ms of
   each side and the capture seconds (the ``sharded_graph`` entry of the
   ``parallel`` line).  More ranks than one need more cards; the CPU
   tests hold 2 and 4 ranks on gloo.
Phase 4 also streams the float32 frames and steps them in a loop with the
same generators, for the four ATEs of {block driver, step loop} x {uint8,
float32}; phase 6 runs both CLI calls with ``--posegraph`` (the keyframe
bank goes through the checkpoint) and the resumed run's refined-or-None
outcome must equal the uninterrupted one's.  The card's machine has no
matplotlib, so no phase passes ``--plot`` (the CPU tests hold it).

Every phase prints its wall time.  The last lines are a JSON object
describing the kernels, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.  Without a card, or outside a checkout, it exits
nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
try:
    from monocular_visual_odometry_va4mr_torch.tools.harness import (
        build_kernels as harness_build, device_line, device_profile, healthy,
        host_ms, positions_of, profile_calls, profile_steps, render_frames,
        trajectory_health)
except ImportError as e:
    raise SystemExit(f"chip_smoke: run from a checkout of the repo ({e})")

NUM_FRAMES = 100
IMAGE_SHAPE = (376, 1241)
BOOTSTRAP_STRIDE = 4
SEED = 11
TIMED_START = 12  # frames before this warm up the step (bench.py)
N_FEATURES = 1024  # 512 landmark + 512 candidate slots at the bench point
BATCH = 4  # problems of the kernels' batched case
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
REPLAY_REPS = 5  # synced calls a host ms of a replayed or eager piece
SPIN_CYCLES = 1 << 22  # first spin, ~2 ms at the H100's ~1.98 GHz
PROFILE_START, PROFILE_STEPS = 40, 8  # main-path steps under torch.profiler
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Phase 3b: a preset at its own geometry through tools/bench_datasets.
PRESET, PRESET_FRAMES = "malaga", 95
# Phase B: the loop stream with the pose graph.
LOOP_FRAMES = 640
LOOP_LAPS = 1.25
LOOP_STRIDE = 8
LOOP_BLOCK = 64
LOOP_EVERY = 8  # keyframe period
LOOP_FEATURES = 512  # SIFT features per keyframe
LOOP_MIN_KEYFRAMES = 70
LOOP_MIN_EDGES = 2
LOOP_MIN_GAP = 400  # frames between the keyframes of a counted loop edge
LOOP_LOST_FRAC = 0.02
SCALE_DRIFT = 1.004  # per frame: x12.4 over the stream
DRIFT_GAIN = 0.85  # the Sim(3) ATE must be below this share of the drifted
FLIP_RAD = 0.1  # an orientation this far from the CPU's has flipped
# Phase C: the disk stream.
LOOP_CLI_LOST_FRAC = 0.02
DISK_CK_EVERY = 2  # phase C's block checkpoints: every 2 blocks of 64
DECODE_TARGET_FPS = 300  # tools/bench_native_decode.py:129's target, printed
# Phase D: the realism stress (tests/test_tpu_e2e.py:104-148): name, scene
# options, cache tag, augment_frames options, most LOST, ATE limit (m).
STRESS_SHAPE, STRESS_FRAMES, STRESS_STRIDE = (480, 640), 40, 4
# The runner's seeds of the gated runs.  Their RANSAC banks are drawn on
# the CPU (``CpuDraws``), so each card run has a CPU twin the tests can
# reproduce draw for draw; one more run per scenario draws on the card's
# own generator (LOST gated, ATE reported).  On the ``pallas2`` path the
# hard-realism ATE passes its limit on most draws but not all, on either
# device (PERF.md): a run is one draw of that spread.
STRESS_SEEDS = range(3)
# The hard-realism run of seed 0 is replayed step by step: each CPU step
# again on the card from the CPU's state must keep its inlier and tracked
# counts and status, the median position change within this (m).
REPLAY_SCENARIO, REPLAY_MEDIAN_TOL = "hard_realism", 1e-4
STRESS = (
    ("clean", {}, "", {}, 2, 1.5),
    ("photometric_occluder", {}, "",
     dict(noise_std=2.0, exposure_drift=0.10, vignette=0.2,
          occluder_frac=0.02), 4, 2.0),
    ("hard_realism", dict(tile_period=6.0, textureless_ground=True),
     "-tiled-bald", dict(noise_std=2.0, exposure_drift=0.10,
                         occluder_frac=0.10, motion_blur_px=3, gamma=0.7),
     2, 1.6),
)
# Phase E: parallel/ on the card.
MULTI_FRAMES = 24
MULTI_SEQS = 11  # KITTI odometry 00-10 (the reference's configs[4])
# Device events of a batched step within this share of a batch of one's: no
# op runs once per sequence.
EVENTS_TOL = 0.10
PAR_BA_ITERS, PAR_TRAJ_ITERS = 5, 4
PAR_BA_POS_TOL, PAR_BA_LM_TOL, PAR_TRAJ_TOL = 1e-5, 1e-4, 2e-4
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


def render_scene():
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic

    scene = synthetic.make_textured_scene(
        seed=SEED, num_frames=NUM_FRAMES, image_shape=IMAGE_SHAPE, step=1.0)
    return scene, render_frames(scene, NUM_FRAMES)


def build_kernels():
    """One nvcc per kernel source, all started together."""
    for name, (lib, log, build_s) in harness_build(DEVICE,
                                                   tuple(KERNELS)).items():
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


def bit_equal(xs, ys) -> bool:
    """Two sequences of tensors equal bit for bit (NaN payloads included)."""
    import torch

    xs, ys = list(xs), list(ys)
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.detach().cpu().contiguous().view(-1).view(torch.uint8),
            y.detach().cpu().contiguous().view(-1).view(torch.uint8))
        for x, y in zip(xs, ys))


def replayed_and_eager(replayed, eager):
    """Host ms, device events, host dispatches and device ms of a replayed
    call and of the same work op by op, both already run once by the
    caller's bit-for-bit check.  Host ms: the replay's median of
    ``REPLAY_REPS`` calls, each between two device syncs, and one such
    call op by op (10-22k dispatches; each costs the gate ~0.1-0.3 s);
    the rest from ``torch.profiler`` over one call of each."""
    out = {}
    for name, fn, reps in (("replayed", replayed, REPLAY_REPS),
                           ("eager", eager, 1)):
        dev_ms, events, dispatches = profile_calls(fn, reps=1)
        out[name] = dict(host_ms=host_ms(fn, DEVICE, reps=reps, warmup=0),
                         dispatches=dispatches, device_events=events,
                         device_ms=dev_ms)
    return out


def graph_keys(cache):
    """A graph cache's keys by their name: segments and capture seconds
    (none on the CPU, where nothing is captured)."""
    if cache is None:
        return {}
    return {str(key[0]): dict(segments=len(steps),
                              capture_s=cache.capture_s[key])
            for key, (steps, _) in cache.graphs.items()}


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
    """One kernel against its plain version on one plane pair, or on a
    batch of them (planes (B, H, W); ``n`` counts the features of all)."""
    import torch

    out_k = kernel(*args, num_iters=num_iters, **extra).reshape(-1, 5)
    out_p = plain(*args, num_iters=num_iters, **extra).reshape(-1, 5)
    torch.cuda.synchronize()
    ok_k, ok_p = out_k[:, 2] > 0.5, out_p[:, 2] > 0.5
    both = ok_k & ok_p
    d = (out_k[both, :2] - out_p[both, :2]).abs().amax(1)
    iters = iterations_run(
        lambda k: plain(*args, num_iters=k, **extra).reshape(-1, 5),
        offset_cols, num_iters)
    b_ms, b_by, nbytes, ops = bound_ms(n, iters, in_row_bytes, 5 * 4)

    def run_kernel():
        kernel(*args, num_iters=num_iters, **extra)

    def run_plain():
        plain(*args, num_iters=num_iters, **extra)

    dev_ms = device_time_ms(run_kernel)
    res = dict(
        name=name, shape=list(args[0].shape), n=n, num_iters=num_iters,
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


def bench_inputs(frames, vo, start=TIMED_START):
    """Frames ``start`` and ``start + 1`` (12 and 13) of the scene as
    ``vo``'s path sees them: flat pyramids, its own corners (filled to N
    with random positions), the coarse prior, and the LK iterations of its
    three calls (full-res and mid forward, backward) from its config."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1

    dev = vo.device
    pyr_a = vo.make_pyramid(vo._as_image(frames[start]))
    pyr_b = vo.make_pyramid(vo._as_image(frames[start + 1]))
    uv, _, det_valid = vo._detect(pyr_a[0])
    gen = torch.Generator(device=dev).manual_seed(0)
    H, W = vo.config.image_shape
    fill = torch.rand((N_FEATURES - uv.shape[0], 2), generator=gen,
                      device=dev) * torch.tensor([W, H], device=dev)
    pts = torch.cat([uv, fill], 0)
    valid = torch.cat([det_valid, torch.ones(fill.shape[0], dtype=torch.bool,
                                             device=dev)])
    flow = v1.coarse_flow_volume(pyr_a[2], pyr_b[2])
    prior = v1.sample_map_onehot(flow, pts / 16.0) * 16.0
    k = vo.config.klt  # as pipeline/vo.py's _track and _track_fb cap them
    iters = (min(k.num_iters, 8), min(k.mid_iters or k.num_iters, 8),
             min(k.num_iters, k.fb_iters, 8))
    return pyr_a, pyr_b, pts, valid, prior, iters


def case_planes(pyr_a, pyr_b, pts, prior, iters):
    """(name, template plane, search plane, positions, prior, iterations) of
    a path's three calls: /4 and full-res forward, full-res backward."""
    full, mid, back = iters
    return [("full_res_forward", pyr_a[0], pyr_b[0], pts, prior, full),
            ("quarter_res_forward", pyr_a[1], pyr_b[1], pts / 4.0,
             prior / 4.0, mid),
            ("full_res_backward_swap", pyr_b[0], pyr_a[0], pts + prior,
             -prior, back)]


def kernel_calls(name, inputs, prefix=""):
    """A path's three calls of kernel ``name`` on ``inputs`` (cases named
    ``prefix`` + plane): (case, wrapper, plain version, args, iterations,
    keyword args, bytes of one input row)."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2

    pyr_a, pyr_b, pts, valid, prior, path_iters = inputs
    gates = dict(eps=0.01, min_eig_threshold=1e-4, max_residual=20.0)
    calls = []
    for case, tmpl, srch, p, pr, iters in case_planes(pyr_a, pyr_b, pts,
                                                      prior, path_iters):
        case = prefix + case
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


def wrap_call(name, inputs, prefix=""):
    """A call of kernel ``name`` built so that the reference kernel's slab
    wraps on every feature, in the form of ``kernel_calls``: the template is
    the path's full-resolution plane, the search plane the same moved by
    whole pixels, and every position is snapped to rows that wrap.

    ``klt_lk``: the search plane is 7 rows down and every template row has
    floor(y) = 6 (mod 8), so the search origin floor(y) - 7 has sub = 7;
    every search starts at its true offset, 7 + phase px down (n = 7), and
    rows 10.. of its first window lie past the reference's slab, which
    reads them 32 rows up (the port reads the true rows).  ``klt_v1``: the
    search plane is 1 row down and 2 px left and every template row has
    floor(y) = 7 (mod 8), so the template's slab row yi is a multiple of 8
    and the upward gradient of its row 0 reads slab row yi + 23, in the
    reference and in the port."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2

    pyr_a, _, pts, valid, _, (iters, _, _) = inputs
    tmpl = pyr_a[0]
    gates = dict(eps=0.01, min_eig_threshold=1e-4, max_residual=20.0)
    y = pts[:, 1]
    if name == "klt_lk":
        srch = torch.roll(tmpl, 7, 0).contiguous()
        p = torch.stack([pts[:, 0],
                         y - torch.remainder(torch.floor(y) - 6, 8)], 1)
        po, pp = k2._origin_and_phase(p, 15)
        g0 = pp + torch.tensor([0.0, 7.0], device=pp.device)
        feat = torch.cat([po, pp, po, g0], 1).contiguous()
        if not bool((torch.remainder(po[:, 1] + k2.PAD - 8, 8) == 7).all()):
            raise RuntimeError("wrap_call: a search origin misses sub = 7")
        return (prefix + "full_res_forced_wrap", k2.klt_lk, k2.klt_lk_plain,
                (tmpl, srch, feat, valid), iters, dict(win=15, **gates),
                k2.FEAT_COLS * 4 + 1)
    srch = torch.roll(tmpl, (1, -2), (0, 1)).contiguous()
    p = torch.stack([pts[:, 0], y - torch.remainder(torch.floor(y) - 7, 8)],
                    1)
    q = p + torch.tensor([-2.0, 1.0], device=p.device)
    meta = torch.stack([p[:, 1], p[:, 0], q[:, 1], q[:, 0],
                        valid.to(torch.float32)], 1).contiguous()
    if not bool((v1.slab_geometry(meta, *tmpl.shape)[2] % 8 == 0).all()):
        raise RuntimeError("wrap_call: a template row misses the wrap")
    return (prefix + "full_res_forced_wrap", v1.klt_v1, v1.klt_v1_plain,
            (tmpl, srch, meta), iters, gates, v1.META_COLS * 4)


def phase_kernels(name, inputs, prefix="", batch_inputs=None):
    """Kernel ``name`` against its plain version at a path's three calls,
    and on the input whose slab rows wrap (``wrap_call``); with
    ``batch_inputs``, the batched case (``batched_case``) last."""
    cases = [kernel_case(case, kernel, plain, args, args[2].shape[0], [0, 1],
                         num_iters=iters, in_row_bytes=row_bytes, extra=extra)
             for case, kernel, plain, args, iters, extra, row_bytes
             in kernel_calls(name, inputs, prefix)
             + [wrap_call(name, inputs, prefix)]]
    if batch_inputs is not None:
        cases.append(batched_case(name, batch_inputs))
    return cases


def batch_pairs(frames, vo):
    """``bench_inputs`` of the frame pairs TIMED_START + k -> + k + 1,
    k < BATCH: the batched case's problems."""
    return [bench_inputs(frames, vo, TIMED_START + k) for k in range(BATCH)]


def batched_case(name, batch_inputs):
    """Kernel ``name`` on its full-res forward call of BATCH frame pairs
    stacked on a batch axis: one launch for all, held against the batched
    plain version as ``kernel_case`` holds a call, and against the BATCH
    solo launches, which it must equal bit for bit."""
    import torch

    calls = [kernel_calls(name, inputs)[0] for inputs in batch_inputs]
    _, kernel, plain, _, iters, extra, row_bytes = calls[0]
    args = [torch.stack(ts) for ts in zip(*(c[3] for c in calls))]
    n = args[2].shape[0] * args[2].shape[1]
    before = kernel.launches
    out_b = kernel(*args, num_iters=iters, **extra)
    launches = kernel.launches - before
    solo = torch.stack([kernel(*c[3], num_iters=iters, **extra)
                        for c in calls])
    torch.cuda.synchronize()
    bit_equal = torch.equal(out_b.view(torch.int32), solo.view(torch.int32))
    res = kernel_case(f"full_res_forward_batch{BATCH}", kernel, plain, args,
                      n, [0, 1], num_iters=iters, in_row_bytes=row_bytes,
                      extra=extra)
    res.update(batch=BATCH, launches_per_call=launches,
               bit_equal_to_solo=bit_equal)
    print("kernel_batched " + json.dumps(res), flush=True)
    if not (bit_equal and launches == 1):
        raise RuntimeError(f"the batched launch differs from {BATCH} solo "
                           f"launches, or was not one launch: {res}")
    return res


def phase_main_path(scene, frames, vo, cfg, cam):
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2

    dev_frames = [torch.as_tensor(f).to(vo.device) for f in frames]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b = BOOTSTRAP_STRIDE
    k2.klt_lk.launches = 0
    t0 = time.perf_counter()
    state = vo.bootstrap(dev_frames[0], dev_frames[b],
                         intermediate=dev_frames[1:b])
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    boot_launches = k2.klt_lk.launches
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
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    n_steps = NUM_FRAMES - b - 1
    expected = 3 * b + 3 * n_steps  # 3 per bootstrap hop + 3 per step
    if launches != expected:
        raise RuntimeError(f"LK kernel launched {launches} times on the main "
                           f"path, expected {expected}")
    est = np.stack([-P[:3, :3].T @ P[:3, 3] for P in poses])
    res = trajectory_health(scene, range(b, NUM_FRAMES), est, statuses)
    profile = device_profile(prof, PROFILE_STEPS, "klt_lk_kernel")
    res.update(ba_triggers=vo.ba_runs, bootstrap_s=boot_s,
               step_ms_median=statistics.median(step_ms),
               step_ms_mean=statistics.fmean(step_ms),
               launches=launches, launches_expected=expected,
               launches_in_bootstrap=boot_launches,
               launches_per_step=(launches - boot_launches) / n_steps,
               profile=profile)
    print("main_path " + json.dumps(res), flush=True)
    if not healthy(res):
        raise RuntimeError(f"main path unhealthy: {res}")
    # The launch counts of replayed steps come from the capture; the
    # profiler's device events show that each replay ran the kernel 3 times.
    if profile["kernel_calls_per_step"] != 3:
        raise RuntimeError(f"the profiled steps ran klt_lk_kernel "
                           f"{profile['kernel_calls_per_step']} times a "
                           f"step, expected 3: {profile}")

    # The same frames through the step's body op by op, on a VO of the same
    # config and seed (the same bootstrap and draws): bit for bit the poses
    # of the replayed graph.
    eager = eager_path(dev_frames, cfg, cam)
    graphs = vo.graphs
    bit_equal = (len(eager["poses"]) == len(poses) and all(
        np.array_equal(p, q) for p, q in zip(poses, eager["poses"])))
    first_diff = next((b + k for k, (p, q) in enumerate(
        zip(poses, eager["poses"])) if not np.array_equal(p, q)), None)
    res["step_graph"] = sg = dict(
        steps=n_steps, ba_triggers=vo.ba_runs, bit_equal=bit_equal,
        first_differing_frame=first_diff,
        host_ms_per_frame=dict(graph=res["step_ms_median"],
                               eager=statistics.median(eager["step_ms"])),
        dispatches_per_frame=dict(
            graph=profile["dispatches_per_step"],
            eager=eager["profile"]["dispatches_per_step"]),
        device_events_per_frame=dict(
            graph=profile["launches_per_step"],
            eager=eager["profile"]["launches_per_step"]),
        device_ms_per_frame=dict(
            graph=profile["device_ms_per_step"],
            eager=eager["profile"]["device_ms_per_step"]),
        capture_s={"/".join(str(k) for k in key): v
                   for key, v in graphs.capture_s.items()},
        graphs=len(graphs.graphs), replays=graphs.replays,
        peak_device_mb=peak_mb)
    print("step_graph " + json.dumps(sg), flush=True)
    if not bit_equal:
        raise RuntimeError(f"the replayed step differs from _step_impl: {sg}")
    if sg["graphs"] != 2 or vo.ba_runs < 2:
        raise RuntimeError(f"expected a skip and a BA graph, the BA run more "
                           f"than once: {sg}")
    return res


def eager_step(vo, state, image, generator=None):
    """``vo``'s step run op by op through ``_step_impl``, as ``step`` runs
    it on the CPU."""
    new = vo._step_impl(state, image, vo.step_draws(generator),
                        vo.ba_due(state))
    new.host_frame = state.host_frame_idx() + 1
    return new


def eager_path(dev_frames, cfg, cam):
    """The main path's bootstrap and steps on a new VO of ``cfg``, each step
    through ``eager_step``: poses, step ms over the same frames, and a
    profiler window over the same steps."""
    import torch

    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    vo = VisualOdometry(cam, cfg, DEVICE, seed=0)
    b = BOOTSTRAP_STRIDE
    state = vo.bootstrap(dev_frames[0], dev_frames[b],
                         intermediate=dev_frames[1:b])
    poses, step_ms = [state.T_CW.cpu().numpy()], []
    profiled = range(PROFILE_START, PROFILE_START + PROFILE_STEPS)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    for i in range(b + 1, NUM_FRAMES):
        if i == profiled.start:
            prof.start()
        t0 = time.perf_counter()
        state = eager_step(vo, state, dev_frames[i])
        torch.cuda.synchronize()
        if i >= TIMED_START and i not in profiled:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        poses.append(state.T_CW.cpu().numpy())
        if i == profiled[-1]:
            prof.stop()
    return dict(poses=poses, step_ms=step_ms,
                profile=device_profile(prof, PROFILE_STEPS, "klt_lk_kernel"))


def phase_bootstrap_graph(frames, vo):
    """The main path's KLT bootstrap (frames 0..4) replayed (``bootstrap``:
    the first frame's graph, one graph a hop, the geometry's segments)
    against the same work op by op (``bootstrap_eager``), with the same
    generator: bit for bit equal, 3 ``klt_lk`` launches a hop; host ms,
    dispatches, device events and device ms of each."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    b = BOOTSTRAP_STRIDE
    imgs = [torch.as_tensor(f).to(vo.device) for f in frames[:b + 1]]

    def boot(fn):
        return fn(imgs[0], imgs[b], intermediate=imgs[1:b],
                  generator=runner.frame_generator(0, 0, vo.device))

    k2.klt_lk.launches = 0
    replayed = boot(vo.bootstrap)
    launches = k2.klt_lk.launches
    eager = boot(vo.bootstrap_eager)
    res = dict(bit_equal=bit_equal(replayed.tensors(), eager.tensors()),
               status=int(replayed.status),
               landmarks=int(replayed.lm_valid.sum()), hops=b,
               klt_lk_per_hop=launches / b, graphs=graph_keys(vo.fn_graphs),
               **replayed_and_eager(lambda: boot(vo.bootstrap),
                                    lambda: boot(vo.bootstrap_eager)))
    print("bootstrap_graph " + json.dumps(res), flush=True)
    if not res["bit_equal"]:
        raise RuntimeError(f"the replayed bootstrap differs from the eager "
                           f"one: {res}")
    if launches != 3 * b:
        raise RuntimeError(f"klt_lk launched {launches} times over {b} "
                           f"replayed hops, expected {3 * b}")
    return res


def phase_presets(smi):
    """Phase 3b: ``tools/bench_datasets``' Malaga run at full width (600x800,
    95 frames, ``tune_for_tpu(malaga_config())``, ``mid_iters=4``), its
    ``klt_lk`` launches counted from 0 over the run and gated at 3 per step
    and per bootstrap hop, the health gate over the warm-up and the timed
    frames; then ``klt_lk`` against its plain version at the preset's three
    calls (600x800 forward, 150x200 at 4 iterations, backward)."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from monocular_visual_odometry_va4mr_torch.tools import bench_datasets

    t0 = time.perf_counter()
    scene, frames, vo = bench_datasets.make_case(PRESET, PRESET_FRAMES,
                                                 DEVICE)
    render_s = time.perf_counter() - t0
    boots, steps = CountingBootstrap(vo), CountingStep(vo)
    torch.cuda.synchronize()
    k2.klt_lk.launches = 0
    line = bench_datasets.run_case(PRESET, scene, frames, vo, smi)
    launches = k2.klt_lk.launches
    expected = 3 * (steps.calls + boots.hops)
    line.update(render_s=render_s, launches=launches,
                launches_expected=expected, steps_run=steps.calls,
                bootstrap_hops=boots.hops)
    print(f"preset_{PRESET} " + json.dumps(line), flush=True)
    if launches != expected or not launches:
        raise RuntimeError(f"klt_lk launched {launches} times on the "
                           f"{PRESET} path, expected {expected}")
    if not (line["healthy"] and line["lost_warmup"] == 0):
        raise RuntimeError(f"{PRESET} preset unhealthy: {line}")
    cases = phase_kernels("klt_lk", bench_inputs(frames, vo), f"{PRESET}_")
    return dict(path=line, cases=cases)


def pose_WC(T_CW):
    """(4, 4) T_WC of a T_CW pose."""
    T = np.eye(4)
    T[:3, :3] = T_CW[:3, :3].T
    T[:3, 3] = -T_CW[:3, :3].T @ T_CW[:3, 3]
    return T


def phase_stream(scene, frames, vo):
    """``scan_driver.run_streaming`` over the main path's frames uploaded as
    uint8, in blocks with a padded tail, against a step loop over the same
    frames with the same per-frame generators; then both again on the
    float32 frames, for the four ATEs."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from monocular_visual_odometry_va4mr_torch.pipeline import (
        runner, scan_driver)
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        frame_outputs)

    b = BOOTSTRAP_STRIDE
    u8 = [np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in frames]
    ids = list(range(b + 1, NUM_FRAMES))

    def start(fr):
        return vo.bootstrap(fr[0], fr[b], intermediate=fr[1:b],
                            generator=runner.frame_generator(0, 0, vo.device))

    def loop(state, fr, fields=None):
        """A ``step`` a frame: the poses and statuses; each frame's outputs
        (``frame_outputs``) appended to ``fields`` when given."""
        Ts, sts = [], []
        for i in ids:
            state = vo.step(state, fr[i],
                            generator=runner.frame_generator(0, i, vo.device))
            Ts.append(state.T_CW.cpu().numpy())
            sts.append(int(state.status))
            if fields is not None:
                fields.append([o.cpu().numpy()
                               for o in frame_outputs(state)])
        return Ts, sts

    state0 = start(u8)
    graphs = vo.graphs
    replays = ReplaysByKey(graphs)
    counted = CountingStep(vo)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k2.klt_lk.launches = 0
    v1.klt_v1.launches = 0
    t0 = time.perf_counter()
    final, outs, fids, info = scan_driver.run_streaming(
        vo, state0, ((i, u8[i]) for i in ids), 0, block=STREAM_BLOCK)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(klt_lk=k2.klt_lk.launches, klt_v1=v1.klt_v1.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    vo.step, vo.step_chunk = counted.inner, counted.inner_chunk
    chunk_replays = dict(replays.counts)
    loop_outs = []
    loop_T, loop_status = loop(state0, u8, loop_outs)

    est = positions_of([state0.T_CW.cpu().numpy()] + list(outs.T_CW))
    res = trajectory_health(scene, [b] + fids,
                            est, [int(state0.status)] + list(outs.status))
    diff = float(np.abs(positions_of(outs.T_CW)
                        - positions_of(loop_T)).max())
    res.update(blocks=info.blocks, block=STREAM_BLOCK, wall_s=wall_s,
               ms_per_frame=1e3 * wall_s / len(ids), launches=launches,
               launches_expected=3 * len(ids), loop_pos_diff=diff,
               loop_tol=STREAM_POS_TOL * res["path"],
               statuses_equal=list(outs.status) == loop_status)

    # The same frames as float32, the same generators: what rounding the
    # frames to uint8 does, apart from the draws.
    state0f = start(frames)
    _, outs_f, _, _ = scan_driver.run_streaming(
        vo, state0f, ((i, frames[i]) for i in ids), 0, block=STREAM_BLOCK)
    loop_Tf, loop_status_f = loop(state0f, frames)

    def ate(s0, Ts, sts):
        return trajectory_health(scene, [b] + ids,
                                 positions_of([s0.T_CW.cpu().numpy()]
                                              + list(Ts)),
                                 [int(s0.status)] + list(sts))

    # The block driver's host dispatches and device events per frame over
    # one block of PROFILE_STEPS frames (its upload and read-back included):
    # the second PROFILE_STEPS frames, from the step loop's state before
    # them, one chunk with its BA frame (the first PROFILE_STEPS hold none,
    # the ring not yet full, and are stepped one by one).
    prof_state = state0
    for i in ids[:PROFILE_STEPS]:
        prof_state = vo.step(
            prof_state, u8[i],
            generator=runner.frame_generator(0, i, vo.device))
    prof_ids = ids[PROFILE_STEPS:2 * PROFILE_STEPS]
    if not any(vo.ba_flags(prof_state, len(prof_ids))):
        raise RuntimeError("the profiled block holds no BA frame")
    res["profile"] = profile_steps(
        lambda: scan_driver.run_streaming(
            vo, prof_state, ((i, u8[i]) for i in prof_ids), 0,
            block=len(prof_ids)), len(prof_ids), DEVICE)
    if res["profile"]["klt_lk_per_step"] != 3:
        raise RuntimeError(f"the profiled block ran klt_lk_kernel "
                           f"{res['profile']['klt_lk_per_step']} times a "
                           f"frame, expected 3: {res['profile']}")
    graphs.replay = replays.inner

    def step_loop():
        state = prof_state
        for i in prof_ids:
            state = vo.step(state, u8[i],
                            generator=runner.frame_generator(0, i, vo.device))

    bg = block_graph(vo, graphs, counted, chunk_replays, peak_mb, outs,
                     loop_outs, res, profile_steps(step_loop, len(prof_ids),
                                                   DEVICE))
    four = dict(block_uint8=res, loop_uint8=ate(state0, loop_T, loop_status),
                block_float32=ate(state0f, outs_f.T_CW, outs_f.status),
                loop_float32=ate(state0f, loop_Tf, loop_status_f))
    res["ates"] = {k: dict(ate=v["ate"], lost=v["lost"])
                   for k, v in four.items()}
    print("stream_path " + json.dumps(res), flush=True)
    if (fids != ids or launches["klt_lk"] != 3 * len(ids)
            or launches["klt_v1"]):
        raise RuntimeError(f"stream path ran other frames or kernels: {res}")
    if not (res["statuses_equal"] and diff <= res["loop_tol"]
            and torch.equal(final.T_CW.cpu(), torch.from_numpy(outs.T_CW[-1]))):
        raise RuntimeError(f"stream path differs from the step loop: {res}")
    if not healthy(res):
        raise RuntimeError(f"stream path unhealthy: {res}")
    res["block_graph"] = bg
    return res


class ReplaysByKey:
    """Wraps a graph cache's ``replay`` to count the replays of each key."""

    def __init__(self, cache):
        self.inner = cache.replay
        self.counts = {}
        cache.replay = self

    def __call__(self, key):
        self.counts[key] = self.counts.get(key, 0) + 1
        return self.inner(key)


def block_graph(vo, graphs, counted, replays, peak_mb, outs, loop_outs, res,
                loop_profile):
    """The ``block_graph`` line of phase 4: how the block driver ran its
    frames (chunk replays, frames replayed one by one), the chunk graphs
    (keys: segments, host-wait calls, capture seconds, replays), peak
    device memory of the stream with its captures, the largest position
    difference from the step loop, whether every output field of every
    frame is bit for bit the loop's (``loop_outs``: its ``frame_outputs``
    a frame) and which fields differ, and the host dispatches and device
    ms a frame of the profiled block against a loop of ``step`` over the
    same frames (``loop_profile``).  Gates: chunk replays on the path,
    every frame stepped once, and at most 2 host dispatches a frame."""
    chunks = {k: v for k, v in graphs.graphs.items() if k[0] == "chunk"}
    keys = {"/".join(str(x) for x in k[1:]): dict(
        segments=sum(1 for st in steps if not isinstance(st, tuple)),
        host_waits=sum(1 for st in steps if isinstance(st, tuple)),
        capture_s=graphs.capture_s[k], replays=replays.get(k, 0))
        for k, (steps, _) in chunks.items()}
    differ = [f for k, f in enumerate(outs._fields[:len(loop_outs[0])])
              if not np.array_equal(getattr(outs, f),
                                    np.stack([o[k] for o in loop_outs]))]
    bg = dict(
        chunk_frames=vo.chunk_frames, frames=counted.calls,
        chunk_replays=counted.chunks, frames_alone=counted.alone,
        keys=keys, captures=len(chunks),
        capture_s=sum(v["capture_s"] for v in keys.values()),
        peak_device_mb=peak_mb, loop_pos_diff=res["loop_pos_diff"],
        bit_equal_to_step_loop=not differ, fields_differing=differ,
        dispatches_per_frame=dict(
            block=res["profile"]["dispatches_per_step"],
            step_loop=loop_profile["dispatches_per_step"]),
        device_ms_per_frame=dict(
            block=res["profile"]["device_ms_per_step"],
            step_loop=loop_profile["device_ms_per_step"]))
    print("block_graph " + json.dumps(bg), flush=True)
    if not counted.chunks or counted.calls != len(loop_outs):
        raise RuntimeError(f"the block driver ran no chunk, or other frames: "
                           f"{bg}")
    if bg["dispatches_per_frame"]["block"] > 2:
        raise RuntimeError(f"the chunked block took more than 2 host "
                           f"dispatches a frame: {bg}")
    return bg


def kernel_launches():
    """Both LK wrappers' launch counts."""
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2

    return dict(klt_lk=k2.klt_lk.launches, klt_v1=v1.klt_v1.launches)


class CountingBootstrap:
    """Wraps ``vo.bootstrap`` to count its calls, KLT hops and landmarks,
    and the LK kernels' launches inside the calls (``launches``)."""

    def __init__(self, vo):
        self.inner = vo.bootstrap
        self.sift = vo.config.bootstrap_method == "sift"
        self.calls = []  # (KLT hops, status, landmarks) per call
        self.launches = dict.fromkeys(kernel_launches(), 0)
        vo.bootstrap = self

    def __call__(self, img0, img1, intermediate=(), generator=None):
        before = kernel_launches()
        state = self.inner(img0, img1, intermediate=intermediate,
                           generator=generator)
        for k, n in kernel_launches().items():
            self.launches[k] += n - before[k]
        hops = 0 if self.sift else len(intermediate) + 1
        self.calls.append((hops, int(state.status),
                           int(state.lm_valid.sum())))
        return state

    @property
    def hops(self):
        return sum(h for h, _, _ in self.calls)

    @property
    def recoveries(self):
        return sum(1 for _, s, _ in self.calls[1:] if s == 0)


class CountingStep:
    """Wraps ``vo.step`` and ``vo.step_chunk`` to count the frames stepped
    (``calls``: a frame a ``step``, K a chunk), the chunks among them
    (``chunks``) and the frames stepped alone (``alone``); ``first``: the
    host clock at the first."""

    def __init__(self, vo):
        self.inner, self.inner_chunk = vo.step, vo.step_chunk
        self.calls = self.chunks = self.alone = 0
        self.first = None
        vo.step, vo.step_chunk = self, self.chunk

    def __call__(self, state, image, generator=None, **kw):
        if self.first is None:
            self.first = time.perf_counter()
        self.calls += 1
        self.alone += 1
        return self.inner(state, image, generator=generator, **kw)

    def chunk(self, state, images, draws, **kw):
        if self.first is None:
            self.first = time.perf_counter()
        self.calls += images.shape[0]
        self.chunks += 1
        return self.inner_chunk(state, images, draws, **kw)


class CountingBatch:
    """Wraps ``vo.step_batch`` to count the batched steps run, each timed
    between two device syncs, and to keep the last call's arguments."""

    def __init__(self, vo):
        self.vo = vo
        self.inner = vo.step_batch
        self.ms, self.captured = [], []
        self.last = None
        vo.step_batch = self

    def __call__(self, states, images, generators, **kw):
        import torch

        graphs = self.graphs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner(states, images, generators, **kw)
        torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        self.captured.append(self.graphs() != graphs)
        self.last = (states, images)
        return out

    def graphs(self):
        """The VO's captured graphs so far (none before the first replay)."""
        return len(self.vo.graphs.graphs) if self.vo.graphs else 0

    @property
    def calls(self):
        return len(self.ms)


def run_path(scene, frames, vo, num_frames):
    """``runner.run_sequence`` over the first ``num_frames`` frames; the
    kernels' counts are zeroed just before and read just after, those
    inside the bootstraps apart (``launches_in_bootstraps``)."""
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
    counts = kernel_launches()
    recs = result.records
    res = trajectory_health(scene, [r.frame for r in recs], result.positions,
                            [r.status for r in recs])
    step_ms = [r.wall_ms for r in recs[1:] if r.frame >= TIMED_START]
    res.update(
        backend=vo.klt_backend, wall_s=wall_s, launches=counts,
        launches_in_bootstraps=boots.launches,
        launches_expected=3 * boots.hops + 3 * (len(recs) - 1),
        bootstrap_hops=boots.hops, steps=len(recs) - 1,
        bootstrap_calls=len(boots.calls), recoveries=boots.recoveries,
        bootstrap_landmarks=boots.calls[0][2],
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
    if res["launches_in_bootstraps"]["klt_v1"] != 3 * res["bootstrap_hops"]:
        raise RuntimeError(f"klt_v1 launched {res['launches_in_bootstraps']}"
                           f" times in {res['bootstrap_hops']} bootstrap "
                           f"hops, expected 3 a hop")
    if res["launches"]["klt_lk"]:
        raise RuntimeError("the v1 path launched klt_lk")
    if not healthy(res):
        raise RuntimeError(f"v1 path unhealthy: {res}")
    return res


def phase_cli():
    """The CLI with the pose graph in a subprocess on the card, then resumed
    from its checkpoint (keyframe bank included); the two final positions
    and refined-or-None outcomes must agree."""
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        base = [sys.executable, "-m", f"{PKG}.run", "--dataset", "synthetic",
                "--max-frames", str(CLI_FRAMES), "--ba-every", "8", "--quiet",
                "--posegraph", "--device", DEVICE]
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
    ref_f, ref_r = (full[-1]["refined_position"],
                    resumed[-1]["refined_position"])
    same_outcome = (ref_f is None) == (ref_r is None)
    ref_diff = (float(np.abs(np.subtract(ref_f, ref_r)).max())
                if same_outcome and ref_f is not None else None)
    res = dict(frames=len(full), resumed_frames=len(resumed),
               lost=sum(r["status"] != 0 for r in full), path=path,
               final_pos_diff=diff, tol=CLI_RESUME_TOL * path,
               refined=ref_f is not None, refined_same_outcome=same_outcome,
               refined_final_diff=ref_diff)
    print("cli_resume " + json.dumps(res), flush=True)
    if (len(full) != len(resumed) or not diff <= CLI_RESUME_TOL * path
            or not same_outcome
            or (ref_diff is not None and not ref_diff <= CLI_RESUME_TOL
                * path)):
        raise RuntimeError(f"resumed run differs from the full one: {res}")
    res["ba_graph"] = cli_ba_graph(base, pos_f)
    return res


def cli_ba_graph(argv, positions):
    """The CLI's full run once more in this process (``run.main`` with the
    subprocess's arguments, no checkpoint): each windowed BA of its
    ``--ba-every 8`` (``ba_refine.refine_window``, on the card the replay
    of its graph in ``core.graphs.shared``, the counterpart of the
    reference's ``jax.jit(run_ba)``) against the same window op by op
    (``graphs.eager()``), bit for bit; the graphs captured and replayed,
    host ms of each side, and whether the positions equal the
    subprocess's.  Prints the ``cli_ba_graph`` line; every check
    raises."""
    import torch

    from monocular_visual_odometry_va4mr_torch import run
    from monocular_visual_odometry_va4mr_torch.core import graphs
    from monocular_visual_odometry_va4mr_torch.pipeline import ba_refine

    dev = torch.device(DEVICE)
    captured, capture_s = graphs.captures(dev)
    replays = graphs.replays(dev)
    timed = Timed(ba_refine, "refine_window")
    try:
        result = run.main(argv[3:])  # after python -m <module>
    finally:
        timed.restore()
    captures = graphs.captures(dev)
    eager = [rerun_eager(timed, k) for k in range(len(timed.calls))]
    W, L = (tuple(timed.calls[0][0][0].obs_mask.shape) if timed.calls
            else (None, None))
    res = dict(
        calls=len(timed.calls), window=W, landmarks=L,
        bit_equal=[bit_equal(r, e) for r, (e, _) in zip(timed.results,
                                                          eager)],
        captures=captures[0] - captured, capture_s=captures[1] - capture_s,
        replays=graphs.replays(dev) - replays,
        host_ms_replayed=[1e3 * t for t in timed.seconds],
        host_ms_eager=[1e3 * t for _, t in eager],
        positions_equal_subprocess=bool(np.array_equal(
            np.array([r.T_WC[:3, 3] for r in result.records]), positions)))
    print("cli_ba_graph " + json.dumps(res), flush=True)
    if not (res["calls"] >= 3 and all(res["bit_equal"])
            and res["replays"] >= res["calls"]):
        raise RuntimeError(f"the CLI's windowed BA did not replay, or its "
                           f"replay differs from op by op: {res}")
    return res


def pair_keypoints(a, b):
    """Valid keypoints of SiftFeatures ``a`` paired with ``b``'s (CPU
    tensors): by position within 1e-2 px, then nearest orientation.
    Returns (paired mask, partner index, position error, orientation error)
    over ``a``'s valid rows."""
    import torch

    av, bv = a.valid.cpu(), b.valid.cpu()
    d = (a.uv.cpu()[av][:, None] - b.uv.cpu()[bv][None]).abs().amax(-1)
    do = torch.remainder(a.orientation.cpu()[av][:, None]
                         - b.orientation.cpu()[bv][None] + np.pi,
                         2 * np.pi) - np.pi
    best, nn = torch.where(d < 1e-2, do.abs(), torch.inf).min(1)
    return torch.isfinite(best), nn, d[torch.arange(len(nn)), nn], best


def sift_config(scene):
    """``kitti_tuned_config()`` with its own SIFT bootstrap (phase A)."""
    from monocular_visual_odometry_va4mr_torch.core.config import (
        kitti_tuned_config)

    cfg = kitti_tuned_config().replace(image_shape=scene.image_shape)
    if cfg.bootstrap_method != "sift":
        raise RuntimeError("kitti_tuned_config no longer bootstraps on SIFT")
    return cfg.replace(detector=dataclasses.replace(cfg.detector,
                                                    quality_level=0.03))


def phase_sift(scene, frames, cam):
    """Phase A: ``detect_and_compute`` at full resolution, then the SIFT
    bootstrap through the runner."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import match, sift
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    cfg = sift_config(scene)
    sc = cfg.sift
    kw = dict(max_features=cfg.capacity.max_candidates,
              num_octaves=sc.num_octaves,
              scales_per_octave=sc.scales_per_octave,
              contrast_threshold=sc.contrast_threshold,
              edge_threshold=sc.edge_threshold, sigma=sc.sigma,
              first_octave=sc.first_octave)
    img0 = torch.as_tensor(frames[0]).to(DEVICE)
    img1 = torch.as_tensor(frames[BOOTSTRAP_STRIDE]).to(DEVICE)
    f0 = sift.detect_and_compute(img0, **kw)
    f1 = sift.detect_and_compute(img1, **kw)
    _, ok = match.match_ratio(f0.desc, f0.valid, f1.desc, f1.valid,
                              ratio=sc.ratio)
    paired, _, dpos, dori = pair_keypoints(
        f0, sift.detect_and_compute(torch.as_tensor(frames[0]), **kw))
    graph_res = sift_graph(cfg, cam, img0, img1, kw)
    eager = graph_res["full"]["eager"]
    sift_res = dict(
        shape=list(IMAGE_SHAPE), max_features=kw["max_features"],
        host_ms=eager["host_ms"], device_ms=eager["device_ms"],
        launches=eager["device_events"],
        valid=[int(f0.valid.sum()), int(f1.valid.sum())],
        ratio_matches=int(ok.sum()),
        cpu_pairs=int(paired.sum()), cpu_pos_max=float(dpos[paired].max()),
        orientation_flip_share=float((dori[paired] > FLIP_RAD)
                                     .float().mean()))
    print("sift " + json.dumps(sift_res), flush=True)

    vo = VisualOdometry(cam, cfg, DEVICE, seed=0)
    res = run_path(scene, frames, vo, NUM_FRAMES)
    print("sift_path " + json.dumps(res), flush=True)
    res.update(sift=sift_res, sift_graph=graph_res)
    if res["launches"]["klt_lk"] != res["launches_expected"]:
        raise RuntimeError(f"klt_lk launched {res['launches']['klt_lk']} "
                           f"times, expected {res['launches_expected']}")
    if not healthy(res):
        raise RuntimeError(f"SIFT bootstrap path unhealthy: {res}")
    return res


def sift_graph(cfg, cam, img0, img1, kw):
    """Phase A's SIFT replayed (``VisualOdometry.sift_features``) against
    op by op (``sift.detect_and_compute``): the full-resolution call of the
    bootstrap (``max_candidates`` rows), a keyframe of the bank
    (``LOOP_FEATURES`` rows, read back to the host as ``KeyframeBank``
    does), and the SIFT bootstrap (``bootstrap`` against
    ``bootstrap_eager``): each bit for bit equal, host ms, dispatches,
    device events and device ms.  Two eager calls on one image must be
    bit-equal too (the histogram and descriptor sums in a fixed order)."""
    from monocular_visual_odometry_va4mr_torch.ops import sift
    from monocular_visual_odometry_va4mr_torch.pipeline import runner
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    vo = VisualOdometry(cam, cfg, DEVICE, seed=0)
    M, F = kw["max_features"], LOOP_FEATURES

    def full():
        return vo.sift_features(img0, M)

    def full_eager():
        return sift.detect_and_compute(img0, **kw)

    def keyframe():
        return vo.sift_features(img0, F, host=True)

    def keyframe_eager():
        return [t.cpu() for t in sift.detect_and_compute(
            img0, **dict(kw, max_features=F))]

    def boot(fn):
        return fn(img0, img1,
                  generator=runner.frame_generator(0, 0, vo.device))

    res = dict(
        eager_twice_equal=bit_equal(full_eager(), full_eager()),
        full=dict(bit_equal=bit_equal(full(), full_eager()),
                  **replayed_and_eager(full, full_eager)),
        keyframe=dict(bit_equal=bit_equal(keyframe(), keyframe_eager()),
                      **replayed_and_eager(keyframe, keyframe_eager)),
        bootstrap=dict(bit_equal=bit_equal(
            boot(vo.bootstrap).tensors(), boot(vo.bootstrap_eager).tensors()),
            **replayed_and_eager(lambda: boot(vo.bootstrap),
                                 lambda: boot(vo.bootstrap_eager))),
        graphs=graph_keys(vo.fn_graphs))
    print("sift_graph " + json.dumps(res), flush=True)
    if not (res["eager_twice_equal"] and res["full"]["bit_equal"]
            and res["keyframe"]["bit_equal"]
            and res["bootstrap"]["bit_equal"]):
        raise RuntimeError(f"replayed SIFT differs from op by op, or SIFT "
                           f"from itself: {res}")
    return res


class Timed:
    """Replaces ``module.name`` with a wrapper that records each call's
    arguments, result and wall time (after a device sync) until
    ``restore``; with ``peak``, also the device memory the call took at
    its peak beyond what was allocated before it (MB; not for a call that
    another such wrapper holds inside it)."""

    def __init__(self, module, name, peak=False):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.calls, self.results, self.seconds = [], [], []
        self.peak, self.peak_mb = peak, []
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        import torch

        torch.cuda.synchronize()
        if self.peak:
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = self.inner(*args, **kw)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        if self.peak:
            self.peak_mb.append(
                (torch.cuda.max_memory_allocated() - before) / 2 ** 20)
        self.calls.append((args, kw))
        self.results.append(out)
        return out

    def restore(self):
        setattr(self.module, self.name, self.inner)


def drifted_copies(records, bank, drift):
    """``tests/test_posegraph_pipeline.py``'s scale-drift injection: each
    record's motion from the previous one scaled by drift^n, the keyframes'
    poses and map depths drifted with the records they sit on."""
    import copy

    out = copy.deepcopy(records)
    prev = records[0].T_WC
    scales = [1.0]
    for n in range(1, len(records)):
        rel = np.linalg.inv(prev) @ records[n].T_WC
        prev = records[n].T_WC
        scales.append(scales[-1] * drift)
        rel[:3, 3] *= scales[-1]
        out[n].T_WC = out[n - 1].T_WC @ rel
    dbank = copy.copy(bank)
    dbank.keyframes = []
    for k in bank.keyframes:
        T_WC = out[k.record_idx].T_WC
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = T_WC[:3, :3].T
        T[:3, 3] = -T_WC[:3, :3].T @ T_WC[:3, 3]
        s = scales[k.record_idx]
        dbank.keyframes.append(dataclasses.replace(
            k, T_CW=T, lm_z=k.lm_z * s, med_depth=k.med_depth * s))
    return out, dbank


def loop_vo(scene):
    """Phase B's VO (``tools/diag_loop_repeat.loop_vo``):
    ``kitti_tuned_config()`` with the KLT bootstrap and in-step BA off
    (``tools/bench_stream_2761.py``'s stream at this length)."""
    from monocular_visual_odometry_va4mr_torch.tools import diag_loop_repeat

    return diag_loop_repeat.loop_vo(scene, DEVICE)


def phase_loop(ctx):
    """Phase B: the loop stream, its keyframe bank and the Sim(3) pose
    graph, then the injected scale drift.  Leaves its scene, frames, VO and
    stream in ``ctx["loop"]`` for phases C and E."""
    import torch

    from monocular_visual_odometry_va4mr_torch.backend import (
        posegraph, posegraph_sim3)
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from monocular_visual_odometry_va4mr_torch.pipeline import (
        posegraph_runner as pr, runner, scan_driver)
    from monocular_visual_odometry_va4mr_torch.tools import diag_loop_repeat

    t0 = time.perf_counter()
    scene = synthetic.make_loop_scene(seed=SEED, num_frames=LOOP_FRAMES,
                                      laps=LOOP_LAPS, image_shape=IMAGE_SHAPE)
    frames = render_frames(scene, LOOP_FRAMES)
    render_s = time.perf_counter() - t0
    u8 = [np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in frames]
    vo = loop_vo(scene)
    b = LOOP_STRIDE
    ids = list(range(b + 1, LOOP_FRAMES))

    def stream(fr, store=None):
        s0 = vo.bootstrap(fr[0], fr[b], intermediate=fr[1:b],
                          generator=runner.frame_generator(0, 0, vo.device))
        src = ((i, fr[i]) for i in ids)
        if store is not None:
            src = pr.keep_every(src, LOOP_EVERY, store)
        return s0, scan_driver.run_streaming(
            vo, s0, src, 0, block=LOOP_BLOCK, emit_landmarks=True,
            recover=True, bootstrap_stride=b)

    boots, steps = CountingBootstrap(vo), CountingStep(vo)
    kf_images = {}
    torch.cuda.synchronize()
    k2.klt_lk.launches = 0
    t0 = time.perf_counter()
    state0, (_, outs, fids, info) = stream(u8, kf_images)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = k2.klt_lk.launches
    expected = 3 * steps.calls + 3 * boots.hops
    res = trajectory_health(scene, fids, positions_of(outs.T_CW),
                            list(outs.status))
    res.update(render_s=render_s, stream_s=stream_s,
               fps=len(fids) / stream_s, steps_run=steps.calls,
               bootstrap_calls=len(boots.calls), recoveries=info.recoveries,
               launches=launches, launches_expected=expected)
    print("loop_stream " + json.dumps(res), flush=True)
    if fids != ids or launches != expected:
        raise RuntimeError(f"loop stream ran other frames or launches: {res}")
    if not (res["finite"] and res["lost"] <= LOOP_LOST_FRAC * len(fids)):
        raise RuntimeError(f"loop stream unhealthy: {res}")
    ctx["loop"] = dict(scene=scene, frames=frames, u8=u8, vo=vo, outs=outs,
                       fids=fids, fps=res["fps"])

    t0 = time.perf_counter()
    bank = pr.bank_from_stream(vo, outs, fids, kf_images, every=LOOP_EVERY,
                               max_features=LOOP_FEATURES)
    bank_s = time.perf_counter() - t0
    kfs = bank.keyframes
    cands = pr.retrieve_candidates(bank)
    loops_t = Timed(pr, "detect_loops")
    verify_t = Timed(pr, "verify_pairs")
    chunk_t = Timed(pr, "verify_chunk_replayed")  # a replay a chunk
    solve_t = Timed(posegraph_sim3, "optimize")
    prune_t = Timed(posegraph_sim3, "optimize_consistent", peak=True)
    try:
        _, record, refine_s = diag_loop_repeat.loop_closure(
            vo, outs, fids, kf_images, bank=bank)
    finally:
        for t in (loops_t, verify_t, chunk_t, solve_t, prune_t):
            t.restore()
    ctx["loop"].update(images=kf_images, record=record)
    refined = record["refined"]
    loops = loops_t.results[0]
    far = [(kfs[a].frame, kfs[b_].frame) for a, b_, *_ in loops
           if kfs[b_].frame - kfs[a].frame >= LOOP_MIN_GAP]
    gt = scene.poses_WC[fids, :3, 3]
    from monocular_visual_odometry_va4mr_torch.evalx import ate

    ok_ref = refined is not None and bool(np.all(np.isfinite(refined)))
    n_solves = len(solve_t.seconds)
    nodes = len(kfs)
    pg = dict(
        keyframes=nodes, bank_s=bank_s,
        sift_ms_per_keyframe=1e3 * bank_s / max(len(kfs), 1),
        candidates=len(cands), verified=len(loops),
        verified_far=len(far), far_pairs=far[:8],
        dropped=[int(d) for d in prune_t.results[0][2]]
        if prune_t.results else None,
        verify_s=loops_t.seconds[0],
        verify_pairs_s=verify_t.seconds[0],
        verify_chunks=-(-len(cands) // pr.VERIFY_CHUNK),
        verify_batched_calls=len(chunk_t.seconds),
        verify_ms_per_chunk=1e3 * verify_t.seconds[0] / max(
            1, -(-len(cands) // pr.VERIFY_CHUNK)),
        verify_replay_ms_median=1e3 * statistics.median(chunk_t.seconds)
        if chunk_t.seconds else None,
        solves=n_solves, solve_s=sum(solve_t.seconds),
        gn_ms_per_iteration=1e3 * sum(solve_t.seconds) / max(
            1, sum(len(costs) for _, costs in solve_t.results)),
        refine_s=refine_s, split=record["split"], ate_raw=res["ate"],
        ate_refined=float(ate.ate_rmse(refined, gt)) if ok_ref else None)
    print("loop_posegraph " + json.dumps(pg), flush=True)
    if not (len(kfs) >= LOOP_MIN_KEYFRAMES and len(far) >= LOOP_MIN_EDGES
            and ok_ref):
        raise RuntimeError(f"loop pose graph failed its gates: {pg}")
    if pg["verify_batched_calls"] != pg["verify_chunks"]:
        raise RuntimeError(f"the verifier made other than one batched call "
                           f"a chunk: {pg}")

    records = [runner.FrameRecord(f, pose_WC(T), 0, 0, 0, 0.0)
               for f, T in zip(fids, outs.T_CW)]
    d_records, d_bank = drifted_copies(records, bank, SCALE_DRIFT)
    est_d = np.stack([r.T_WC[:3, 3] for r in d_records])
    drift = dict(per_frame=SCALE_DRIFT,
                 total=SCALE_DRIFT ** (len(records) - 1),
                 ate_drifted=float(ate.ate_rmse(est_d, gt)))
    drift_t = dict(sim3=Timed(posegraph_sim3, "optimize_consistent"),
                   se3=Timed(posegraph, "optimize"))
    try:
        for method in ("sim3", "se3"):
            r = pr.refine_trajectory(d_records, d_bank, method=method)
            drift[f"ate_{method}"] = (float(ate.ate_rmse(r, gt))
                                      if r is not None else None)
    finally:
        for t in drift_t.values():
            t.restore()
    print("loop_drift " + json.dumps(drift), flush=True)
    if not (drift["ate_sim3"] is not None and drift["ate_sim3"]
            < DRIFT_GAIN * drift["ate_drifted"]):
        raise RuntimeError(f"Sim(3) did not cut the injected drift: {drift}")
    gg = posegraph_graph(prune_t, solve_t, record["split"], drift_t)

    _, (_, outs_f, fids_f, info_f) = stream(frames)
    fl = trajectory_health(scene, fids_f, positions_of(outs_f.T_CW),
                           list(outs_f.status))
    fl["recoveries"] = info_f.recoveries
    print("loop_stream_float32 " + json.dumps(fl), flush=True)
    res.update(posegraph=pg, drift=drift, float32=fl, posegraph_graph=gg)
    return res


def rerun_eager(timed, k=0):
    """Call ``k`` of a ``Timed`` wrapper once more, op by op
    (``core.graphs.eager()``, no trace): (result, seconds)."""
    import torch

    from monocular_visual_odometry_va4mr_torch.core import graphs

    args, kw = timed.calls[k]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with graphs.eager():
        out = timed.inner(*args, **dict(kw, **(
            {"trace": None} if "trace" in kw else {})))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def solve_bits(out):
    """The tensors of a pose-graph solve's result: the refined nodes and
    the costs (and ``optimize_consistent``'s dropped edges)."""
    import torch

    return [out[0][0], out[1]] + (
        [torch.from_numpy(out[2])] if len(out) > 2 else [])


def posegraph_graph(prune_t, solve_t, split, drift_t):
    """Phase B's pose-graph solves replayed (one graph of the GN iteration
    a key, replayed once an iteration, ``core.graphs.scan``) against the
    same solves op by op (``graphs.eager()``), each run once more:
    ``optimize_consistent`` on phase B's graph (the first, leave-one-out
    and final Sim(3) solves: nodes, costs and dropped edges bit for bit,
    and its wall time replayed, capture included, below op by op), and the
    drift-injection graphs' Sim(3) refinement and SE(3) solve, bit for
    bit.  On phase B's first solve: the host ms of a replayed solve
    (``REPLAY_REPS`` synced calls) and of an iteration both ways, the
    device ms of a replayed solve behind a spin, and the dispatches,
    device events and device ms of one solve replayed and of one
    iteration both ways (``torch.profiler``, one call each); the capture
    seconds, the replays and the peak device memory of the refinement.
    Prints the ``posegraph_graph`` line; every check raises."""
    import torch

    from monocular_visual_odometry_va4mr_torch.backend import posegraph_sim3

    out, replayed_s = prune_t.results[0], prune_t.seconds[0]
    want, eager_s = rerun_eager(prune_t)
    (graph,), kw = solve_t.calls[0]
    iters = kw["iters"]
    iterations = len(solve_t.calls) * iters

    def solve(n=iters):
        return posegraph_sim3.optimize(graph, **dict(kw, iters=n))

    def eager(n=iters):
        from monocular_visual_odometry_va4mr_torch.core import graphs

        with graphs.eager():
            return solve(n)

    one_dev, one_events, one_disp = profile_calls(lambda: solve(1), reps=1)
    one_dev_e, one_events_e, one_disp_e = profile_calls(lambda: eager(1),
                                                        reps=1)
    t0 = time.perf_counter()
    solve_dev, solve_events, solve_disp = profile_calls(solve, reps=1)
    profile_s = time.perf_counter() - t0
    solve_host = host_ms(solve, DEVICE, reps=REPLAY_REPS, warmup=0)
    res = dict(
        phase_b=dict(
            nodes=int(graph.S_CW.shape[0]), edges=int(graph.weight.shape[0]),
            iters=iters, solves=len(solve_t.calls), iterations=iterations,
            suspects=split.get("suspects"),
            dropped=int(out[2].sum()),
            bit_equal=bit_equal(solve_bits(out), solve_bits(want)),
            replayed_s=replayed_s, eager_s=eager_s,
            capture_s=split.get("capture_s"), captures=split.get("captures"),
            replays=split.get("replays"), peak_mb=prune_t.peak_mb[0]),
        iteration=dict(
            replayed=dict(host_ms=solve_host / iters, dispatches=one_disp,
                          device_events=one_events, device_ms=one_dev),
            eager=dict(host_ms=1e3 * eager_s / iterations,
                       dispatches=one_disp_e, device_events=one_events_e,
                       device_ms=one_dev_e)),
        solve=dict(host_ms=solve_host,
                   device_ms=device_time_ms(solve, reps=2),
                   profiled=dict(dispatches=solve_disp,
                                 device_events=solve_events,
                                 device_ms=solve_dev, seconds=profile_s)),
        drift={})
    for method, timed in drift_t.items():
        res["drift"][method] = d = dict(calls=len(timed.calls))
        if timed.calls:
            d_want, d_eager_s = rerun_eager(timed)
            d.update(bit_equal=bit_equal(solve_bits(timed.results[0]),
                                         solve_bits(d_want)),
                     replayed_s=timed.seconds[0], eager_s=d_eager_s)
    print("posegraph_graph " + json.dumps(res), flush=True)
    if not (res["phase_b"]["bit_equal"] and all(
            d["calls"] == 1 and d["bit_equal"]
            for d in res["drift"].values())):
        raise RuntimeError(f"a replayed pose-graph solve differs from op by "
                           f"op, or a drift refinement made no solve: {res}")
    if not res["phase_b"]["replayed_s"] < res["phase_b"]["eager_s"]:
        raise RuntimeError(f"phase B's replayed Sim(3) solves, capture "
                           f"included, took longer than op by op: {res}")
    return res


def phase_b_repeat(ctx):
    """Phase B's loop closure once more on its stream, in the same process
    (``tools/diag_loop_repeat.loop_closure``: a bank of its own, the
    verifier, the edges, the Sim(3) refinement): equal to phase B's run at
    every stage, else the first stage where they differ.  Then the
    verifier's first chunk replayed (``verify_chunk_replayed``) against op
    by op (``verify_chunk``) on the same draws: bit for bit equal; host ms,
    dispatches, device events and device ms of each."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import ransac
    from monocular_visual_odometry_va4mr_torch.pipeline import (
        posegraph_runner as pr)
    from monocular_visual_odometry_va4mr_torch.tools import diag_loop_repeat

    lp = ctx["loop"]
    vo = lp["vo"]
    bank, again, seconds = diag_loop_repeat.loop_closure(
        vo, lp["outs"], lp["fids"], lp["images"])
    first = diag_loop_repeat.first_difference(lp["record"], again)
    res = dict(equal=first is None, first_difference=first,
               phase_b=diag_loop_repeat.summary(lp["record"]),
               again=diag_loop_repeat.summary(again), seconds=seconds)

    chunk = pr.retrieve_candidates(bank)[:pr.VERIFY_CHUNK]
    inputs = pr.chunk_inputs(bank.keyframes, chunk, vo.device)
    gen = torch.Generator(device=vo.device).manual_seed(0)
    draws = torch.stack([ransac.draw_uniforms(gen, 300, 5) for _ in chunk])

    def replayed():
        return pr.verify_chunk_replayed(vo, vo.cam, inputs, draws,
                                        threshold_px=1.5)

    def eager():
        return [t.cpu() for t in pr.verify_chunk(
            vo.cam, *inputs, draws, ratio=vo.config.sift.ratio,
            threshold_px=1.5, select=ransac.select_minimal_sets)]

    res["verify_chunk"] = dict(pairs=len(chunk),
                               bit_equal=bit_equal(replayed(), eager()),
                               **replayed_and_eager(replayed, eager))
    res["graphs"] = graph_keys(vo.fn_graphs)
    print("phase_b_repeat " + json.dumps(res), flush=True)
    if first is not None:
        raise RuntimeError(f"phase B's loop closure did not repeat: {res}")
    if len(chunk) != pr.VERIFY_CHUNK or not res["verify_chunk"]["bit_equal"]:
        raise RuntimeError(f"the replayed verifier chunk differs from the "
                           f"eager one: {res}")
    return res


def write_kitti(root, u8, poses_WC):
    """``dataio.native_io.write_kitti``: ``u8`` frames and their poses in
    the KITTI layout (``stress_diag.py --write-kitti`` calls it here)."""
    from monocular_visual_odometry_va4mr_torch.dataio import native_io

    native_io.write_kitti(root, u8, poses_WC)


def phase_disk(ctx):
    """Phase C: phase B's frames from PNG files through the native decoder,
    the block driver and the CLI."""
    import torch

    from monocular_visual_odometry_va4mr_torch import _build
    from monocular_visual_odometry_va4mr_torch.core.camera import Camera
    from monocular_visual_odometry_va4mr_torch.core.config import (
        tune_for_tpu)
    from monocular_visual_odometry_va4mr_torch.dataio import (datasets,
                                                              native_io)
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from monocular_visual_odometry_va4mr_torch.pipeline import (
        checkpoint, runner)
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)
    from monocular_visual_odometry_va4mr_torch.tools import (
        bench_stream_2761)

    loop = ctx["loop"]
    scene, u8, vo = loop["scene"], loop["u8"], loop["vo"]
    root = tempfile.mkdtemp(prefix="kitti-", dir=os.path.join(REPO, "build"))
    try:
        t0 = time.perf_counter()
        lib, _, build_s = _build.build_host("mvo_io")
        t1 = time.perf_counter()
        write_kitti(root, u8, scene.poses_WC)
        write_s = time.perf_counter() - t1
        spec = datasets.load_kitti(root)
        if spec.num_frames != len(u8):
            raise RuntimeError(f"load_kitti found {spec.num_frames} frames")

        # (a, b) decode alone, then every frame against its source.
        t1 = time.perf_counter()
        with native_io.PrefetchingReader(spec.frame_paths) as reader:
            n = sum(1 for _ in reader)
        decode_s = time.perf_counter() - t1
        bad = [i for i, img in spec.frames()
               if img.dtype != np.float32 or not np.array_equal(img, u8[i])]
        dec = dict(build_s=build_s,
                   library=os.path.relpath(lib, REPO), frames=n,
                   shape=list(u8[0].shape), png_mb=sum(
                       os.path.getsize(p) for p in spec.frame_paths) / 2**20,
                   write_s=write_s, decode_s=decode_s, decode_fps=n / decode_s,
                   stream_fps=loop["fps"], target_fps=DECODE_TARGET_FPS,
                   mismatched=bad[:8])
        print("disk_decode " + json.dumps(dec), flush=True)
        if n != len(u8) or bad:
            raise RuntimeError(f"decoded frames differ from the source: {dec}")
        if dec["decode_fps"] < loop["fps"]:
            raise RuntimeError(f"the decoder is slower than the stream: {dec}")

        # (c) the block driver over the files, as phase B streamed memory,
        # through the stream tool's function, with block checkpoints.
        ck_dir = os.path.join(root, "checkpoints")
        t1 = time.perf_counter()
        run = bench_stream_2761.stream_sequence(
            vo, spec, bootstrap=LOOP_STRIDE, block=LOOP_BLOCK,
            checkpoint_dir=ck_dir, checkpoint_every_blocks=DISK_CK_EVERY)
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t1
        outs, fids, info = run["outs"], run["ids"], run["info"]
        stream = trajectory_health(scene, fids, positions_of(outs.T_CW),
                                   list(outs.status))
        same_ids = fids == loop["fids"]
        bit_equal = same_ids and bool(
            np.array_equal(outs.T_CW, loop["outs"].T_CW))
        diff = (float(np.abs(positions_of(outs.T_CW)
                             - positions_of(loop["outs"].T_CW)).max())
                if same_ids else None)
        ck_frame = checkpoint.saved_frame(ck_dir)
        stream.update(stream_s=stream_s, fps=run["fps"],
                      bootstrap_status=run["bootstrap_status"],
                      memory_fps=loop["fps"], recoveries=info.recoveries,
                      blocks=info.blocks, launches=run["klt_lk_launches"],
                      launches_expected=run["klt_lk_launches_expected"],
                      checkpoint_every_blocks=DISK_CK_EVERY,
                      checkpoints_written=info.blocks // DISK_CK_EVERY,
                      checkpoint_frame=ck_frame,
                      checkpoint_files=sorted(os.listdir(ck_dir))
                      if os.path.isdir(ck_dir) else [],
                      pos_diff_vs_memory=diff,
                      T_CW_bit_equal_to_memory=bit_equal,
                      statuses_equal=same_ids and list(outs.status)
                      == list(loop["outs"].status))
        print("disk_stream " + json.dumps(stream), flush=True)
        if not same_ids:
            raise RuntimeError(f"disk stream ran other frames: {stream}")
        if ck_frame is None or info.blocks < DISK_CK_EVERY:
            raise RuntimeError(f"no block checkpoint was written: {stream}")
        if not bit_equal:
            raise RuntimeError(f"disk stream differs from phase B: {stream}")

        # (d) the CLI on the files, then the same run in this process.
        metrics = os.path.join(root, "cli.jsonl")
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"{PKG}.run", "--dataset", "kitti",
             "--data-root", root, "--tuned", "--device", DEVICE, "--quiet",
             "--metrics-json", metrics], cwd=REPO, capture_output=True,
            text=True, timeout=900)
        cli_s = time.perf_counter() - t1
        tail = proc.stdout.strip().splitlines()[-6:]
        print(f"cli kitti rc={proc.returncode} {cli_s:.1f} s | "
              + " | ".join(tail), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"CLI kitti run failed:\n{proc.stdout}\n"
                               f"{proc.stderr[-4000:]}")
        with open(metrics) as f:
            rows = [json.loads(line) for line in f]
        vo_k = VisualOdometry(Camera.from_matrix(spec.K),
                              tune_for_tpu(spec.config), DEVICE, seed=0)
        boots, steps = CountingBootstrap(vo_k), CountingStep(vo_k)
        k2.klt_lk.launches = 0
        t1 = time.perf_counter()
        result = runner.run_sequence(
            vo_k, spec.frames(), seed=0,
            bootstrap_stride=spec.bootstrap_frames[1]
            - spec.bootstrap_frames[0])
        run_s = time.perf_counter() - t1
        recs = result.records
        cli = trajectory_health(scene, [r["frame"] for r in rows],
                                np.array([r["position"] for r in rows]),
                                [r["status"] for r in rows])
        same_frames = [r["frame"] for r in rows] == [r.frame for r in recs]
        cli_diff = (float(np.abs(np.array([r["position"] for r in rows])
                                 - result.positions).max())
                    if same_frames else None)
        step_ms = [r.wall_ms for r in recs[1:]]
        cli.update(bootstrap=vo_k.config.bootstrap_method, cli_s=cli_s,
                   in_process_s=run_s,
                   step_ms_median=statistics.median(step_ms),
                   recoveries=boots.recoveries, launches=k2.klt_lk.launches,
                   launches_expected=3 * (steps.calls + boots.hops),
                   pos_diff_vs_in_process=cli_diff,
                   tol=STREAM_POS_TOL * cli["path"],
                   lost_limit=LOOP_CLI_LOST_FRAC * len(rows))
        print("disk_cli " + json.dumps(cli), flush=True)
        if not (cli["finite"] and cli["lost"] <= cli["lost_limit"]):
            raise RuntimeError(f"CLI kitti run unhealthy: {cli}")
        if cli["launches"] != cli["launches_expected"]:
            raise RuntimeError(f"klt_lk launches off on the CLI path: {cli}")
        if not (same_frames and cli_diff <= cli["tol"]):
            raise RuntimeError(f"CLI differs from run_sequence: {cli}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(decode=dec, stream=stream, cli=cli,
                wall_s=time.perf_counter() - t0)


def stress_vo(scene, device=None, sampler=None):
    """``tests/test_tpu_e2e.py``'s VO: ``parking_config()`` with the KLT
    bootstrap and ``quality_level=0.02``, on ``pallas2`` (the plain LK on
    the CPU), on ``device`` (``DEVICE`` by default)."""
    from monocular_visual_odometry_va4mr_torch.core.camera import Camera
    from monocular_visual_odometry_va4mr_torch.core.config import (
        parking_config)
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    cfg = parking_config().replace(image_shape=scene.image_shape,
                                   bootstrap_method="klt")
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, quality_level=0.02),
        klt=dataclasses.replace(cfg.klt, backend="pallas2"))
    return VisualOdometry(Camera.from_matrix(scene.K), cfg, device or DEVICE,
                          sampler=sampler, seed=0)


class CpuDraws:
    """A sampler for ``VisualOdometry(sampler=...)`` that draws each RANSAC
    bank from a CPU generator seeded with the call's generator's seed, one
    CPU generator per call's generator, so a run on the card draws exactly
    as the same run on the CPU does.  ``draw`` gives the uniforms (the
    captured step takes them as its draws), the call maps them onto the
    valid rows (``ransac.select_minimal_sets``)."""

    def __init__(self):
        self._gens = {}

    def draw(self, generator, num_hypotheses, sample_size):
        import torch
        from monocular_visual_odometry_va4mr_torch.ops import ransac

        key = id(generator)
        if key not in self._gens:  # keeps ``generator`` alive: ids stay unique
            self._gens[key] = (generator, torch.Generator().manual_seed(
                generator.initial_seed()))
        return ransac.draw_uniforms(self._gens[key][1], num_hypotheses,
                                    sample_size)

    def __call__(self, generator, valid, num_hypotheses, sample_size):
        from monocular_visual_odometry_va4mr_torch.ops import ransac

        u = self.draw(generator, num_hypotheses, sample_size)
        return ransac.select_minimal_sets(u.to(valid.device), valid)


def step_loop(vo, frames, seed, b, keep_states=False):
    """``runner.run_sequence``'s bootstrap and steps with its generators, no
    recovery: (frame ids, positions, statuses, inliers, tracked, the state
    before each step as arrays if ``keep_states``)."""
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    dev = vo.device
    state = vo.bootstrap(frames[0], frames[b], intermediate=frames[1:b],
                         generator=runner.frame_generator(seed, 0, dev))
    ids, pos, stat, inl, trk, states = [b], [], [], [], [], []

    def record(st):
        pos.append(runner._T_WC(st.T_CW.cpu().numpy())[:3, 3])
        stat.append(int(st.status))
        inl.append(int(st.n_inliers))
        trk.append(int(st.n_tracked))

    record(state)
    for f in range(b + 1, len(frames)):
        if keep_states:
            states.append(state.to_numpy())
        state = vo.step(state, frames[f],
                        generator=runner.frame_generator(seed, f, dev))
        ids.append(f)
        record(state)
    return ids, np.stack(pos), stat, inl, trk, states


def replay(vo, frames, seed, cpu_run):
    """Each step of ``cpu_run`` (a ``step_loop`` with its states) again on
    ``vo`` from the CPU's own state, image and generator: one step's
    difference each, not what came before.  The position difference (m) and
    the steps whose inlier / tracked counts or status changed."""
    from monocular_visual_odometry_va4mr_torch.core.state import FrameState
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    ids, pos, stat, inl, trk, states = cpu_run
    out = []
    for k, st in enumerate(states):
        f = ids[k + 1]
        nxt = vo.step(FrameState.from_numpy(st, vo.device), frames[f],
                      generator=runner.frame_generator(seed, f, vo.device))
        p = runner._T_WC(nxt.T_CW.cpu().numpy())[:3, 3]
        out.append((f, float(np.linalg.norm(p - pos[k + 1])),
                    int(nxt.n_inliers) - inl[k + 1],
                    int(nxt.n_tracked) - trk[k + 1],
                    int(nxt.status) != stat[k + 1]))
    worst = max(out, key=lambda r: r[1])
    by_count = sorted(out, key=lambda r: -abs(r[2]) - abs(r[3]))[:5]
    return dict(steps=len(out), max_step_m=worst[1], at_frame=worst[0],
                median_step_m=float(np.median([r[1] for r in out])),
                steps_inliers_differ=sum(1 for r in out if r[2]),
                max_inlier_change=max(abs(r[2]) for r in out),
                steps_tracked_differ=sum(1 for r in out if r[3]),
                max_tracked_change=max(abs(r[3]) for r in out),
                steps_status_differ=sum(1 for r in out if r[4]),
                most_changed=[r[:4] for r in by_count if r[2] or r[3]])


def stress_run(scene, frames, seed, sampler=None):
    """One stress run through ``runner.run_sequence`` on the card: its
    health, recoveries, step time and ``klt_lk`` launches."""
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    vo = stress_vo(scene, sampler=sampler)
    boots, steps = CountingBootstrap(vo), CountingStep(vo)
    k2.klt_lk.launches = 0
    t0 = time.perf_counter()
    result = runner.run_sequence(vo, enumerate(frames), seed=seed,
                                 bootstrap_stride=STRESS_STRIDE)
    run_s = time.perf_counter() - t0
    recs = result.records
    res = trajectory_health(scene, [r.frame for r in recs], result.positions,
                            [r.status for r in recs])
    res.update(seed=seed, run_s=run_s, recoveries=boots.recoveries,
               step_ms_median=statistics.median([r.wall_ms
                                                 for r in recs[1:]]),
               launches=k2.klt_lk.launches,
               launches_expected=3 * (steps.calls + boots.hops))
    return res


def phase_stress():
    """Phase D: the three realism-stress scenarios, each run on the CPU's
    draws with the runner's seeds ``STRESS_SEEDS`` (gated run by run) and
    once on the card's own generator; the hard-realism run of seed 0
    replayed step by step against the CPU."""
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic

    out = {}
    for name, scene_kw, tag, aug_kw, max_lost, max_ate in STRESS:
        t0 = time.perf_counter()
        scene = synthetic.make_textured_scene(
            seed=7, num_frames=STRESS_FRAMES, image_shape=STRESS_SHAPE,
            step=1.0, **scene_kw)
        frames = synthetic.render_all_cached(
            scene, "e2e-s7-f{}-{}x{}{}".format(STRESS_FRAMES, *STRESS_SHAPE,
                                              tag),
            render=lambda sc: render_frames(sc, sc.num_frames))
        if aug_kw:
            frames = synthetic.augment_frames(frames, seed=3, **aug_kw)
        render_s = time.perf_counter() - t0
        runs = [stress_run(scene, frames, seed, CpuDraws())
                for seed in STRESS_SEEDS]
        own = stress_run(scene, frames, 0)
        res = dict(frames=runs[0]["frames"], path=runs[0]["path"],
                   render_s=render_s, max_lost=max_lost, max_ate=max_ate,
                   seeds=list(STRESS_SEEDS), ates=[r["ate"] for r in runs],
                   lost=[r["lost"] for r in runs],
                   finite=all(r["finite"] for r in runs),
                   recoveries=[r["recoveries"] for r in runs],
                   step_ms_median=statistics.median(
                       r["step_ms_median"] for r in runs),
                   launches=[r["launches"] for r in runs + [own]],
                   launches_expected=[r["launches_expected"]
                                      for r in runs + [own]],
                   card_generator={k: own[k] for k in (
                       "seed", "ate", "lost", "finite", "recoveries")})
        if name == REPLAY_SCENARIO:
            t1 = time.perf_counter()
            cpu = step_loop(stress_vo(scene, "cpu", CpuDraws()), frames, 0,
                            STRESS_STRIDE, keep_states=True)
            res["replay"] = replay(stress_vo(scene, sampler=CpuDraws()),
                                   frames, 0, cpu)
            res["replay"].update(tol=REPLAY_MEDIAN_TOL,
                                 s=time.perf_counter() - t1)
        print(f"stress_{name} " + json.dumps(res), flush=True)
        if not (res["finite"] and max(res["lost"]) <= max_lost
                and max(res["ates"]) < max_ate and own["finite"]
                and own["lost"] <= max_lost):
            raise RuntimeError(f"stress {name} failed its gates: {res}")
        if res["launches"] != res["launches_expected"]:
            raise RuntimeError(f"klt_lk launches off in stress {name}: {res}")
        rep = res.get("replay")
        if rep and (rep["steps_inliers_differ"] or rep["steps_tracked_differ"]
                    or rep["steps_status_differ"]
                    or not rep["median_step_m"] <= REPLAY_MEDIAN_TOL):
            raise RuntimeError(f"a card step differs from the CPU's in "
                               f"stress {name}: {rep}")
        out[name] = res
    return out


def phase_parallel(ctx, scene, frames):
    """Phase E: lockstep sequences on one card, S = 2 then S = 11, on the
    batched step (``lockstep``), then the sharded BAs on a one-rank NCCL
    group."""
    import torch
    import torch.distributed as dist

    from monocular_visual_odometry_va4mr_torch.backend import ba
    from monocular_visual_odometry_va4mr_torch.core import graphs
    from monocular_visual_odometry_va4mr_torch.dataio import datasets
    from monocular_visual_odometry_va4mr_torch.parallel import (
        ba_sharded, multihost, traj_ba)

    loop = ctx["loop"]
    cfg, cam, vo = main_path_vo(loop["scene"])
    if cam != cam.from_matrix(datasets.KITTI_K):
        raise RuntimeError("the sequences are not at the KITTI-05 intrinsics")
    gap = (LOOP_FRAMES - MULTI_FRAMES) // (MULTI_SEQS - 1)
    # (scene, its first frame) of each sequence, for its ground truth.
    starts = {"s2": [(scene, 0), (loop["scene"], 0)],
              f"s{MULTI_SEQS}": [(loop["scene"], k * gap)
                                 for k in range(MULTI_SEQS)]}
    sources = {"s2": [frames, loop["frames"]],
               f"s{MULTI_SEQS}": [loop["frames"]] * MULTI_SEQS}
    res, ok = dict(frames=MULTI_FRAMES), True
    for name, truth in starts.items():
        seqs = [list(fr[a:a + MULTI_FRAMES])
                for fr, (_, a) in zip(sources[name], truth)]
        res[name] = lock = lockstep(vo, seqs, truth)
        ok &= lock["ok"]

    # One-rank NCCL group: the sharded BAs on the card.
    store = tempfile.mkdtemp(prefix="nccl-", dir=os.path.join(REPO, "build"))
    multihost.initialize(f"file://{store}/store", 1, 0)
    try:
        dev = torch.device(DEVICE)
        # NCCL makes its communicator at the group's first collective: timed
        # here, so that the first sharded BA's capture holds none of it.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multihost.all_reduce(torch.zeros(1, device=dev))
        torch.cuda.synchronize()
        communicator_s = time.perf_counter() - t0
        captured = graphs.captures(dev)[0]
        noisy, _, tcam = traj_ba.build_synthetic_traj(1, 6, 256, seed=0)
        noisy = traj_ba.TrajSegments(*(t.to(dev) for t in noisy))
        win = ba.BAWindow(torch.cat([noisy.anchor_T_CW, noisy.T_CW]),
                          noisy.lm_xyz, noisy.obs_uv[0], noisy.obs_mask[0])
        W = win.T_CW.shape[0]
        multihost.COMM.clear()
        out_s, _ = ba_sharded.run_ba_sharded(
            ba_sharded.shard_window(win, 0, 1), tcam, iters=PAR_BA_ITERS)
        comm_ba = dict(multihost.COMM)
        out_r, _ = ba.run_ba(win, tcam, iters=PAR_BA_ITERS)
        multihost.COMM.clear()
        seg, _ = traj_ba.run_traj_ba(traj_ba.shard_segments(noisy, 0, 1),
                                     tcam, iters=PAR_TRAJ_ITERS)
        comm_traj = dict(multihost.COMM)
        ref_traj, _ = ba.run_ba(win, tcam, iters=PAR_TRAJ_ITERS,
                                damping=1e-2, n_fixed=2)
        nccl = dict(
            backend=dist.get_backend(), world=dist.get_world_size(),
            communicator_s=communicator_s,
            ba_pos_diff=float((out_s.T_CW - out_r.T_CW).abs().max()),
            ba_lm_diff=float((out_s.lm_xyz - out_r.lm_xyz).abs().max()),
            ba_collectives=[[*k, n] for k, n in comm_ba.items()],
            ba_payload_expected=4 * (36 * W * W + 6 * W + 1),
            traj_pos_diff=float((seg.T_CW - ref_traj.T_CW[2:]).abs().max()),
            traj_collectives=[[*k, n] for k, n in comm_traj.items()])
        calls = (
            ("ba_sharded", lambda: ba_sharded.run_ba_sharded(
                ba_sharded.shard_window(win, 0, 1), tcam,
                iters=PAR_BA_ITERS), PAR_BA_ITERS, comm_ba),
            ("traj_ba", lambda: traj_ba.run_traj_ba(
                traj_ba.shard_segments(noisy, 0, 1), tcam,
                iters=PAR_TRAJ_ITERS), PAR_TRAJ_ITERS, comm_traj))
        sharded = sharded_graph(dev, calls, captured)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    res["nccl_one_rank"] = nccl
    res["sharded_graph"] = sharded
    print("parallel " + json.dumps(res), flush=True)
    if not ok:
        raise RuntimeError(f"lockstep failed its gates: {res}")
    if not (nccl["backend"] == "nccl"
            and nccl["ba_pos_diff"] <= PAR_BA_POS_TOL
            and nccl["ba_lm_diff"] <= PAR_BA_LM_TOL
            and nccl["traj_pos_diff"] <= PAR_TRAJ_TOL
            and comm_ba == {("all_reduce", nccl["ba_payload_expected"]):
                            PAR_BA_ITERS}
            and comm_traj == {("all_reduce", 4): PAR_TRAJ_ITERS}):
        raise RuntimeError(f"sharded BA on NCCL differs: {nccl}")
    return res


def sharded_graph(dev, calls, captured):
    """The sharded BAs replayed (one graph of the GN iteration a function,
    its all-reduce inside, replayed once an iteration, ``core.graphs.scan``)
    against the same calls op by op (``graphs.eager()``) on the one-rank
    NCCL group, after phase E's first call of each has captured its graph
    (``captured``: the shared cache's captures before it).  Each call once
    more both ways: outputs bit for bit, ``iters`` replays, and the
    collectives of the first call (``calls``' last item) counted by the
    replay and by op by op alike; one capture a function, its seconds; the
    host ms, host dispatches, device events and device ms of a call both
    ways (``replayed_and_eager``).  Prints the ``sharded_graph`` line
    under ``parallel``; every check raises."""
    import torch

    from monocular_visual_odometry_va4mr_torch.core import graphs
    from monocular_visual_odometry_va4mr_torch.parallel import multihost

    def flat(out):
        window, costs = out
        return [window.T_CW, window.lm_xyz, costs]

    def eager(fn):
        def run():
            with graphs.eager():
                return fn()
        return run

    capture_s = graphs.shared(dev).capture_s if dev.type == "cuda" else {}
    res = {}
    for name, fn, iters, comm in calls:
        replays = graphs.replays(dev)
        multihost.COMM.clear()
        out = flat(fn())
        got = dict(multihost.COMM)
        replayed = graphs.replays(dev) - replays
        multihost.COMM.clear()
        want = flat(eager(fn)())
        got_eager = dict(multihost.COMM)
        keys = [k for k in capture_s if k[0][0] == name]
        res[name] = dict(
            iters=iters, replays=replayed, captures=len(keys),
            capture_s=sum(capture_s[k] for k in keys),
            bit_equal=bit_equal(out, want),
            collectives=[[*k, n] for k, n in got.items()],
            collectives_eager=[[*k, n] for k, n in got_eager.items()],
            **replayed_and_eager(fn, eager(fn)))
        ok = (res[name]["bit_equal"] and replayed == iters and len(keys) == 1
              and got == got_eager == comm)
        res[name]["ok"] = ok
    res["captures"] = graphs.captures(dev)[0] - captured
    print("sharded_graph " + json.dumps(res), flush=True)
    if not (res["captures"] == len(calls)
            and all(res[name]["ok"] for name, *_ in calls)):
        raise RuntimeError(f"a replayed sharded BA differs from op by op, "
                           f"replays other than its iterations, captures "
                           f"other than once or counts other collectives: "
                           f"{res}")
    return res


def batch_of_one(vo, seq, s):
    """Sequence ``s`` of a lockstep run stepped alone on the batched step: a
    batch of one, bootstrapped and drawn as ``multi_seq.run_sequences_dp``
    bootstraps and draws it.  Returns (positions (F, 3), statuses) of its
    frames ``BOOTSTRAP_STRIDE + 1`` on."""
    from monocular_visual_odometry_va4mr_torch.core.state import stack_states
    from monocular_visual_odometry_va4mr_torch.parallel import multi_seq
    from monocular_visual_odometry_va4mr_torch.pipeline.runner import (
        _T_WC, frame_generator)

    sd, b = multi_seq.sequence_seed(0, s), BOOTSTRAP_STRIDE
    state = stack_states([vo.bootstrap(
        seq[0], seq[b], intermediate=seq[1:b],
        generator=frame_generator(sd, 0, vo.device))])
    pos, sts = [], []
    for f in range(b + 1, len(seq)):
        state = vo.step_batch(state, [seq[f]],
                              [frame_generator(sd, f, vo.device)])
        pos.append(_T_WC(state.T_CW[0].cpu().numpy())[:3, 3])
        sts.append(int(state.status[0]))
    return np.stack(pos), sts


def lockstep(vo, seqs, truth):
    """``multi_seq.run_sequences_dp`` over ``seqs`` on the batched step, the
    counts zeroed just before and read just after.  Each sequence against
    itself in a batch of one (``batch_of_one``: the same arithmetic and
    draws, so any difference comes from its batch-mates), and against its
    solo ``run_sequence`` (the libraries' arithmetic) on its ground truth
    (``truth``: per sequence, its scene and the scene's frame of its first
    frame): finite, its ATE at most the solo run's plus the health gate's
    2% of the path (LOST and the largest position difference printed).  A batched step's profile beside a batch
    of one's and a solo step's.  Returns its line, with ``ok`` the verdict
    of its gates."""
    import torch

    from monocular_visual_odometry_va4mr_torch.core.state import (
        stack_states, unstack_states)
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas2 as k2
    from monocular_visual_odometry_va4mr_torch.parallel import multi_seq
    from monocular_visual_odometry_va4mr_torch.pipeline import runner

    S = len(seqs)
    boots, batches = CountingBootstrap(vo), CountingBatch(vo)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k2.klt_lk.launches = 0
    t0 = time.perf_counter()
    lock = multi_seq.run_sequences_dp(vo, seqs,
                                      bootstrap_stride=BOOTSTRAP_STRIDE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = k2.klt_lk.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    steady = [ms for ms, c in zip(batches.ms, batches.captured) if not c]
    ms = statistics.median(steady)
    res = dict(
        sequences=S, lockstep_s=wall_s, batched_steps=batches.calls,
        launches=launches, bootstrap_hops=boots.hops,
        launches_expected=3 * (batches.calls + boots.hops),
        launches_in_bootstraps=boots.launches["klt_lk"],
        launches_per_batched_step=(launches - boots.launches["klt_lk"])
        / batches.calls,
        ms_per_batched_frame=ms, frames_per_s=1e3 * S / ms,
        peak_device_mb=peak_mb,
        capture_s={"/".join(str(k) for k in key): v
                   for key, v in (vo.graphs.capture_s.items() if vo.graphs
                                  else ()) if key[-1] == S})
    ok = launches == res["launches_expected"]
    states, images = batches.last
    vo.bootstrap, vo.step_batch = boots.inner, batches.inner
    b = BOOTSTRAP_STRIDE
    for s, seq in enumerate(seqs):
        one_pos, one_status = batch_of_one(vo, seq, s)
        solo = runner.run_sequence(vo, enumerate(seq),
                                   seed=multi_seq.sequence_seed(0, s),
                                   bootstrap_stride=b, recover=False)
        scene, first = truth[s]
        ids = range(first + b + 1, first + len(seq))
        gt = trajectory_health(scene, ids, lock.positions[s],
                               lock.status[s].tolist())
        solo_gt = trajectory_health(scene, ids, solo.positions[1:],
                                    [r.status for r in solo.records[1:]])
        path = float(np.sum(np.linalg.norm(np.diff(one_pos, axis=0),
                                           axis=1)))
        diff = float(np.abs(lock.positions[s] - one_pos).max())
        same = lock.status[s].tolist() == one_status
        res[f"seq{s}"] = dict(
            pos_diff=diff, tol=STREAM_POS_TOL * path, statuses_equal=same,
            lost=gt["lost"], ate=gt["ate"], ate_bound=gt["ate_bound"],
            finite=gt["finite"],
            solo=dict(ate=solo_gt["ate"], lost=solo_gt["lost"],
                      pos_diff=float(np.abs(lock.positions[s]
                                            - solo.positions[1:]).max())))
        ok &= (same and diff <= STREAM_POS_TOL * path and gt["finite"]
               and gt["ate"] <= solo_gt["ate"] + gt["ate_bound"])
    # One frame of every sequence, batched, beside the first sequence's
    # frame in a batch of one and alone: the same state and images, each on
    # its graph (skip or BA alike).
    one = unstack_states(states)[0]
    one_batch = stack_states([one])
    gens = [torch.Generator(device=vo.device).manual_seed(s)
            for s in range(S)]
    prof = {}
    for name, fn in (
            ("batched", lambda: vo.step_batch(states, images, gens)),
            ("one", lambda: vo.step_batch(one_batch, images[:1], gens[:1])),
            ("solo", lambda: vo.step(one, images[0], generator=gens[0]))):
        d_ms, events, disp = profile_calls(fn)
        prof[name] = dict(device_ms=d_ms, device_events=events,
                          dispatches=disp)
    for name in ("one", "solo"):
        prof[f"events_ratio_{name}"] = (prof["batched"]["device_events"]
                                        / prof[name]["device_events"])
    # Against the batch of one, the same arithmetic: what grows runs per
    # sequence.  The solo step's libraries take fewer kernels (printed).
    ok &= abs(prof["events_ratio_one"] - 1.0) <= EVENTS_TOL
    res["profile"] = prof
    res["ok"] = bool(ok)
    print(f"lockstep_s{S} " + json.dumps(res), flush=True)
    return res


def kernel_entry(name, cases, launches, per_step, per_hop, launches_by_path,
                 per_batched_step=None):
    """The kernel's line: its numbers at the main path's full resolution,
    and beside them each case's (every shape of every path) device time,
    host-inclusive call time and bound.  ``ms`` keeps the meaning it has had
    since the first kernel line, one call with the host's work included, and
    equals ``call_ms``; ``device_ms`` is the kernel on the card alone.
    ``launches``: the main path's run; ``launches_by_path``: every path's;
    ``per_step``, ``per_batched_step``: launches per step and per batched
    step (by run) in those runs, the launches inside the bootstrap calls
    (counted around each call) left out; ``per_hop``: those launches per
    bootstrap hop."""
    full = cases[0]
    return dict(name=name, route="cuda", **KERNELS[name], launches=launches,
                launches_per_step=per_step, launches_per_hop=per_hop,
                launches_per_batched_step=per_batched_step,
                launches_by_path=launches_by_path,
                max_abs_err=max(c["pos_max"] for c in cases),
                ms=full["call_ms"], device_ms=full["device_ms"],
                call_ms=full["call_ms"], plain_ms=full["plain_ms"],
                bound_ms=full["bound_ms"], bound_by=full["bound_by"],
                bound_share=full["bound_share"], library_ms=None,
                device_ms_by_shape={c["name"]: c["device_ms"] for c in cases},
                call_ms_by_shape={c["name"]: c["call_ms"] for c in cases},
                bound_ms_by_shape={c["name"]: c["bound_ms"] for c in cases},
                shape_by_case={c["name"]: c["shape"] + [c["num_iters"]]
                               for c in cases})


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
    batch_inputs = batch_pairs(frames, vo)
    res, ctx = {}, {}
    for name, phase in (
            ("kernels_klt_lk", lambda: phase_kernels("klt_lk", inputs,
                                                     batch_inputs=batch_inputs)),
            ("main_path", lambda: phase_main_path(scene, frames, vo, cfg,
                                                  cam)),
            ("bootstrap_graph", lambda: phase_bootstrap_graph(frames, vo)),
            ("presets", lambda: phase_presets(smi)),
            ("stream_path", lambda: phase_stream(scene, frames, vo)),
            ("kernels_klt_v1", lambda: phase_kernels(
                "klt_v1", inputs, batch_inputs=batch_inputs)),
            ("sift_path", lambda: phase_sift(scene, frames, cam)),
            ("cli", phase_cli),
            ("xla_path", lambda: phase_xla(scene, frames, cfg, cam)),
            ("v1_path", lambda: phase_v1_path(scene, frames, cfg, cam)),
            ("loop", lambda: phase_loop(ctx)),
            ("phase_b_repeat", lambda: phase_b_repeat(ctx)),
            ("disk", lambda: phase_disk(ctx)),
            ("stress", phase_stress),
            ("parallel", lambda: phase_parallel(ctx, scene, frames))):
        t0 = time.perf_counter()
        res[name] = phase()
        print(f"phase {name} {time.perf_counter() - t0:.1f} s", flush=True)
    lk_cases = res["kernels_klt_lk"] + res["presets"]["cases"]
    v1_cases = res["kernels_klt_v1"]
    main_res, v1_res = res["main_path"], res["v1_path"]

    lock = {f"lockstep_{k}": res["parallel"][k]
            for k in ("s2", f"s{MULTI_SEQS}")}
    v1_launches = v1_res["launches"]["klt_v1"]
    v1_in_boots = v1_res["launches_in_bootstraps"]["klt_v1"]
    print(json.dumps({"kernels": [
        kernel_entry("klt_lk", lk_cases, main_res["launches"],
                     main_res["launches_per_step"],
                     res["bootstrap_graph"]["klt_lk_per_hop"], {
                         "main_path": main_res["launches"],
                         "stream_path": res["stream_path"]["launches"][
                             "klt_lk"],
                         f"presets_{PRESET}": res["presets"]["path"][
                             "launches"],
                         **{k: v["launches"] for k, v in lock.items()}},
                     {k: v["launches_per_batched_step"]
                      for k, v in lock.items()}),
        kernel_entry("klt_v1", v1_cases, v1_launches,
                     (v1_launches - v1_in_boots) / v1_res["steps"],
                     v1_in_boots / v1_res["bootstrap_hops"],
                     {"v1_path": v1_launches})]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
