"""The batched step against its batch size: S sequences stepped in lockstep
as one batch a frame (``VisualOdometry.step_batch``, the port's
``jax.jit(jax.vmap(_step_impl))``; one replay of a captured graph a frame on
the card) at S = 1, 2, 4, 8, 11, beside the solo step.

The sequences are S windows of ``--frames`` frames (default 24) of
``tools/bench``'s scene and configuration (the textured KITTI-geometry
corridor, seed 11, 100 frames at 376x1241, ``kitti_tuned_config()`` with
the KLT bootstrap), window k starting at frame k * (100 - frames) // 10, so
that 11 windows span the scene.  Each window is bootstrapped alone over its
first 5 frames (stride 4) with the generator of ``multi_seq``'s sequence k,
as ``parallel/multi_seq.py`` does, then the batch steps through the rest.

Per S, on a fresh VO (its own graphs and memory pool), one JSON line: the
median host ms of a batched frame between two device syncs (frames that
captured a graph left out), frames/s over all S sequences, ``klt_lk``
launches per batched step, the capture seconds of the batched graphs, the
peak device MB of the S bootstraps and steps, LOST frames, and from
``torch.profiler`` the device ms, device events and host dispatches of one
batched step beside the same VO's step of the first sequence's state and
frame in a batch of one (``one``: the same arithmetic, so the events'
ratio shows what runs per sequence) and alone (``solo``: the libraries'
arithmetic, ``pipeline/vo.py``), 3 calls each, and the card's name and
power limit.  Device numbers are ``null`` off the card.

    python -m monocular_visual_odometry_va4mr_torch.tools.bench_lockstep \\
        [--sizes 1,2,4,8,11] [--frames 24]
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

from . import bench, harness

SIZES = "1,2,4,8,11"
FRAMES = 24
WINDOWS = 11  # KITTI odometry 00-10


def windows(frames, S, n):
    """S windows of n frames; 11 of them span the scene."""
    gap = (len(frames) - n) // (WINDOWS - 1)
    return [frames[k * gap:k * gap + n] for k in range(S)]


def run_size(scene, frames, S, n, device):
    """One batch size's line."""
    import torch

    from ..core.state import stack_states, unstack_states
    from ..ops import klt_pallas2 as k2
    from ..parallel.multi_seq import sequence_seed
    from ..pipeline.runner import frame_generator

    on_card = torch.device(device).type == "cuda"
    vo = bench.make_vo(scene, device)
    seqs = windows(frames, S, n)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    b = bench.BOOTSTRAP_STRIDE
    seeds = [sequence_seed(0, s) for s in range(S)]
    batch = stack_states([
        vo.bootstrap(seq[0], seq[b], intermediate=seq[1:b],
                     generator=frame_generator(sd, 0, vo.device))
        for seq, sd in zip(seqs, seeds)])

    def graphs():
        return len(vo.graphs.graphs) if vo.graphs else 0

    ms, lost, launches = [], 0, 0
    for f in range(b + 1, n):
        gens = [frame_generator(sd, f, vo.device) for sd in seeds]
        captured = graphs()
        before = k2.klt_lk.launches
        harness.sync(device)
        t0 = time.perf_counter()
        batch = vo.step_batch(batch, [seq[f] for seq in seqs], gens)
        harness.sync(device)
        dt = 1e3 * (time.perf_counter() - t0)
        launches += k2.klt_lk.launches - before
        if graphs() == captured:
            ms.append(dt)
        lost += int((batch.status != 0).sum())
    steps = n - b - 1
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else None
    med = statistics.median(ms)
    res = dict(
        sequences=S, frames=n, batched_steps=steps,
        ms_per_batched_frame=med, frames_per_s=1e3 * S / med, lost=lost,
        klt_lk_per_batched_step=launches / steps if on_card else None,
        capture_s=sum(v for k, v in vo.graphs.capture_s.items()
                      if k[-1] == S) if vo.graphs else None,
        peak_device_mb=peak_mb)
    if on_card:
        images = [seq[n - 1] for seq in seqs]
        gens = [frame_generator(sd, n, vo.device) for sd in seeds]
        one = unstack_states(batch)[0]
        one_batch = stack_states([one])
        prof = {}
        for name, fn in (
                ("batched", lambda: vo.step_batch(batch, images, gens)),
                ("one", lambda: vo.step_batch(one_batch, images[:1],
                                              gens[:1])),
                ("solo", lambda: vo.step(one, images[0],
                                         generator=gens[0]))):
            d_ms, events, disp = harness.profile_calls(fn)
            prof[name] = dict(device_ms=d_ms, device_events=events,
                              dispatches=disp)
        for name in ("one", "solo"):
            prof[f"events_ratio_{name}"] = (
                prof["batched"]["device_events"]
                / prof[name]["device_events"])
        res["profile"] = prof
    else:
        res["profile"] = None
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=SIZES,
                    help=f"batch sizes, comma-separated (default {SIZES})")
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help=f"frames of each window (default {FRAMES})")
    harness.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device)
    harness.build_kernels(device)
    scene, frames = bench.render_scene()
    for S in harness.parse_seeds(args.sizes):
        line = run_size(scene, frames, S, args.frames, device)
        line.update(harness.device_fields(device))
        harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
