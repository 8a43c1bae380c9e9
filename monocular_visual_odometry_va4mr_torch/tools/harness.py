"""What the port's tools and ``chip_smoke.py`` share: the spawn-pool scene
renderer, the health gate, the profiler readings, ``--device`` handling and
``bench.py``'s timing procedure on the port's block driver.

Device handling: a tool runs where ``--device`` says, ``cuda`` by default.
``resolve_device`` raises when CUDA is asked for and absent; nothing falls
back to the CPU, and a kernel that does not build raises from its wrapper.
On the CPU the LK wrappers run their plain versions (their tensors lie on
the CPU), and every device metric (device ms, launches) is ``None``: a CPU
run measures no device.
"""
from __future__ import annotations

import argparse
import collections
import json
import multiprocessing
import os
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..core import spans

REPO = Path(__file__).resolve().parents[2]
BUILD = REPO / "build"
# ``bench.py``'s health gate without its reference-CPU term: 0 LOST, a finite
# trajectory and an ATE RMSE within this share of the path.
ATE_BOUND_FRAC = 0.02


# --- device ------------------------------------------------------------------

def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for, at small sizes)")


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; raises when it is CUDA and there is none."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (torch.cuda.is_available() "
                           "is false); pass --device cpu to run on the CPU")
    return dev


def build_kernels(device, names=("klt_lk", "klt_v1")):
    """On the card, build the CUDA kernels ``names`` (one ``nvcc`` each, all
    started together) before anything is timed; a failed build raises.
    Returns {name: (library, compiler log, seconds)}, empty off the card."""
    if torch.device(device).type != "cuda":
        return {}
    from concurrent.futures import ThreadPoolExecutor

    from .. import _build

    with ThreadPoolExecutor(len(names)) as pool:
        futs = {n: pool.submit(_build.build, n) for n in names}
        return {n: fut.result() for n, fut in futs.items()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0]


def device_label(device) -> str:
    """What a result line names as its device: the ``nvidia-smi`` line of
    the card, or ``cpu``."""
    return device_line() if torch.device(device).type == "cuda" else "cpu"


def device_fields(device) -> dict:
    """``device`` (the card's name) and ``power_limit`` from the
    ``nvidia-smi`` line; ``cpu`` and ``None`` off the card."""
    if torch.device(device).type != "cuda":
        return dict(device="cpu", power_limit=None)
    name, _, power = device_line().rpartition(",")
    return dict(device=name.strip(), power_limit=power.strip())


def peak_rss_mb() -> float:
    """The peak resident set of this process, MiB (Linux ``ru_maxrss``)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --- scenes ------------------------------------------------------------------

def _render(args):
    scene, i = args
    return scene.render(i)


def spawn_map(fn, items, workers=None, initializer=None, initargs=()):
    """``[fn(x) for x in items]`` over a spawn pool of ``workers`` processes
    (one per core by default; in this process, after ``initializer``, when
    that is 1).  ``fn`` and ``initializer`` are module-level functions."""
    items = list(items)
    workers = min(len(items), workers or os.cpu_count() or 1)
    if workers <= 1:
        if initializer is not None:
            initializer(*initargs)
        return [fn(x) for x in items]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, initializer, initargs) as pool:
        return pool.map(fn, items)


def render_frames(scene, n):
    """Frames 0..n-1 of ``scene``, rendered by a spawn pool of one process
    per core (in this process on one core)."""
    return spawn_map(_render, [(scene, i) for i in range(n)])


class CallCounts:
    """Within ``with``, the steps (a frame a ``step``, K a ``step_chunk``;
    ``chunks`` counts the chunks), the bootstraps and their KLT hops
    (``len(intermediate) + 1`` a KLT bootstrap, 0 a SIFT one) that the
    port ran, read as deltas of ``core.spans.COUNTS`` (``steps``,
    ``chunks``, ``bootstraps``, ``bootstrap.hops``) and frozen at the
    exit, so a caller can hold ``klt_lk``'s launches of ``vo`` at 3 per
    step and hop."""

    FIELDS = dict(steps="steps", chunks="chunks", bootstraps="bootstraps",
                  hops="bootstrap.hops")

    def __init__(self, vo):
        self.vo = vo
        self._at = self._end = None

    def __enter__(self):
        self._at = collections.Counter(spans.COUNTS)
        return self

    def __exit__(self, *exc):
        self._end = collections.Counter(spans.COUNTS)

    def __getattr__(self, field):
        if field not in CallCounts.FIELDS or self._at is None:
            raise AttributeError(field)
        key = CallCounts.FIELDS[field]
        now = spans.COUNTS if self._end is None else self._end
        return now[key] - self._at[key]

    def expected_lk(self) -> int:
        """``klt_lk``'s launches these calls make: 3 per step and hop on
        the kernel path, none off it."""
        return 3 * (self.steps + self.hops) if launches_lk(self.vo) else 0


def step_graphs(vo) -> dict:
    """``vo``'s captured step graphs so far (``VisualOdometry.graphs``): how
    many and their capture seconds, all and the chunks' alone (zeros where
    nothing was captured, as on the CPU)."""
    g = vo.graphs
    keys = list(g.capture_s) if g is not None else []
    chunks = [k for k in keys if k[0] == "chunk"]
    return dict(graphs=len(keys),
                capture_s=sum(g.capture_s[k] for k in keys),
                chunk_graphs=len(chunks),
                chunk_capture_s=sum(g.capture_s[k] for k in chunks))


# --- process groups ----------------------------------------------------------

def _world_entry(rank, fn, world, store, out_dir, args):
    import torch.distributed as dist

    from ..parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_world(fn, world, *args):
    """``fn(rank, world, *args)`` in each of ``world`` spawned processes
    joined in one process group (``parallel.multihost.initialize`` through
    a ``file://`` store under ``build/``: NCCL, one card a rank, where CUDA
    is present, gloo on the CPU).  ``fn`` is a module-level function; its
    results, in rank order."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="world-", dir=BUILD)
    try:
        mp.spawn(_world_entry, args=(fn, world, os.path.join(tmp, "pg"), tmp,
                                     args), nprocs=world)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def parse_worlds(text, device):
    """World sizes from ``text`` (comma-separated), or by default 1 on the
    card (one card, one rank) and 1, 2, 4, 8 on the CPU."""
    if text:
        return [int(s) for s in text.split(",") if s.strip()]
    return [1] if torch.device(device).type == "cuda" else [1, 2, 4, 8]


# --- health ------------------------------------------------------------------

def trajectory_health(scene, frame_ids, est, statuses):
    """LOST count, finiteness and ATE of camera positions ``est``."""
    from ..evalx import ate

    gt = scene.poses_WC[list(frame_ids), :3, 3]
    finite = bool(np.all(np.isfinite(est)))
    ate_rmse = float(ate.ate_rmse(est, gt)) if finite else float("nan")
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    return dict(frames=len(statuses), lost=sum(1 for s in statuses if s != 0),
                finite=finite, ate=ate_rmse, ate_bound=ATE_BOUND_FRAC * path,
                path=path)


def healthy(res) -> bool:
    return (not res["lost"] and res["finite"]
            and res["ate"] <= res["ate_bound"])


def positions_of(Ts) -> np.ndarray:
    """Camera positions of (F, 4, 4) T_CW poses."""
    return np.stack([-T[:3, :3].T @ T[:3, 3]
                     for T in np.asarray(Ts, np.float64)])


# --- profiler ----------------------------------------------------------------

def _on_device(prof):
    """The device events (kernels, copies, fills) of a finished
    ``torch.profiler`` window.  Summing ``key_averages()``'s
    ``self_device_time_total`` instead counts each kernel twice, under its
    own name and under the operator that launched it."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


# Runtime and driver calls that put work on the card's queue: a kernel, a
# graph (one call for all of its kernels), a copy or a fill.
_DISPATCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                      "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                      "cuMemset")


def _host_dispatches(prof):
    """The host's dispatches of a finished ``torch.profiler`` window: the
    runtime calls (``_DISPATCH_PREFIXES``) it traced on the host.  Under a
    graph replay the device events stay and the dispatches collapse into
    one ``cudaGraphLaunch``."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.name.startswith(_DISPATCH_PREFIXES)]


def device_profile(prof, steps, kernel):
    """Device time per step from a finished ``torch.profiler`` window: all
    device events together and the kernels whose name holds ``kernel``
    (ms, calls), and the host's dispatches per step."""
    dev = _on_device(prof)
    total_us = sum(e.time_range.elapsed_us() for e in dev)
    mine = [e.time_range.elapsed_us() for e in dev if kernel in e.name]
    kernel_us, calls = sum(mine), len(mine)
    return dict(steps=steps, device_ms_per_step=total_us / 1e3 / steps,
                launches_per_step=len(dev) / steps,
                dispatches_per_step=len(_host_dispatches(prof)) / steps,
                kernel=kernel, kernel_ms_per_step=kernel_us / 1e3 / steps,
                kernel_calls_per_step=calls / steps,
                kernel_ms_per_call=kernel_us / 1e3 / calls if calls else None,
                device_time_seen=total_us > 0)


def _profiled(fn, reps):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def profile_calls(fn, reps=3):
    """Device ms, device events (kernels, copies, fills: "launches") and
    host dispatches (``_host_dispatches``) per call of ``fn`` from
    ``torch.profiler``."""
    prof = _profiled(fn, reps)
    dev = _on_device(prof)
    return (sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps,
            len(dev) / reps, len(_host_dispatches(prof)) / reps)


def profile_steps(fn, steps, device, kernel="klt_lk_kernel"):
    """Device ms, launches (device events), host dispatches and ``kernel``
    launches per step of ``fn``, one call of which runs ``steps`` steps;
    all ``None`` off the card."""
    if torch.device(device).type != "cuda":
        return dict(device_ms_per_step=None, launches_per_step=None,
                    dispatches_per_step=None, klt_lk_per_step=None)
    prof = _profiled(fn, 1)
    dev = _on_device(prof)
    return dict(
        device_ms_per_step=sum(e.time_range.elapsed_us() for e in dev)
        / 1e3 / steps,
        launches_per_step=len(dev) / steps,
        dispatches_per_step=len(_host_dispatches(prof)) / steps,
        klt_lk_per_step=sum(1 for e in dev if kernel in e.name) / steps)


def host_ms(fn, device, reps=20, warmup=3):
    """Median host ms of ``fn`` over ``reps`` calls, each between two device
    syncs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


# --- bench.py's procedure ----------------------------------------------------

PROFILE_FRAMES = 8  # frames of the block driver under torch.profiler


def launches_lk(vo) -> bool:
    """Whether ``vo``'s tracker launches the ``klt_lk`` kernel (on the CPU
    its wrapper runs the plain version and counts nothing)."""
    return vo.klt_backend == "pallas2" and vo.device.type == "cuda"


def bench_run(vo, frames, *, seed=0, stride=4, start=12, reps=3):
    """``bench.py``'s procedure on the port: bootstrap over frames
    0..``stride`` (the frames between as hops), step the frames up to
    ``start`` (warm-up, health-checked), then ``scan_driver.run_streaming``
    over frames ``start``.. in one block, once to warm and ``reps`` times
    timed (best kept), and once more over ``PROFILE_FRAMES`` of them under
    ``torch.profiler``.  Draws come from ``runner.frame_generator(seed,
    frame)``.

    Returns the frame ids, positions and statuses of the bootstrap frame,
    the warm-up and the timed frames, ``n_warm`` (the bootstrap frame and the
    warm-up), the timing, and ``klt_lk``'s launches, which must be 3 per hop
    and per step on the kernel path (0 off it: it raises otherwise)."""
    from ..ops import klt_pallas2 as k2
    from ..pipeline import runner, scan_driver

    dev = vo.device
    up = [torch.as_tensor(f).to(dev) for f in frames[:start]]
    sync(dev)
    k2.klt_lk.launches = 0
    t0 = time.perf_counter()
    state = vo.bootstrap(up[0], up[stride], intermediate=up[1:stride],
                         generator=runner.frame_generator(seed, 0, dev))
    sync(dev)
    bootstrap_ms = 1e3 * (time.perf_counter() - t0)
    ids, Ts, statuses = [stride], [state.T_CW.cpu().numpy()], [
        int(state.status)]
    for i in range(stride + 1, start):
        state = vo.step(state, up[i],
                        generator=runner.frame_generator(seed, i, dev))
        ids.append(i)
        Ts.append(state.T_CW.cpu().numpy())
        statuses.append(int(state.status))
    timed = list(range(start, len(frames)))

    def stream(which=timed):
        out = scan_driver.run_streaming(
            vo, state, ((i, frames[i]) for i in which), seed,
            block=len(which))
        sync(dev)
        return out

    stream()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _, outs, fids, _ = stream()
        best = min(best, time.perf_counter() - t0)
    launches = k2.klt_lk.launches
    expected = (3 * stride + 3 * (start - stride - 1)
                + 3 * len(timed) * (reps + 1)) if launches_lk(vo) else 0
    if launches != expected:
        raise RuntimeError(f"klt_lk launched {launches} times, expected "
                           f"{expected}: 3 per bootstrap hop and per step")
    prof_ids = timed[:PROFILE_FRAMES]
    prof = profile_steps(lambda: stream(prof_ids), len(prof_ids), dev)
    if list(fids) != timed:
        raise RuntimeError(f"the block driver ran frames {fids}, not {timed}")
    return dict(
        ids=ids + timed, positions=positions_of(Ts + list(outs.T_CW)),
        statuses=statuses + [int(s) for s in outs.status], n_warm=len(ids),
        n_timed=len(timed), best_s=best, fps=len(timed) / best,
        step_ms=1e3 * best / len(timed), bootstrap_ms=bootstrap_ms,
        klt_lk_launches=launches, klt_lk_launches_expected=expected, **prof)


def parse_seeds(text: str):
    return [int(s) for s in text.split(",") if s.strip()]


def write_json(path, obj) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
