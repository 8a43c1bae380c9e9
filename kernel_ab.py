#!/usr/bin/env python3
"""The LK kernels of this checkout against other sources of them, in turns
on one NVIDIA GPU.

Run from the root of a checkout, with one of:

    python3 kernel_ab.py --base DIR
    python3 kernel_ab.py --base-src NAME=FILE

``DIR`` is the root of another checkout, for example an earlier commit
unpacked with ``git archive`` into a git-ignored directory: both kernels
are compared with its ``csrc/klt_lk.cu`` and ``csrc/klt_v1.cu``.
``--base-src`` compares kernel ``NAME`` alone with the source ``FILE``, for
example ``klt_v1=variants/klt_v1_one_box.cu``.  Every source is built (one
``nvcc`` per source, all started together) and each kernel is called
through this checkout's wrapper, so only the kernel differs (a source from
before the kernels' batch axis, whose launch takes no batch size, is called
with a batch of one).  The inputs
are ``chip_smoke.py``'s: frames 12 and 13 of ``bench.py``'s scene at the
main path's three calls (full-res and /4 forward, full-res backward) and
the input built so that the reference's slab wraps on every feature
(``chip_smoke.wrap_call``), N = 1024.

Per kernel and call it prints one JSON line: both kernels' outputs compared
(``bit_equal``: the same bits in every output, NaNs included;
``max_abs_diff`` over finite values; ``differ_share``: the share of
features whose output bits differ, beside ``wrapped_share``, the share that
the reference kernel's slab wrap reaches (``wrapped``), and
``differ_elsewhere``, the count of differing features it does not reach),
``device_ms`` of base and of this
checkout's kernel (``chip_smoke.device_time_ms``) taken in turns base, new,
new, base, ``ROUNDS`` times, with their medians, each one's ``call_ms``, the
plain version's time, the bound (``chip_smoke.bound_ms``) and each kernel's
share of it.  Per kernel it then prints how the full-resolution call's
device time scales: both kernels with the first 8 and all 1024 features, 0
and 6 iterations.  A chain of dependent steps per feature reads nearly the
same for 8 features as for 1024; work that shares the SMs grows with them.
For ``klt_v1`` it also prints how many search boxes beyond the first this
checkout's kernel stages per feature (a histogram, ``search_boxes``) and
both kernels' device time on the 8 features whose window leaves a box most
often, on 8 whose window never does, and on all but those 8: a call lasts
as long as its slowest chain.  Then the card's name and power limit.  Exits
nonzero without a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import statistics
import time
from pathlib import Path
from unittest import mock

import chip_smoke as cs

WRAPPERS = {"klt_lk": "klt_pallas2", "klt_v1": "klt_pallas"}
ROUNDS = 3  # turns of base, new, new, base per call


def build_both(bases):
    """The base sources ``{name: path}`` and this checkout's kernels of the
    same names, built in parallel: {(name, which): (wrapper module,
    entry)}."""
    import importlib

    from monocular_visual_odometry_va4mr_torch import _build

    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(2 * len(bases)) as pool:
        for name, src in bases.items():
            jobs[name, "base"] = pool.submit(_build.build, name, src)
            jobs[name, "new"] = pool.submit(_build.build, name)
        entries = {}
        for (name, which), fut in jobs.items():
            lib, log, build_s = fut.result()
            print(f"build {name} ({which}) {build_s:.2f} s", flush=True)
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print("  ptxas " + line.strip())
            mod = importlib.import_module(f"{cs.PKG}.ops.{WRAPPERS[name]}")
            src = bases[name] if which == "base" else _build.CSRC / f"{name}.cu"
            if takes_batch(src, name):
                entry = _build.bind(ctypes.CDLL(str(lib)), name,
                                    mod.LAUNCH_ARGTYPES)
            else:
                entry = unbatched(_build.bind(
                    ctypes.CDLL(str(lib)), name,
                    mod.LAUNCH_ARGTYPES[:2] + mod.LAUNCH_ARGTYPES[3:]))
            entries[name, which] = (mod, entry)
    return entries


def takes_batch(src, name):
    """Whether the source's ``<name>_launch`` takes the batch size B after
    its two planes (sources from before the kernels' batch axis do not)."""
    text = Path(src).read_text()
    head = text[text.index(f"{name}_launch("):]
    return "int B," in head[:head.index(")")]


def unbatched(entry):
    """An entry point without the batch size, called as one with it: only a
    batch of one passes."""
    def call(tmpl, srch, B, *rest):
        if B != 1:
            raise ValueError("this source's kernel has no batch axis")
        return entry(tmpl, srch, *rest)

    return call


def wrapped(name, call):
    """Per feature of ``call``, whether it meets the reference kernel's slab
    wrap: for ``klt_v1`` a template whose slab row is a multiple of 8 or
    whose slab column is 0 (``klt_v1_plain``, which reads them as the
    reference does); for ``klt_lk`` a search that, at an offset the plain
    version passes through, reads a row past the reference's slab
    (``stress_diag.slab_top``), where the port reads the true row."""
    import torch

    import stress_diag
    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1

    _, _, plain, args, iters, extra, _ = call
    if name == "klt_v1":
        _, _, yi, xi = v1.slab_geometry(args[2], *args[0].shape)
        return (yi % 8 == 0) | (xi == 0)
    qy = args[2][:, 5]
    end = stress_diag.slab_top(qy) + stress_diag.SLAB_ROWS
    out = torch.zeros_like(qy, dtype=torch.bool)
    for k in range(iters + 1):
        n = torch.floor(plain(*args, num_iters=k, **extra)[:, 1]).clamp(
            -8.0, 7.0)
        out |= qy + n + extra["win"] >= end
    return out


def compare(name, call, entries):
    import torch

    case, kernel, plain, args, iters, extra, row_bytes = call
    mod = entries[name, "new"][0]

    def run():
        return kernel(*args, num_iters=iters, **extra)

    def timed(which, timer=cs.device_time_ms):
        """``timer`` of the wrapper with ``which`` checkout's kernel."""
        with mock.patch.object(mod, "_entry",
                               lambda: entries[name, which][1]):
            return timer(run)

    def once(fn):
        return fn()

    out_b, out_n = timed("base", once), timed("new", once)
    torch.cuda.synchronize()
    fin = torch.isfinite(out_b) & torch.isfinite(out_n)
    times = {"base": [], "new": []}
    for _ in range(ROUNDS):
        for which in ("base", "new", "new", "base"):
            times[which].append(timed(which))
    iters_run = cs.iterations_run(
        lambda k: plain(*args, num_iters=k, **extra), [0, 1], iters)
    b_ms, b_by, _, _ = cs.bound_ms(args[2].shape[0], iters_run, row_bytes,
                                   5 * 4)
    dev = {w: statistics.median(t) for w, t in times.items()}
    differ = (out_b.view(torch.int32) != out_n.view(torch.int32)).any(1)
    wraps = wrapped(name, call)
    res = dict(
        kernel=name, case=case, shape=list(args[0].shape),
        n=args[2].shape[0], num_iters=iters,
        bit_equal=not bool(differ.any()),
        max_abs_diff=float((out_b - out_n)[fin].abs().max()),
        differ_share=float(differ.float().mean()),
        wrapped_share=float(wraps.float().mean()),
        differ_elsewhere=int((differ & ~wraps).sum()),
        base_device_ms=dev["base"], device_ms=dev["new"],
        base_device_ms_runs=times["base"], device_ms_runs=times["new"],
        speedup=dev["base"] / dev["new"],
        base_call_ms=timed("base", cs.call_time_ms),
        call_ms=timed("new", cs.call_time_ms),
        plain_ms=cs.call_time_ms(
            lambda: plain(*args, num_iters=iters, **extra)),
        bound_ms=b_ms, bound_by=b_by, base_bound_share=b_ms / dev["base"],
        bound_share=b_ms / dev["new"])
    print("kernel_ab " + json.dumps(res), flush=True)
    return res


def scaling(name, call, entries):
    """Device time (us) of both kernels on the first 8 and on all features,
    with 0 and with the call's iterations."""
    _, kernel, _, args, iters, extra, _ = call
    mod = entries[name, "new"][0]
    n = args[2].shape[0]
    res = {}
    for which in ("base", "new"):
        with mock.patch.object(mod, "_entry",
                               lambda: entries[name, which][1]):
            for k in (8, n):
                # planes, then per-feature rows (feat and valid, or meta)
                sub = [*args[:2], *(t[:k].contiguous() for t in args[2:])]
                for it in (0, iters):
                    res[f"{which}_n{k}_it{it}_us"] = 1e3 * cs.device_time_ms(
                        lambda: kernel(*sub, num_iters=it, **extra))
    print(f"kernel_scaling {name} " + json.dumps(res), flush=True)


def search_boxes(meta, offsets, H, W):
    """How ``csrc/klt_v1.cu`` stages its search along a path of offsets.

    The kernel first stages the 32 x 32 pixels that offsets of up to +-8 px
    around the g = 0 window reach.  A window that leaves the staged box gets
    a box 64 px wide reaching 8 px behind it and 40 px ahead in the
    direction the window moved (centred if it did not move sideways), rows
    +-8 px.  ``offsets``: the (N, 2) [gx, gy] offsets after 0, 1, ...
    iterations.  Returns, per feature, how many times a window left its box
    and whether any window origin was clipped to the slab (int64, bool)."""
    import torch

    from monocular_visual_odometry_va4mr_torch.ops import klt_pallas as v1

    reach, box, wide = 8, 32, 64
    y0, x0, _, _ = v1.slab_geometry(meta, H, W)
    hi_y, hi_x = v1.ROWS - v1.WIN - 2, v1.LANES - v1.WIN - 2
    wy, wx = [], []
    clipped = torch.zeros(meta.shape[0], dtype=torch.bool, device=meta.device)
    for g in offsets:
        sy = ((meta[:, 2] + g[:, 1]) - v1.R) - (y0.float() - v1.SLAB_PAD)
        sx = ((meta[:, 3] + g[:, 0]) - v1.R) - (x0.float() - v1.SLAB_PAD)
        iy, ix = v1._floor_int(sy), v1._floor_int(sx)
        clipped |= (iy < 0) | (iy > hi_y) | (ix < 0) | (ix > hi_x)
        wy.append(v1._register(sy, y0, hi_y)[0])
        wx.append(v1._register(sx, x0, hi_x)[0])
    by, bx = wy[0] - reach, wx[0] - reach
    bw = torch.full_like(bx, box)
    left = torch.zeros_like(bx)
    for k in range(1, len(offsets)):
        y, x = wy[k], wx[k]
        out = ((y < by) | (y > by + box - v1.WIN - 1) | (x < bx)
               | (x > bx + bw - v1.WIN - 1))
        dx = x - wx[k - 1]
        ahead = torch.where(dx > 0, x - reach,
                            torch.where(dx < 0, x + v1.WIN + 1 + reach - wide,
                                        x - (wide - v1.WIN - 1) // 2))
        by = torch.where(out, y - reach, by)
        bx = torch.where(out, ahead, bx)
        bw = torch.where(out, torch.full_like(bw, wide), bw)
        left += out.long()
    return left, clipped


def v1_runaways(call, entries):
    """How many boxes beyond the first this checkout's ``klt_v1`` stages
    per feature of the call (``search_boxes``), and the device time (us) of
    both kernels on the 8 features whose window leaves a box most often, on
    8 whose window never does, and on all but those 8."""
    import torch

    _, kernel, plain, args, iters, extra, _ = call
    mod = entries["klt_v1", "new"][0]
    tmpl, _, meta = args
    offsets = [plain(*args, num_iters=k, **extra)[:, :2] - meta[:, [3, 2]]
               for k in range(iters + 1)]
    left = search_boxes(meta, offsets, *tmpl.shape)[0]
    order = torch.argsort(left, descending=True, stable=True)
    never = torch.nonzero(left == 0).flatten()
    subsets = {"most_8": order[:8], "never_8": never[:8],
               "all_but_most_8": order[8:]}
    subsets = {k: v for k, v in subsets.items() if len(v) % 8 == 0}
    res = {"boxes_hist": torch.bincount(left).tolist()}
    for which in ("base", "new"):
        with mock.patch.object(mod, "_entry",
                               lambda: entries["klt_v1", which][1]):
            for sub_name, idx in subsets.items():
                sub = [*args[:2], args[2][idx].contiguous()]
                res[f"{which}_{sub_name}_us"] = 1e3 * cs.device_time_ms(
                    lambda: kernel(*sub, num_iters=iters, **extra))
    print("kernel_runaways klt_v1 " + json.dumps(res), flush=True)


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--base", type=Path,
                       help="root of another checkout: both kernels")
    which.add_argument("--base-src", metavar="NAME=FILE",
                       help="kernel NAME against the source FILE")
    args = ap.parse_args()
    if args.base is not None:
        bases = {name: args.base.resolve() / cs.PKG / "csrc" / f"{name}.cu"
                 for name in WRAPPERS}
    else:
        name, _, src = args.base_src.partition("=")
        if name not in WRAPPERS:
            ap.error(f"--base-src: NAME is one of {sorted(WRAPPERS)}")
        bases = {name: Path(src).resolve()}
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    from monocular_visual_odometry_va4mr_torch.dataio import synthetic

    smi = cs.device_line()
    print(f"device {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    entries = build_both(bases)
    t0 = time.perf_counter()
    scene = synthetic.make_textured_scene(
        seed=cs.SEED, num_frames=cs.NUM_FRAMES, image_shape=cs.IMAGE_SHAPE,
        step=1.0)
    frames = {i: scene.render(i)
              for i in (cs.TIMED_START, cs.TIMED_START + 1)}
    print(f"frames rendered in {time.perf_counter() - t0:.1f} s", flush=True)
    inputs = cs.bench_inputs(frames, cs.main_path_vo(scene)[2])
    for name in bases:
        calls = cs.kernel_calls(name, inputs) + [cs.wrap_call(name, inputs)]
        for call in calls:
            compare(name, call, entries)
        scaling(name, calls[0], entries)
        if name == "klt_v1":
            v1_runaways(calls[0], entries)
    print(smi)


if __name__ == "__main__":
    main()
