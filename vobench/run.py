"""Run one cell of ``BENCHMARK.json`` on one card and print its result.

    python3 -m vobench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (timed as ``setup_s``, from this module's first line to the first
timed frame): the kernels the tracker launches are built (``build/``, once
a checkout), the drive is rendered once into ``vobench/cache/`` and loaded,
the program's ``VisualOdometry`` is made from the configuration file, the
traffic's driver takes its set-up (bootstraps, warm-up steps) and one whole
pass runs untimed, so that every graph the passes replay is captured.  The
window then runs whole passes, each with draws from its own seed, until
``--seconds`` have passed.  With ``--trace 1`` the first ``TRACE_PASSES``
passes run under ``torch.profiler`` and the per-layer metrics are read from
them; without, the end-to-end metrics.  Once the window has closed the
program's outputs are held against the drive's truth
(``reference/check.py``) and the last line of standard output is the
result.  Exit code 2, and no result, without a card, with fewer cards than
the cell asks for, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package
was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "monocular_visual_odometry_va4mr_tpu")
TRACKER_KERNELS = {"pallas2": ("klt_lk",), "pallas": ("klt_v1",), "xla": ()}
TRACE_PASSES = 1  # passes of a --trace 1 window under the profiler
CHECK_PASSES = 6  # passes whose tracks and landmarks the check reads


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names in ``sys.modules`` that a run may not load, each
    compared whole."""
    return sorted({k.partition(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def say(tag, obj, stream=None):
    print(f"{tag} {json.dumps(obj)}", file=stream or sys.stdout, flush=True)


def power_line():
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def _set_up(cell, seed, device, workers):
    """The program, the drive and the traffic's driver, warmed by one
    untimed pass: (vo, scene, driver, the set-up's parts in seconds)."""
    import numpy as np
    import torch

    from monocular_visual_odometry_va4mr_torch import _build
    from monocular_visual_odometry_va4mr_torch.core.camera import Camera
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import (
        VisualOdometry)

    from . import cell as cellmod, drive, drivers

    cfg, parts = cell.config, {}
    tick = time.perf_counter()

    def lap(name):
        nonlocal tick
        now = time.perf_counter()
        parts[name] = now - tick
        tick = now

    vo = VisualOdometry(Camera.from_matrix(np.asarray(cfg["drive"]["K"])),
                        cellmod.pipeline_config(cfg["pipeline"]), device,
                        seed=0)
    if device.type == "cuda":
        for name in TRACKER_KERNELS[vo.klt_backend]:
            _build.build(name)
    lap("build_s")
    scene, frames, parts["render_s"] = drive.frames(cfg["drive"], workers)
    lap("drive_s")
    drv = cellmod.driver(cell.traffic["driver"], cell.files)(
        vo, frames, cfg, cell.traffic, seed)
    lap("driver_setup_s")
    drv.run_pass(drivers.SETUP)
    if device.type == "cuda":
        torch.cuda.synchronize()
    lap("warm_pass_s")
    parts["capture_s"] = sum(sum(g.capture_s.values())
                             for g in (vo.graphs, vo.fn_graphs)
                             if g is not None)
    return vo, scene, drv, parts


def _window(drv, seconds, n_traced, device):
    """Whole passes until ``seconds`` have passed, the first ``n_traced``
    under the profiler: (passes, frames, stamps, window seconds, traced
    events and window or None, traced frames)."""
    import torch

    from . import profiling

    prof = profiling.start() if n_traced else None
    passes, frames, traced_frames = [], 0, 0
    stamps = dict(latency_ms=[], ba=[], bootstrap_ms=[], recoveries=[])
    t_w0 = time.perf_counter()
    index = 0
    while True:
        recs, n, info = drv.run_pass(index)
        passes += recs
        frames += n
        stamps["recoveries"].append(info.get("recoveries", 0))
        if index >= n_traced:  # the traced passes carry the profiler's cost
            for k in ("latency_ms", "ba", "bootstrap_ms"):
                stamps[k] += info.get(k, [])
        index += 1
        if index == n_traced:
            if device.type == "cuda":
                torch.cuda.synchronize()
            profiling.stop(prof)  # the rest of the window runs untraced
            traced_frames = frames
        if time.perf_counter() - t_w0 >= seconds and index >= max(1,
                                                                  n_traced):
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_w0
    traced = profiling.finish(prof) if prof is not None else None
    return passes, frames, stamps, t_w0, window_s, traced, traced_frames


def run(cell, seed, seconds, trace, device, t0=T0, workers=0):
    """One run of ``cell`` on ``device``: (the result, the earlier lines'
    set-up and window records).  The caller has checked the device."""
    import numpy as np
    import torch

    from . import cell as cellmod
    from .reference import check, trace as tr

    torch.set_num_threads(1)
    device = torch.device(device)
    on_card = device.type == "cuda"
    vo, scene, drv, parts = _set_up(cell, seed, device, workers)
    n_traced = TRACE_PASSES if trace else 0
    passes, frames, stamps, t_w0, window_s, events, traced_frames = \
        _window(drv, seconds, n_traced, device)
    setup_s = t_w0 - t0
    mem_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del drv, vo  # the program's state, before the reference runs
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    failed = int(sum(int(np.sum(p.status != check.STATUS_TRACKING))
                     for p in passes))
    values, readings = check.numbers(
        scene, passes, CHECK_PASSES, seed)
    correct, compared = check.judge(values, cell.limits)
    check_s = time.perf_counter() - t_check

    traced = None
    if events is not None and events[1] is not None and traced_frames:
        traced = types.SimpleNamespace(events=events[0], window=events[1],
                                       frames=traced_frames)
    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, frames=frames,
        passes=len({p.index for p in passes}), latency_ms=stamps["latency_ms"],
        ba_flags=stamps["ba"], trace=traced,
        config=cell.config, traffic=cell.traffic)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cellmod.reader(m["name"], cell.files)(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    window = dict(passes=ctx.passes, frames=frames, window_s=window_s,
                  recoveries=sum(stamps["recoveries"]), lost=failed,
                  check_s=check_s, **readings,
                  **{k: (v if np.isfinite(v) else None)
                     for k, v in values.items() if k not in cell.limits})
    if stamps["latency_ms"]:
        window.update(latency_p50_ms=statistics.median(stamps["latency_ms"]),
                      latency_samples=len(stamps["latency_ms"]))
    if stamps["bootstrap_ms"]:
        window["bootstrap_ms_p50"] = statistics.median(stamps["bootstrap_ms"])
    result = dict(correct=bool(correct), attempted=int(frames),
                  failed=failed, metrics=metrics)
    dev = dict(platform="gpu" if on_card else device.type,
               kind=torch.cuda.get_device_name(device) if on_card else "cpu",
               count=cell.chips, memory_peak_bytes=int(mem_peak))
    if traced is not None:
        dev["busy_s"] = tr.busy_us(traced.events, traced.window) / 1e6
        dev["window_s"] = (traced.window[1] - traced.window[0]) / 1e6
        result["breakdown"] = dict(
            device_ops=tr.top_device_ops(traced.events),
            idle_gaps=tr.idle_gaps(traced.events, traced.window))
        window.update(traced_passes=n_traced, traced_frames=traced_frames)
    result["device"] = dev
    result["check"] = compared
    return result, dict(setup=dict(setup_s=setup_s, **parts), window=window)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from . import cell as cellmod

    cell = cellmod.load(args.workload)
    if not torch.cuda.is_available():
        print("vobench: torch.cuda.is_available() is false: no card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"vobench: {cell.name} asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    say("vobench.card", dict(nvidia_smi=power_line(),
                             torch=torch.__version__,
                             cuda=torch.version.cuda))
    return report(cell, args, torch.device("cuda"))


def report(cell, args, device, **kw) -> int:
    """Run ``cell`` on ``device`` and print the result: the set-up and
    window lines, each number compared beside its limit last on standard
    error, and the result as the last line of standard output."""
    result, info = run(cell, args.seed, args.seconds, args.trace, device,
                       **kw)
    say("vobench.setup", info["setup"])
    say("vobench.window", info["window"])
    bad = forbidden_modules()
    if bad:
        print(f"vobench: the run loaded {bad}", file=sys.stderr)
        return 2
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
