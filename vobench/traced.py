"""A cell's traced pass read with the program's spans and counters: the
stage split of the step, the card's idle and device time by program span,
and the per-layer numbers that read them.

    python3 -m vobench.traced --workload <cell> --seed <n>

Set-up as ``vobench.run``'s (``run._set_up``: the build, the drive, the
VO, the traffic's driver and one untimed pass), then one pass under
``torch.profiler`` (CUDA activity, as ``run``'s traced pass) with the
program's spans (``monocular_visual_odometry_va4mr_torch.core.spans``) on,
then the step graphs' stage map (``StepGraphs.stage_map``, under a
profiler of its own), and ``reference/spans.py`` reads the pass.  Prints
one JSON a line:

* ``vobench.traced_pass``: its seconds, frames, idle share, dispatches
  and device ms a frame, the graphs captured in it (``captures``, 0 after
  set-up), and per frame the program's counters (``COUNTS``) over it:
  re-bootstraps (``recover.done``), bytes up and down, host syncs;
* ``vobench.spans``: the card's idle ms and its device ms by program span,
  and the ``cudaGraphLaunch`` calls outside every ``graph.replay`` span;
* ``vobench.stages``: device ms a frame by stage, the staged and unstaged
  step and chunk replays (and where an unstaged one differs), and the
  stages' sum against the device time in those replays' extents on their
  streams, found without the links (``reference/spans.extent_us``), with
  the pass's device time that no host call queued;
* last, ``vobench.traced``: the card, and the five per-layer numbers
  (``reference/spans.metrics``; None where the pass has nothing to read).

Exit code 2, and nothing read, without a card.  ``run.py``'s traced pass
has no spans: this is its stand-in until it takes them.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time


def captures(vo) -> int:
    from monocular_visual_odometry_va4mr_torch.core import graphs

    own = sum(len(g.capture_s) for g in (vo.graphs, vo.fn_graphs)
              if g is not None)
    return own + graphs.captures(vo.device)[0]


def traced_pass(vo, drv):
    """One pass under the profiler with spans on: (its line, the traced
    window, its frames, ``spantrace.read``'s (events, links, streams,
    spans))."""
    import torch

    from monocular_visual_odometry_va4mr_torch.core import spans

    from . import profiling, spantrace
    from .reference import trace as tr

    before, caps = collections.Counter(spans.COUNTS), captures(vo)
    prof = profiling.start()
    spans.start()
    t0 = time.perf_counter()
    try:
        _, frames, _ = drv.run_pass(1)
        if vo.device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        records = spans.stop()
        profiling.stop(prof)
    events, window = profiling.finish(prof)
    d = spans.COUNTS - before
    line = dict(seconds=seconds, frames=frames,
                captures=captures(vo) - caps,
                rebootstraps=d["recover.done"],
                recover_attempts=d["recover.attempts"],
                steps=d["steps"], chunks=d["chunks"],
                bootstraps=d["bootstraps"],
                **{k.replace(".", "_") + "_per_frame": d[k] / frames
                   for k in ("h2d.bytes", "d2h.bytes", "host.syncs")})
    if window is not None and tr.device_events(events):
        line.update(idle_pct=100.0 * tr.idle_share(events, window),
                    dispatches_per_frame=tr.dispatches(events) / frames,
                    device_ms_per_frame=tr.device_us(events) / 1e3 / frames)
    return line, window, frames, spantrace.read(prof, records)


def trace_cell(cell, seed, device, workers=0):
    """The lines of ``cell``'s traced pass on ``device``, in order."""
    import torch

    from monocular_visual_odometry_va4mr_torch.core import spans as sp_prog
    from monocular_visual_odometry_va4mr_torch.pipeline.vo import op_kind

    from . import run
    from .reference import spans as sp, trace as tr

    torch.set_num_threads(1)
    device = torch.device(device)
    vo, _, drv, _ = run._set_up(cell, seed, device, workers)
    line, window, frames, (events, links, streams, spans) = traced_pass(
        vo, drv)
    lines = [("vobench.traced_pass", line)]
    maps = vo.graphs.stage_map() if vo.graphs is not None else {}
    how = dict(tol=sp_prog.CLOCK_US, kind=op_kind, streams=streams)
    split = sp.stage_split(events, links, spans, maps, **how)
    ms = lambda us: {k: v / 1e3 for k, v in us.items()}  # noqa: E731
    lines.append(("vobench.spans", dict(
        idle_ms=ms(sp.idle_by_span(events, window, spans)),
        device_ms=ms(sp.device_by_span(events, links, spans)),
        launches_outside_replays=sp.launches_outside(events, spans,
                                                     sp_prog.CLOCK_US),
        spans=len(spans), links=len(links))))
    f = split["frames"]
    lines.append(("vobench.stages", dict(
        device_ms_per_frame={k: v / 1e3 / f
                             for k, v in split["stage_us"].items()}
        if f else {},
        frames=f, staged=split["staged"], unstaged=split["unstaged"],
        differ=split["differ"][:5], keys=len(maps),
        stages_ms=sum(split["stage_us"].values()) / 1e3,
        extent_ms=split["extent_us"] / 1e3,
        replays_ms=split["replay_us"] / 1e3,
        unlinked_ms=split["unlinked_us"] / 1e3,
        device_ms=tr.device_us(events) / 1e3)))
    lines.append(("vobench.traced", dict(
        cell=cell.name, seed=seed,
        **sp.metrics(events, window, links, spans, maps, frames, **how))))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    from . import cell as cellmod, run

    if not torch.cuda.is_available():
        print("vobench.traced: no card", file=sys.stderr)
        return 2
    run.say("vobench.card", dict(nvidia_smi=run.power_line(),
                                 torch=torch.__version__,
                                 cuda=torch.version.cuda))
    for tag, obj in trace_cell(cellmod.load(args.workload), args.seed,
                               "cuda"):
        run.say(tag, obj)
    return 0


if __name__ == "__main__":
    sys.exit(main())
