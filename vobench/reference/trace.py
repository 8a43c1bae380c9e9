"""Arithmetic on a traced window, on plain events: each event is a tuple
``(kind, name, start_us, end_us)`` with ``kind`` "device" for an operation
on the card (a kernel, a copy, a fill) and "host" for a call on the host.
The harness turns ``torch.profiler``'s events into these, so this file
needs neither torch nor the program.

Device time counts each device event once (the port's
``tools/harness.py::_on_device``: summing ``key_averages()`` would count a
kernel under its own name and under the operator that launched it).  The
host's dispatches are the runtime calls that put work on the card's queue
(``_DISPATCH_PREFIXES``, as ``tools/harness.py`` counts them: one
``cudaGraphLaunch`` for all the kernels of a replayed graph).  The busy
time is the union of the device events' intervals, so overlapping work on
two streams counts once, and the idle share is what the union leaves of the
window's wall time.
"""
from __future__ import annotations

from collections import defaultdict

DISPATCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                     "cuMemset")


def device_events(events):
    return [e for e in events if e[0] == "device"]


def dispatches(events) -> int:
    return sum(1 for e in events
               if e[0] == "host" and e[1].startswith(DISPATCH_PREFIXES))


def device_us(events) -> float:
    """The device events' durations summed, us."""
    return float(sum(e[3] - e[2] for e in device_events(events)))


def busy_intervals(events):
    """The union of the device events' intervals, sorted, disjoint."""
    spans = sorted((e[2], e[3]) for e in device_events(events))
    out = []
    for s, t in spans:
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return [tuple(x) for x in out]


def busy_us(events, window=None) -> float:
    """Microseconds in which some operation ran on the card, within
    ``window`` (start_us, end_us) when given."""
    total = 0.0
    for s, t in busy_intervals(events):
        if window is not None:
            s, t = max(s, window[0]), min(t, window[1])
        total += max(0.0, t - s)
    return total


def idle_share(events, window) -> float:
    """1 minus the busy union over the window's wall time."""
    span = window[1] - window[0]
    return 1.0 - busy_us(events, window) / span


NAME_CHARS = 120  # a kernel's templated name, cut to its first characters


def top_device_ops(events, n=10):
    """The device operations that took most time, summed by name (cut to
    ``NAME_CHARS``): [[name, seconds], ...]."""
    by = defaultdict(float)
    for e in device_events(events):
        by[e[1][:NAME_CHARS]] += e[3] - e[2]
    return [[k, v / 1e6] for k, v in sorted(by.items(),
                                             key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, window, n=10):
    """The card's idle time in ``window`` by what the host was doing: each
    gap between busy intervals is named after the innermost host call that
    covers its middle (the shortest host event around it, or "no host call"),
    and the gaps are summed by name: [[name, seconds], ...], largest first."""
    busy = busy_intervals(events)
    gaps, prev = [], window[0]
    for s, t in busy:
        if s > prev:
            gaps.append((prev, min(s, window[1])))
        prev = max(prev, t)
    if prev < window[1]:
        gaps.append((prev, window[1]))
    host = sorted((e[2], e[3], e[1]) for e in events if e[0] == "host")
    by = defaultdict(float)
    active, i = [], 0
    for s, t in gaps:  # in time order: sweep the host calls once
        if t <= s:
            continue
        mid = 0.5 * (s + t)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        best = min(active, key=lambda h: h[1] - h[0], default=None)
        by[best[2] if best else "no host call"] += t - s
    return [[k, v / 1e6] for k, v in sorted(by.items(),
                                             key=lambda kv: -kv[1])[:n]]
