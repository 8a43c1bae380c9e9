"""Arithmetic on a traced pass with the program's spans: where the card's
idle time and its device time go, program span by program span, and the
step's device time stage by stage.  Plain data only, as ``trace.py``:

* ``events``: ``(kind, name, start_us, end_us)`` tuples, kind "device" or
  "host";
* ``links``: ``{index of a device event: index of the host call that
  queued it}`` (the profiler's correlation ids, ``vobench/spantrace.py``);
* ``streams``: ``{index of a device event: its stream}``;
* ``spans``: the program's records (``core/spans.py``) on the same axis,
  ``(id, parent_id, name, start_us, end_us, attrs)``;
* ``maps``: ``StepGraphs.stage_map()``, ``{graph key: [(device op name,
  stage), ...]}`` in launch order, and ``kind``, the function that names a
  replay's device ops as the map does;
* ``tol``: how far a host stamp may sit from the profiler's, us.

A gap of the card's is put down to the innermost program span around its
middle (the shortest; "no span" outside them), unless the innermost host
call there is the profiler's own (``PROFILER_CALLS``: its buffers), which
makes it the ``profiler``'s.  A device event is put down to the innermost
span around the start of the host call that queued it.  A replay of a step
or chunk graph is staged when its device events, in order, carry the names
of its key's stage map one for one; each then takes its stage.  The
stages' sum is held against the device time found without the links: every
device event on a staged replay's stream that starts between its first
linked event's start and its last one's end.
"""
from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np

from . import trace as tr

PROFILER_CALLS = ("Buffer Flush", "Activity Buffer Request")
STEP_SPANS = ("vo.step", "vo.chunk")


def innermost_names(spans, times):
    """For each of ``times`` (sorted), the name of the innermost span
    around it, or None: one sweep."""
    order = sorted(spans, key=lambda s: s[3])
    out, active, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][3] <= t:
            active.append(order[i])
            i += 1
        active = [s for s in active if s[4] >= t]
        best = min(active, key=lambda s: s[4] - s[3], default=None)
        out.append(best[2] if best else None)
    return out


def _gaps(events, window):
    gaps, prev = [], window[0]
    for s, t in tr.busy_intervals(events):
        if s > prev:
            gaps.append((prev, min(s, window[1])))
        prev = max(prev, t)
    if prev < window[1]:
        gaps.append((prev, window[1]))
    return [(s, t) for s, t in gaps if t > s]


def idle_by_span(events, window, spans):
    """The card's idle time in ``window``, us, by the program span under
    each gap: ``{name: us}``, with "profiler" and "no span"."""
    gaps = _gaps(events, window)
    mids = [0.5 * (s + t) for s, t in gaps]
    host = [(e[0], e[1], e[2], e[3]) for e in events if e[0] == "host"]
    calls = innermost_names([(0, -1, e[1], e[2], e[3], None) for e in host],
                            mids)
    names = innermost_names(spans, mids)
    by = defaultdict(float)
    for (s, t), call, name in zip(gaps, calls, names):
        if call and call.replace("_", " ") in PROFILER_CALLS:
            by["profiler"] += t - s
        else:
            by[name or "no span"] += t - s
    return dict(by)


def device_by_span(events, links, spans):
    """Device time, us, by the innermost span around the host call that
    queued each device event: ``{name: us}``, "no span" for calls outside
    every span and "unlinked" for events with no host call."""
    linked = sorted((events[h][2], d) for d, h in links.items())
    names = innermost_names(spans, [t for t, _ in linked])
    by = defaultdict(float)
    for (_, d), name in zip(linked, names):
        by[name or "no span"] += events[d][3] - events[d][2]
    for d, e in enumerate(events):
        if e[0] == "device" and d not in links:
            by["unlinked"] += e[3] - e[2]
    return dict(by)


def _inside(t0, t1, span, tol):
    return span[3] - tol <= t0 and t1 <= span[4] + tol


def launches_outside(events, spans, tol):
    """Host ``cudaGraphLaunch`` calls inside no ``graph.replay`` span (with
    ``tol`` us of the clocks' difference)."""
    replays = sorted((s for s in spans if s[2] == "graph.replay"),
                     key=lambda s: s[3])
    starts = [s[3] for s in replays]
    n = 0
    for e in events:
        if e[0] == "host" and e[1] == "cudaGraphLaunch":
            i = _last_at_or_before(starts, e[2] + tol)
            if i < 0 or not _inside(e[2], e[3], replays[i], tol):
                n += 1
    return n


def _last_at_or_before(sorted_values, x):
    lo, hi = 0, len(sorted_values)
    while lo < hi:
        mid = (lo + hi) // 2
        if sorted_values[mid] <= x:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1


def extent_us(events, streams, groups):
    """Device time, us, of every device event on the stream of a group's
    events (``streams``; one stream for all where it is None) that starts
    from the group's first start to its last end: for each group of device
    event indices, what the card ran in its span, found without links."""
    per = defaultdict(list)
    for d, e in enumerate(events):
        if e[0] == "device":
            per[streams.get(d) if streams else None].append(
                (e[2], e[3] - e[2]))
    index = {}
    for k, v in per.items():
        v = np.array(sorted(v), dtype=np.float64).reshape(-1, 2)
        index[k] = (v[:, 0], np.concatenate([[0.0], np.cumsum(v[:, 1])]))
    total = 0.0
    for ds in groups:
        by = defaultdict(list)
        for d in ds:
            by[streams.get(d) if streams else None].append(events[d])
        for k, es in by.items():
            starts, cum = index[k]
            lo, hi = np.searchsorted(starts, [min(e[2] for e in es),
                                              max(e[3] for e in es)])
            total += float(cum[hi] - cum[lo])
    return total


def stage_split(events, links, spans, maps, *, tol, kind=str,
                streams=None):
    """The step's device time by stage, over every replay of a step or
    chunk graph (a ``graph.replay`` span inside ``vo.step`` / ``vo.chunk``):
    the device events queued by the ``cudaGraphLaunch`` calls in it, in the
    order they started, against its key's map.

    Returns ``stage_us`` ({stage: us} of the staged replays), ``replay_us``
    (the linked device time of every such replay), ``extent_us`` (the
    device time in the staged replays' extents, ``extent_us()``: equal to
    the stages' sum unless the links miss a device event), ``unlinked_us``
    (the pass's device time with no host call), ``frames`` (frames the
    staged replays stepped: a chunk's K, a step's 1), ``ba_frames`` (the
    BA frames among them, from the parent span's ``ba``), ``staged``,
    ``unstaged`` and ``differ`` (for each unstaged replay its key, the
    replay's and the map's lengths, the first index whose name differs,
    three names from there on each side, and the names the replay has more
    and fewer of than the map).  A replay's names compare by ``kind``."""
    by_id = {s[0]: s for s in spans}
    replays = sorted((s for s in spans if s[2] == "graph.replay"
                      and s[1] in by_id and by_id[s[1]][2] in STEP_SPANS),
                     key=lambda s: s[3])
    starts = [s[3] for s in replays]
    queued = defaultdict(list)  # replay index -> device event indices
    for d, h in links.items():
        e = events[h]
        if e[1] != "cudaGraphLaunch":
            continue
        i = _last_at_or_before(starts, e[2] + tol)
        if i >= 0 and _inside(e[2], e[3], replays[i], tol):
            queued[i].append(d)
    out = dict(stage_us=defaultdict(float), replay_us=0.0, frames=0,
               ba_frames=0, staged=0, unstaged=0, differ=[])
    groups = []
    for i, r in enumerate(replays):
        ds = sorted(queued[i], key=lambda d: events[d][2])
        us = [events[d][3] - events[d][2] for d in ds]
        out["replay_us"] += sum(us)
        key = r[5].get("key")
        want = maps.get(key)
        names = [kind(events[d][1]) for d in ds]
        mapped = [n for n, _ in want or ()]
        if want is None or names != mapped:
            out["unstaged"] += 1
            first = next((k for k, (a, b) in enumerate(zip(names, mapped))
                          if a != b), min(len(names), len(mapped)))
            extra = (Counter(names) - Counter(mapped)).most_common(3)
            missing = (Counter(mapped) - Counter(names)).most_common(3)
            out["differ"].append([str(key), len(names), len(mapped), first,
                                  names[first:first + 3],
                                  mapped[first:first + 3], extra, missing])
            continue
        parent = by_id[r[1]]
        out["staged"] += 1
        out["frames"] += parent[5].get("K", 1)
        ba = parent[5].get("ba", False)
        out["ba_frames"] += int(ba) if isinstance(ba, bool) else int(sum(ba))
        for t, (_, stage) in zip(us, want):
            out["stage_us"][stage or "none"] += t
        groups.append(ds)
    out["stage_us"] = dict(out["stage_us"])
    out["extent_us"] = extent_us(events, streams, groups)
    out["unlinked_us"] = sum(e[3] - e[2] for d, e in enumerate(events)
                             if e[0] == "device" and d not in links)
    return out


def device_inside(events, links, spans, name):
    """Device time, us, of the work queued by host calls inside any span
    called ``name`` (at any depth), and how many such spans there are."""
    outer = sorted((s[3], s[4]) for s in spans if s[2] == name)
    starts = [s for s, _ in outer]
    total = 0.0
    for d, h in links.items():
        t = events[h][2]
        i = _last_at_or_before(starts, t)
        if i >= 0 and t <= outer[i][1]:
            total += events[d][3] - events[d][2]
    return total, len(outer)


def metrics(events, window, links, spans, maps, frames, *, tol, kind=str,
            streams=None):
    """The five per-layer numbers of a traced pass of ``frames`` frames
    (None where the pass has nothing to read): ``pnp_device_ms_per_frame``,
    ``ba_branch_device_ms``, ``driver_idle_ms_per_frame``,
    ``runner_idle_ms_per_frame``, ``bootstrap_device_ms``."""
    split = stage_split(events, links, spans, maps, tol=tol, kind=kind,
                        streams=streams)
    idle = idle_by_span(events, window, spans)
    boot_us, boots = device_inside(events, links, spans, "vo.bootstrap")

    present = {s[2] for s in spans}

    def idle_ms(keep):
        if not frames or not any(keep(k) for k in present):
            return None
        return sum(v for k, v in idle.items() if keep(k)) / 1e3 / frames

    return dict(
        pnp_device_ms_per_frame=(
            split["stage_us"].get("stage.pnp", 0.0) / 1e3 / split["frames"]
            if split["frames"] else None),
        ba_branch_device_ms=(
            split["stage_us"].get("stage.ba", 0.0) / 1e3 / split["ba_frames"]
            if split["ba_frames"] else None),
        driver_idle_ms_per_frame=idle_ms(lambda k: k.startswith("stream.")),
        runner_idle_ms_per_frame=idle_ms(
            lambda k: k.startswith("runner.") and k != "runner.on_frame"),
        bootstrap_device_ms=boot_us / 1e3 / boots if boots else None)
