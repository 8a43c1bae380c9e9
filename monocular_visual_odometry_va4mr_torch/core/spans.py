"""Spans and counters of the port: where the host's time goes, layer by
layer, and what the layers did.

``span(name, **attrs)`` marks a stretch of host time: ``with
span("vo.chunk", K=8):``.  Recording is off unless ``start()`` turned it
on; off, ``span`` returns one shared object whose ``with`` does nothing (no
record, no clock read, no CUDA call).  On, each span appends ``(id,
parent_id, name, start_ns, end_ns, attrs)`` to a list in memory, its parent
the innermost span open on the same thread (-1 for none), and ``stop()``
turns recording off and returns the list.
The stamps are ``time.time_ns()``: the Unix-epoch clock on which
``torch.profiler`` stamps its events, so a span sits on a device trace's
axis after subtracting the trace's ``kineto_results.trace_start_ns()``
(within ``CLOCK_US``).  Nothing is written to a file: the caller keeps the
records.  ``trace_events`` reads a profiler's events as plain data, each
device event linked to the runtime call that queued it.

The spans, by layer (PERF.md section 3 names the metric each feeds):

* driver loop, ``pipeline/scan_driver.run_streaming``: ``stream.block``
  (``block``, ``frames``), ``stream.stack`` (stacking a block into pinned
  memory and drawing its banks), ``stream.readback``, ``stream.recover``;
* per-frame runner, ``pipeline/runner.run_sequence``: ``runner.frame``
  (``frame``), ``runner.sync``, ``runner.record``, ``runner.snapshot``,
  ``runner.recover``, ``runner.on_frame`` (the caller's callback);
* pipeline step, ``pipeline/vo.py``: ``vo.step``, ``vo.chunk`` (``K``,
  ``ba``), each with ``vo.load`` (the state and inputs copied in),
  ``graph.replay`` and ``vo.out`` (the outputs copied out, the state
  cloned) on the card;
* bootstrap: ``vo.bootstrap``, a ``graph.replay`` a piece on the card;
* graphs, ``core/graphs.py``: ``graph.replay`` (``key``, ``segments``)
  with a ``graph.host_wait`` for each library call run between its
  segments;
* step stages, ``VisualOdometry._step_body`` and the packs of a step's
  graph: ``stage.klt``, ``stage.pnp``, ``stage.retri``,
  ``stage.triangulate``, ``stage.detect``, ``stage.ring`` (the frame
  pushed into the BA ring), ``stage.ba`` (the in-step BA, on a BA frame
  only), ``stage.pack``.  A replay runs no Python inside the graph: these
  run while a body runs op by op (the CPU, a capture's warm-up,
  ``StepGraphs.stage_map``).

``COUNTS`` is always on, as ``parallel.multihost.COMM`` is: what the
layers did, from values the host knows (shapes, flags, branches), never
from a device read.  ``steps`` (frames stepped by ``step`` and
``step_chunk``), ``chunks``, ``bootstraps``, ``bootstrap.hops``,
``recover.attempts`` (re-bootstraps tried), ``recover.done``,
``h2d.bytes`` and ``d2h.bytes`` (the copies between the host and the
card the drivers and graphs make), ``host.syncs`` (synchronizes and
blocking reads on the card).  A caller reads deltas: ``Counter(COUNTS)``
before, ``COUNTS - before`` after.
"""
from __future__ import annotations

import collections
import functools
import threading
import time

COUNTS: collections.Counter = collections.Counter()

clock = time.time_ns
CLOCK_US = 20.0  # how far a span's stamp may sit from the profiler's, us
RUNTIME = ("cuda", "cu")  # the CUDA runtime and driver calls' prefixes

_records = None  # the list spans append to, while recording
_mirror = False  # each span also a torch.profiler range (stage_map)
_open = threading.local()  # per thread: the ids of the spans open


class _Off:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "rec", "ctx")

    def __init__(self, name, attrs):
        self.name, self.attrs, self.ctx = name, attrs, None

    def __enter__(self):
        if _mirror:
            import torch

            self.ctx = torch.profiler.record_function(self.name)
            self.ctx.__enter__()
        stack = _stack()
        self.rec = [len(_records), stack[-1] if stack else -1, self.name,
                    0, 0, self.attrs]
        _records.append(self.rec)
        stack.append(self.rec[0])
        self.rec[3] = clock()
        return self

    def __exit__(self, *exc):
        self.rec[4] = clock()
        _stack().pop()
        if self.ctx is not None:
            self.ctx.__exit__(*exc)
        return False


def _stack() -> list:
    s = getattr(_open, "ids", None)
    if s is None:
        s = _open.ids = []
    return s


def span(name: str, **attrs):
    """A span of the host's time named ``name`` (see the module's list),
    recorded while ``start()`` is in force; the shared no-op otherwise."""
    if _records is None:
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """A decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def start(mirror: bool = False) -> None:
    """Turn recording on, with no record yet; raises if it is on.
    ``mirror``: each span is a ``torch.profiler.record_function`` range
    too, so a profiler's own events carry it on the profiler's clock
    (``pipeline.vo.StepGraphs.stage_map``)."""
    global _records, _mirror
    if _records is not None:
        raise RuntimeError("spans are already recording")
    _open.ids = []
    _records, _mirror = [], bool(mirror)


def stop() -> list:
    """Turn recording off and return the records: ``(id, parent_id, name,
    start_ns, end_ns, attrs)``, each ``id`` its index, in the order the
    spans were entered; a span still open has ``end_ns`` 0."""
    global _records, _mirror
    out, _records, _mirror = _records or [], None, False
    return [tuple(r) for r in out]


def h2d(nbytes: int) -> None:
    """Count a copy of ``nbytes`` from the host to the card."""
    COUNTS["h2d.bytes"] += nbytes


def d2h(nbytes: int, reads: int = 1) -> None:
    """Count ``reads`` blocking reads of ``nbytes`` in all from the card to
    the host."""
    COUNTS["d2h.bytes"] += nbytes
    COUNTS["host.syncs"] += reads


def trace_events(events, t0_ns: int = 0):
    """A profiler's ``kineto_results.events()`` as plain data on one axis:
    ``(events, links, streams)``.  ``events``: ``(kind, name, start_us,
    end_us)`` each, us after ``t0_ns`` (the trace's ``trace_start_ns()``),
    ``kind`` "device" (a kernel, copy or fill on the card), "host" (an
    operator or a CUDA runtime or driver call) or "range" (a
    ``record_function`` range, as ``start(mirror=True)`` makes; the ranges'
    device-side shadows are left out).  ``links``: {index of a device
    event: index of the runtime or driver call that queued it}, by the
    profiler's correlation id.  ``streams``: {index of a device event: its
    stream}."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out, calls, device, streams = [], {}, [], {}
    for e in events:
        on_card = e.device_type() == cuda
        if e.is_user_annotation():
            if on_card:
                continue
            kind = "range"
        elif on_card:
            kind = "device"
            device.append((len(out), e.correlation_id()))
            streams[len(out)] = e.device_resource_id()
        else:
            kind = "host"
            if e.name().startswith(RUNTIME):
                calls[e.correlation_id()] = len(out)
        out.append((kind, e.name(), (e.start_ns() - t0_ns) / 1e3,
                    (e.end_ns() - t0_ns) / 1e3))
    links = {d: calls[c] for d, c in device if c in calls}
    return out, links, streams
