"""A traced pass with the program's spans, as the plain data
``reference/spans.py`` reads: the profiler's events from its kineto
records (the 4-tuples of ``profiling.finish``, on the same axis), the link
from each device event to the host call that queued it and each device
event's stream (the program's ``core.spans.trace_events``), and the
program's spans (``monocular_visual_odometry_va4mr_torch.core.spans``)
moved onto the trace's axis.  Both stamp the Unix-epoch clock in ns: an
event's ``us`` is its ns less ``kineto_results.trace_start_ns()``, over
1000."""
from __future__ import annotations


def trace_start_ns(prof) -> int:
    return prof.profiler.kineto_results.trace_start_ns()


def read(prof, records):
    """(events, links, streams, spans) of a profiler that
    ``profiling.start`` began and ``profiling.stop`` ended, and the records
    ``spans.stop()`` returned over the same pass."""
    from monocular_visual_odometry_va4mr_torch.core import spans

    t0 = trace_start_ns(prof)
    events, links, streams = spans.trace_events(
        prof.profiler.kineto_results.events(), t0)
    return events, links, streams, on_axis(records, t0)


def on_axis(records, t0_ns):
    """The spans' records with their stamps in us after ``t0_ns``."""
    return [(i, parent, name, (s - t0_ns) / 1e3, (e - t0_ns) / 1e3, attrs)
            for i, parent, name, s, e, attrs in records]
