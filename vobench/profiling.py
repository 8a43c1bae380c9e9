"""``torch.profiler`` around the traced passes, its events turned into the
plain tuples ``reference/trace.py`` reads: (kind, name, start_us, end_us),
kind "device" for the card's kernels, copies and fills, "host" for the
runtime calls on the host.  Only the CUDA activity is traced (the runtime
calls and the device's work; recording every torch operator on the host
as well slowed the traced passes by 30% against 23%), so the traced window
is the span of its events: the profiler starts right before the first
traced pass and stops right after the last one's read-back."""
from __future__ import annotations


def start():
    import torch

    act = torch.profiler.ProfilerActivity
    # Off the card (the CPU tests) the host's activity keeps the profiler
    # running; it records no device event.
    prof = torch.profiler.profile(activities=[
        act.CUDA if torch.cuda.is_available() else act.CPU])
    prof.__enter__()
    return prof


def stop(prof) -> None:
    prof.__exit__(None, None, None)


def finish(prof):
    """(events, (start_us, end_us) of the window) of a profiler that
    ``start`` began and ``stop`` ended; (events, None) with no event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = []
    for e in prof.events():
        kind = "device" if e.device_type == cuda else "host"
        if kind == "device" and getattr(e, "is_user_annotation", False):
            continue  # a span's shadow on the device's timeline, no work
        tr = e.time_range
        events.append((kind, e.name, float(tr.start), float(tr.end)))
    if not events:
        return events, None
    return events, (min(e[2] for e in events), max(e[3] for e in events))
