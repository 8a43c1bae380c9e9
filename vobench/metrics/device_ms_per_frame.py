"""Device events (kernels, copies, fills) of the traced window, each
counted once and summed, ms per frame (per sequence-frame in lockstep)."""
from vobench.reference import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not tr.device_events(t.events):
        return None
    return tr.device_us(t.events) / 1e3 / t.frames
