"""Device events of the live cell's traced passes, summed, ms per timed
frame (each traced pass's bootstrap included: the runner bootstraps every
pass)."""
from vobench.reference import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not tr.device_events(t.events):
        return None
    return tr.device_us(t.events) / 1e3 / t.frames
