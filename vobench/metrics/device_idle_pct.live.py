"""1 minus the union of the device events' intervals over the traced
window's wall time in the live cell, %."""
from vobench.reference import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not tr.device_events(t.events):
        return None
    return 100.0 * tr.idle_share(t.events, t.window)
