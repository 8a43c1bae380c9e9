"""Host runtime calls that queue work on the card (``cudaLaunch*``,
``cudaGraphLaunch``, ``cudaMemcpy*``, ``cudaMemset*``) in the traced
window, per frame (per sequence-frame in lockstep)."""
from vobench.reference import trace as tr


def read(ctx):
    t = ctx.trace
    if t is None or not tr.device_events(t.events):
        return None
    return tr.dispatches(t.events) / t.frames
