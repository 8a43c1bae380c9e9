"""Frames the timed path completed in the window, over all sequences, per
second of the window's wall time (host clock)."""


def read(ctx):
    if not ctx.frames or ctx.window_s <= 0:
        return None
    return ctx.frames / ctx.window_s
