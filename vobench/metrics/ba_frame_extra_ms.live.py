"""The mean latency of the window's frames that ran the in-step BA minus
the mean latency of its other frames, ms (host clock; the BA frames are
those after which the program's ``VisualOdometry.ba_runs`` counter moved;
the traced passes left out)."""
import numpy as np


def read(ctx):
    lat = np.asarray(ctx.latency_ms, np.float64)
    ba = np.asarray(ctx.ba_flags, bool)
    if lat.size == 0 or not ba.any() or ba.all():
        return None
    return float(lat[ba].mean() - lat[~ba].mean())
