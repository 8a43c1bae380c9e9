"""The 95th percentile of every timed frame's latency in the window: from
the frame's hand-over to the runner to its pose record on the host (host
clock, ``drivers/runner.py``)."""
import numpy as np


def read(ctx):
    if not ctx.latency_ms:
        return None
    return float(np.percentile(np.asarray(ctx.latency_ms), 95.0))
