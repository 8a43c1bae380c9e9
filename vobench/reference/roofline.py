"""The card's published peaks and the least time of a ``klt_lk`` call: a
frozen copy of ``chip_smoke.py``'s ``bound_ms`` and its constants.

``call_bound_ms`` is the bound of a call from its shapes alone: ``n``
features (the configuration's landmark and candidate capacities, times the
batch), each pixel read once and each row written once, and the operations
of the template and the final residual with no Gauss-Newton iteration
counted, since a trace does not say how many each feature ran.  So it never
exceeds the time the card could take, and a share of it stays under 100%.
"""
from __future__ import annotations

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores.  Both assume the card's full power limit of 700 W.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Operation counts of one LK feature at win 15 (225 window pixels), the same
# for both kernels: a bilinear blend is 8 multiplies + 3 adds; the template
# takes 5 blends, 2 x (subtract, halve) for the gradients and 3
# multiply-adds for the structure tensor (65 per pixel); a Gauss-Newton
# iteration a blend, a difference and 2 multiply-adds (16 per pixel); the
# final residual a blend, a difference, an abs and an add (14 per pixel).
OPS_TEMPLATE_PX, OPS_ITER_PX, OPS_RESID_PX = 65, 16, 14
# Bytes of one feature, each pixel read once: the template block with its
# one-pixel gradient ring and the bilinear corner, (15 + 3)^2 px, and one
# (15 + 1)^2 search block, all float32.
BYTES_PIXELS = ((15 + 3) ** 2 + (15 + 1) ** 2) * 4
# ``klt_lk``'s rows: 8 float32 feature columns and a validity byte in, 5
# float32 columns out.
IN_ROW_BYTES = 8 * 4 + 1
OUT_ROW_BYTES = 5 * 4


def bound_ms(n, iters, in_row_bytes, out_row_bytes):
    """The least time the card could take for one call: the larger of the
    bytes over HBM bandwidth and the float32 operations over the f32 peak.
    ``iters``: (N,) iterations each feature ran before it froze."""
    px = 15 * 15
    ops = n * px * (OPS_TEMPLATE_PX + OPS_RESID_PX) + px * OPS_ITER_PX * int(
        np.sum(iters))
    nbytes = n * (BYTES_PIXELS + in_row_bytes + out_row_bytes)
    t_bytes = 1e3 * nbytes / PEAK_BYTES_S
    t_ops = 1e3 * ops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def call_bound_ms(n: int) -> float:
    """The least time of one ``klt_lk`` call over ``n`` features, from its
    shapes alone (no iteration counted)."""
    return bound_ms(n, np.zeros(0, np.int64), IN_ROW_BYTES, OUT_ROW_BYTES)[0]
