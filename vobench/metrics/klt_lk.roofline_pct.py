"""``klt_lk``'s share of its roofline over the traced window, %: the
least time of each call (``reference/roofline.call_bound_ms``: bytes read
once, rows in and out, from the call's shapes: the configuration's
landmark and candidate capacities, which every call of the step tracks) summed
over the window's ``klt_lk`` kernels, over the sum of their device
durations.  Against the H100 SXM's published 3.35 TB/s at 700 W; the
card's power limit is on the run's ``vobench.card`` line."""
from vobench.reference import roofline, trace as tr

KERNEL = "klt_lk_kernel"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    calls = [e for e in tr.device_events(t.events) if KERNEL in e[1]]
    if not calls:
        return None
    cap = ctx.config["pipeline"]["capacity"]
    n = cap["max_landmarks"] + cap["max_candidates"]
    spent_ms = sum(e[3] - e[2] for e in calls) / 1e3
    return 100.0 * len(calls) * roofline.call_bound_ms(n) / spent_ms
