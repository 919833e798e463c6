"""The persistent sweep's share of its roofline: the least time of the
window's least work (as ``dp_row_roofline``) over kernel C's device time
(``persistent_sweep`` and its set-up and finish launches), both summed over
the window."""

KERNEL_C = ("persistent_sweep", "persistent_init", "persistent_finish",
            "count_bad_starts")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ns = t.kernel_ns(*KERNEL_C)
    if ns == 0:
        return None
    return 100.0 * ctx.least_work["bound_ms"] / (ns / 1e6)
