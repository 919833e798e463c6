"""The cascade's share of its roofline: kernel B's least time from the
shapes (8 flops a (query, window, offset) term at the FP32 peak against the
bytes it reads and writes once, as ``chip_smoke.py`` reckons it), one launch
a search, over kernel B's device time (``lb_cascade_kernel``), both summed
over the window."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ns = t.kernel_ns("lb_cascade_kernel")
    if ns == 0:
        return None
    return 100.0 * ctx.run.lb_bound_ms() / (ns / 1e6)
