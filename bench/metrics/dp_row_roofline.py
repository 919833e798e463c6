"""The one-warp DP row's share of its roofline: the least time of the
window's least work (``bench/reference``: every window whose bound lies at
or below its query's answer, run against that answer with the cb bound,
9 flops a cell at the FP32 peak against its bytes at HBM's) over kernel A's
device time (``dtw_ea_fused_kernel``, the one-warp row of
``csrc/dtw_band.cuh``), both summed over the window."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    ns = t.kernel_ns("dtw_ea_fused_kernel<")
    if ns == 0:
        return None
    return 100.0 * ctx.least_work["bound_ms"] / (ns / 1e6)
