"""Device time a search of the plain PyTorch kernels (stage 1's window
statistics and envelopes, the cascade's sort, the round loop's gathers and
folds): every kernel in the trace that is not one of the port's hand
kernels, copies and sets left out, over the window's searches."""

# The port's hand-written kernels (``src/repro_torch/kernels/csrc``), by name.
HAND_KERNELS = ("dtw_ea_fused_kernel", "dtw_ea_fused_wide_kernel",
                "dtw_ea_slab_kernel", "dtw_ea_slab_wide_kernel",
                "persistent_sweep", "persistent_init", "persistent_finish",
                "count_bad_starts", "lb_cascade_kernel")


def read(ctx):
    t = ctx.trace
    if t is None or ctx.run.n_searches() == 0:
        return None
    return t.kernels_ns_except(HAND_KERNELS) / 1e6 / ctx.run.n_searches()
