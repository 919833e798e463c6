"""The share of the offline window in which no operation ran on the card,
from the ``torch.profiler`` trace (the union of device operations)."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_ns / t.window_ns)
