"""Host time a round of the host round loop (``search/pipeline.py::
run_host_rounds``): the window's wall less the card's busy time, over the
rounds the window's searches ran (``MultiSearchResult.rounds``, the most
any query of a search ran, which is how often the loop went round)."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.run.traffic.get("rounds") != "host":
        return None
    rounds = ctx.run.rounds()
    if rounds == 0:
        return None
    return (t.window_ns - t.busy_ns) / 1e6 / rounds
