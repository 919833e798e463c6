"""Device time an arrival of the stream (``serve/stream.py::
StreamSearchEngine.ingest`` → ``search/streaming.py::ingest_chunk``): every
device operation of the traced window, summed, over the arrivals served."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.run.served() == 0:
        return None
    return sum(t.by_name.values()) / 1e6 / ctx.run.served()
