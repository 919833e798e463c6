"""Spans and counters inside the port's search, in memory, off by default.

``recording()`` turns recording on for its block and yields the
:class:`Recording`. Outside one, :func:`span` and :func:`count` cost one
global check and return at once: no allocation, no device operation, no
sync. There is no environment variable, flag or exporter: a caller (a
benchmark, a test) turns recording on and reads the recording.

A span is ``(name, start_ns, end_ns, parent, search_id)``. Times are
``now_ns`` (``time.time_ns``), the epoch clock ``torch.profiler`` stamps
device activity with, so device time goes to a span by overlap.
``parent`` is the index of the enclosing span in ``Recording.spans``, or
-1. A ``search`` span opens a new search id, which every span under it
carries; a span outside any search (a stream's rounds) carries -1.
Spans are listed in the order they opened, and nest by that order: a
recording follows one thread (the port's search runs on one).

A counter maps a name to the values counted, one a call. A value may be
a device tensor: it is kept, and summed and read (``.item()``) only when
the recording ends, so counting adds no operation and no sync inside the
recorded window.

The search's spans (``search/multi.py``, ``search/subsequence.py``,
``search/pipeline.py``)::

    search                  the whole call, guards included
    ├─ prepare_ref, prepare_queries, cascade
    ├─ host_rounds          self time: the warm prepass and the first
    │  │                    ``any(active)`` sync, which waits for stage 1
    │  │                    and the cascade on the device
    │  └─ round             one a loop iteration; self time: its sync
    │     └─ round.issue    the top of the iteration to the sync
    └─ persistent_sweep     (``rounds="persistent"``)

A stream's ingests (``run_stream_ingest``) record their ``round`` and
``round.issue`` spans only, outside any search.

Counters, one value a driver call: ``host_rounds.live_lanes`` (the
rounds' live-lane masks, added up on the device, one add a round) and
``host_rounds.lanes_launched`` (Q × batch × the rounds);
``host_rounds.graph_captures`` (1 where the round loop captured its round
as a CUDA graph) and ``host_rounds.graph_rounds`` (the rounds it ran by
replaying it), on the card only; ``cascade.pruned``
(``SearchStats.lb_pruned``) and ``cascade.windows`` (Q × the windows).
A replayed round keeps its ``round`` and ``round.issue`` spans: the replay
is the issue, and the sync closes it.
"""
from __future__ import annotations

import contextlib
import time

now_ns = time.time_ns

SEARCH = "search"

_OFF = contextlib.nullcontext()
_current: Recording | None = None


class Recording:
    """The spans and counters recorded while ``recording()`` was on."""

    def __init__(self):
        self.spans: list[tuple[str, int, int, int, int]] = []
        self.counters: dict[str, list] = {}
        self.n_searches = 0
        self._open: list[int] = []

    def count(self, name: str, value) -> None:
        self.counters.setdefault(name, []).append(value)

    def _read_counters(self) -> None:
        for values in self.counters.values():
            values[:] = [v.sum().item() if hasattr(v, "item") else v
                         for v in values]


class _Span:
    """One span of a recording, as a context manager (a class, which costs
    less to enter than a generator: a recording opens two a round)."""

    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        opened = rec._open
        parent = opened[-1] if opened else -1
        if self.name == SEARCH:
            search_id = rec.n_searches
            rec.n_searches += 1
        else:
            search_id = rec.spans[parent][4] if parent >= 0 else -1
        self.i = len(rec.spans)
        opened.append(self.i)
        rec.spans.append((self.name, now_ns(), -1, parent, search_id))

    def __exit__(self, *exc):
        end = now_ns()
        rec = self.rec
        rec._open.pop()
        name, start, _, parent, search_id = rec.spans[self.i]
        rec.spans[self.i] = (name, start, end, parent, search_id)


def span(name: str):
    """A context manager that records the span ``name`` while a recording
    is on, and does nothing otherwise."""
    rec = _current
    if rec is None:
        return _OFF
    return _Span(rec, name)


def on() -> bool:
    """Whether a recording is on (for a count that takes work to make)."""
    return _current is not None


def count(name: str, value) -> None:
    """Add ``value`` (an int or a tensor, summed when read) to the counter
    ``name`` while a recording is on."""
    rec = _current
    if rec is not None:
        rec.count(name, value)


@contextlib.contextmanager
def recording():
    """Record every span and counter of the block; yields the
    :class:`Recording`, whose counters are read when the block ends."""
    global _current
    rec, outer = Recording(), _current
    _current = rec
    try:
        yield rec
    finally:
        _current = outer
        rec._read_counters()
