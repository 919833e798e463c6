"""Streaming similarity search: the per-chunk incremental ingest (port of
``repro/search/streaming.py``).

A stream delivers the reference in chunks. This module is the incremental
frontend that ``serve/stream.py`` drives: it owns the buffering (the
carried ``length - 1`` boundary tail, the fixed-shape padding, the
stream-coordinate offsets) and hands each ingest's context to the shared
pipeline stages (``search.pipeline.run_stream_ingest``: prepare → cascade →
host rounds seeded with the carried incumbents):

  * **Boundary-local window stats**: one prefix-sum pass over the carried
    tail plus the new chunk gives the stats of exactly the windows that
    become valid with this chunk. The ``length - 1`` windows straddling the
    tail/chunk boundary appear in the ingest in which their last sample
    arrives, so no chunking of the stream can hide a window.
  * **LB cascade over the new windows only**: one launch of kernel B on the
    card for the Q standing queries over the newly valid starts.
  * **Carried-incumbent EAPrunedDTW rounds**: each query's incumbent
    ``ub[q]``, carried from every earlier chunk, seeds this ingest's
    best-first rounds (kernel A a round on the card, or kernel D with
    ``gather="slab"``). A query finished for this ingest rides along as
    dead lanes.

Every window is scanned once, in the ingest where it becomes valid, against
a monotone non-increasing incumbent, so the final per-query ``(distance,
start)`` equals the offline search over the concatenated stream for any
chunking, up to the float32 rounding of each side's window stats.

``repro`` jits each ingest and so has two forms: the raw form retraces per
distinct ``(tail, chunk)`` shape, and ``pad_to`` packs every ingest into one
static shape (the carried tail right-aligned in a ``(length - 1,)`` buffer,
the chunk in a ``(pad_to,)`` buffer, the windows over the buffers' garbage
prefix and padding masked with ``+inf`` bounds so they ride the rounds as
dead lanes). PyTorch runs eagerly, so both are plain functions here; the
fixed shape is kept because a captured CUDA graph of a round needs one.

Every entry point runs on CUDA unless ``device="cpu"`` is passed; with no
device and no CUDA it raises (``core.common.resolve_device``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import guards
from repro_torch.core.batch import _multi_batch
from repro_torch.core.common import resolve_device
from repro_torch.core.lower_bounds import cascade_keogh_cumulative
from repro_torch.search.incumbents import IncumbentState, fold_min, initial_state
from repro_torch.search.multi import as_float32
from repro_torch.search.pipeline import (
    MULTI_VARIANTS,
    PreparedQueries,
    make_plan,
    run_stream_ingest,
)
from repro_torch.search.znorm import znorm


class IngestResult(NamedTuple):
    """Per-ingest outcome: ``(Q,)`` tensors over the standing queries except
    ``quarantined``, a 0-d tensor (windows are query-independent). Counts
    are int64 (``repro``: int32)."""
    ub: torch.Tensor           # incumbents after this ingest (non-increasing)
    best: torch.Tensor         # stream-coordinate start of each best (-1: none)
    rounds: torch.Tensor       # batch rounds spent on this ingest
    lanes: torch.Tensor        # candidate lanes submitted this ingest
    quarantined: torch.Tensor  # newly valid windows the quarantine excluded


def _ingest_plan(length, window, variant, batch, band_width, chunk_lb,
                 rows_per_step, block_k, row_block, quarantine, gather,
                 slab_budget):
    """The ingest knobs as a validated pipeline plan: host rounds, no
    warm prepass (streaming never runs the persistent sweep)."""
    return make_plan(
        length=length, window=window, variant=variant, batch=batch,
        band_width=band_width, chunk=chunk_lb, rows_per_step=rows_per_step,
        block_k=block_k, row_block=row_block, rounds="host",
        quarantine=quarantine, warm_start=0, gather=gather,
        slab_budget=slab_budget, allowed_variants=MULTI_VARIANTS,
    )


def _result(state: IncumbentState, stats, n_quar) -> IngestResult:
    return IngestResult(ub=state.ub, best=state.best, rounds=stats.rounds,
                        lanes=stats.lanes, quarantined=n_quar)


def _ingest_impl(tail, chunk, pq, state0, offset: int, plan):
    """One raw-shape ingest: the context is the tail plus the chunk, and
    every one of its windows is new. ``offset`` is the stream coordinate
    of ``tail[0]``."""
    ctx = torch.cat([tail, chunk])
    keep = min(ctx.shape[0], plan.length - 1)
    new_tail = ctx[ctx.shape[0] - keep:]
    state, stats, n_quar = run_stream_ingest(plan, ctx, None, pq, state0,
                                             offset)
    return new_tail, _result(state, stats, n_quar)


def _ingest_impl_padded(tail_buf, tail_len: int, chunk_buf, chunk_len: int,
                        pq, state0, offset0: int, plan):
    """Fixed-shape ingest over ``(length - 1,)`` and ``(pad_to,)`` buffers.

    The last ``tail_len`` entries of ``tail_buf`` are the carried samples
    (right-aligned, so the real region ``[length - 1 - tail_len, length - 1
    + chunk_len)`` of the context is contiguous) and the first
    ``chunk_len`` of ``chunk_buf`` the chunk; windows touching the buffers'
    padding are masked invalid. ``offset0`` is the stream coordinate of
    ``tail_buf[0]`` (negative while the tail is short).
    """
    length = plan.length
    ctx = torch.cat([tail_buf, chunk_buf])
    starts = torch.arange(ctx.shape[0] - length + 1, device=ctx.device)
    valid = ((starts >= (length - 1) - tail_len)
             & (starts + length <= (length - 1) + chunk_len))
    state, stats, n_quar = run_stream_ingest(plan, ctx, valid, pq, state0,
                                             offset0)
    return _result(state, stats, n_quar)


def ingest_chunk(
    tail,
    chunk,
    queries_n,
    u,
    low,
    ub,
    best,
    offset: int,
    length: int,
    window: int,
    variant: str = "eapruned",
    batch: int = 64,
    band_width: int | None = None,
    chunk_lb: int = 4096,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    pad_to: int | None = None,
    quarantine: bool = True,
    chunk_index: int | None = None,
    gather: str = "fused",
    slab_budget: int | None = None,
    device=None,
) -> tuple[torch.Tensor, IngestResult]:
    """Advance Q standing queries over one stream chunk.

    The functional core of ``serve.stream.StreamSearchEngine``, which owns
    the state threading and the ring; arguments as ``repro``'s
    ``ingest_chunk`` (without ``backend``), plus ``device``. ``tail`` and
    ``chunk`` are raw stream samples; ``queries_n``/``u``/``low`` the
    z-normalized queries and their envelopes; ``ub``/``best`` the carried
    per-query incumbents; ``offset`` the stream coordinate of ``tail[0]``.
    Arrays and tensors are taken as float32 (``best`` int64) on the device.

    A call with ``len(tail) + len(chunk) < length`` (no newly valid window
    yet) is a no-op: the tail is extended and the incumbents come back
    unchanged, with zero rounds and lanes. ``pad_to`` selects the
    fixed-shape form (the chunk must be at most ``pad_to`` long); ``None``
    the raw form. ``quarantine`` excludes windows overlapping non-finite
    samples and counts them. A chunk longer than ``pad_to`` or a tail
    longer than ``length - 1`` raises ``core.guards.StreamStateError``
    with the stream position; malformed arrays raise ``SearchInputError``
    before any device work.

    Returns ``(new_tail, IngestResult)``; feed ``new_tail`` and the updated
    incumbents into the next call.
    """
    dev = resolve_device(device)
    guards.ensure_series(chunk, "chunk", ndim=1)
    guards.ensure_series(tail, "tail", ndim=1)
    t = int(tail.shape[0])
    c = int(chunk.shape[0])
    tail = as_float32(tail, dev)
    chunk = as_float32(chunk, dev)
    ub = as_float32(ub, dev)
    best = torch.as_tensor(best, device=dev).to(torch.int64)
    if t + c < length:
        # Zero newly valid windows: extend the tail, touch nothing else.
        zq = torch.zeros(ub.shape[0], dtype=torch.int64, device=dev)
        return torch.cat([tail, chunk]), IngestResult(
            ub=ub, best=best, rounds=zq, lanes=zq,
            quarantined=torch.zeros((), dtype=torch.int64, device=dev),
        )
    plan = _ingest_plan(length, window, variant, batch, band_width, chunk_lb,
                        rows_per_step, block_k, row_block, quarantine, gather,
                        slab_budget)
    pq = PreparedQueries(qn=as_float32(queries_n, dev), u=as_float32(u, dev),
                         low=as_float32(low, dev))
    state0 = IncumbentState(ub=ub, best=best)
    if pad_to is None:
        return _ingest_impl(tail, chunk, pq, state0, int(offset), plan)
    if c > pad_to:
        raise guards.StreamStateError(
            f"chunk length {c} > pad_to {pad_to}; split the chunk before "
            "ingesting (the fixed-shape trace cannot grow)",
            n_seen=offset + t, chunk_index=chunk_index,
        )
    if t > length - 1:
        raise guards.StreamStateError(
            f"carried tail length {t} overflows length - 1 = {length - 1}; "
            "the stream state is corrupt (tail must never outgrow the "
            "boundary context)",
            n_seen=offset + t, chunk_index=chunk_index,
        )
    tail_buf = torch.cat([tail.new_zeros(length - 1 - t), tail])
    chunk_buf = torch.cat([chunk, chunk.new_zeros(pad_to - c)])
    res = _ingest_impl_padded(
        tail_buf, t, chunk_buf, c, pq, state0,
        int(offset) - (length - 1 - t),  # stream coordinate of tail_buf[0]
        plan,
    )
    keep = min(t + c, length - 1)
    new_tail = torch.cat([tail, chunk])[t + c - keep:]
    return new_tail, res


def rescore_windows(
    windows,
    starts,
    queries_n,
    u,
    low,
    ub,
    best,
    *,
    window: int,
    variant: str = "eapruned",
    band_width: int | None = None,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold k explicitly given windows into the carried incumbents.

    The re-admission launch (DESIGN.md §2.7): when a quarantined window is
    finite again after ``StreamSearchEngine.correct`` patched its bad
    samples, its raw samples come here as ``windows`` ``(k, length)`` with
    ``starts`` ``(k,)`` in stream coordinates. Each window is z-normalized
    directly and scored against all Q standing queries in one slab round
    (kernel D on the card, with the ``cb`` slab for ``eapruned``) under the
    carried incumbents. Returns the updated ``(ub, best)``; strict
    improvement only (``incumbents.fold_min``).
    """
    guards.ensure_series(windows, "windows", ndim=2)
    if variant not in MULTI_VARIANTS:
        raise guards.SearchInputError(
            f"variant must be one of {MULTI_VARIANTS}"
        )
    dev = resolve_device(device)
    qn = as_float32(queries_n, dev)
    nq = qn.shape[0]
    cand1 = znorm(as_float32(windows, dev))                 # (k, l)
    k = cand1.shape[0]
    cand = cand1[None].expand(nq, k, cand1.shape[1])
    cb = None
    if variant == "eapruned":
        cb = cascade_keogh_cumulative(cand, as_float32(u, dev)[:, None, :],
                                      as_float32(low, dev)[:, None, :])
    ub = as_float32(ub, dev)
    d = _multi_batch(
        qn, cand, ub[:, None].expand(nq, k), window=window,
        band_width=band_width, cb=cb, rows_per_step=rows_per_step,
        block_k=block_k, row_block=row_block,
    )
    starts = torch.as_tensor(starts, device=dev).to(torch.int64)
    best = torch.as_tensor(best, device=dev).to(torch.int64)
    state, _ = fold_min(IncumbentState(ub=ub, best=best),
                        starts[None].expand(nq, k), d)
    return state.ub, state.best


def initial_incumbents(
    nq: int, dtype=torch.float32, ub_init=None, device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh ``(ub, best)`` incumbent tensors for Q standing queries.

    ``ub_init`` optionally seeds the incumbents (scalar or ``(Q,)``), the
    cross-stream analogue of ``multi_query_search``'s warm seeds; ``best``
    is int64, -1 while unbeaten.
    """
    state = initial_state(nq, dtype, ub_init, device=resolve_device(device))
    return state.ub, state.best


class StreamIngestExecutor:
    """One stream's ingest bound as an executor-seam worker.

    The per-stream statics (normalized queries, envelopes, knobs, device)
    bind once at construction, and each ``run_ingest`` call advances one
    chunk of carried state. ``serve.stream.StreamSearchEngine`` can be
    pointed at any object with this method (a hedged executor wrapping
    several of these: ``search.pipeline.HedgedExecutor``). ``run_ingest``
    is a pure function of its arguments: all carried state rides in
    ``tail``/``ub``/``best``/``offset``, so a duplicate call is safe.
    """

    def __init__(
        self,
        queries_n,
        u,
        low,
        *,
        length: int,
        window: int,
        variant: str = "eapruned",
        batch: int = 64,
        band_width: int | None = None,
        chunk_lb: int = 4096,
        rows_per_step: int = 1,
        block_k: int = 8,
        row_block: int = 128,
        quarantine: bool = True,
        gather: str = "fused",
        slab_budget: int | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.queries_n = as_float32(queries_n, self.device)
        self.u = as_float32(u, self.device)
        self.low = as_float32(low, self.device)
        self.length = int(length)
        self.window = int(window)
        self.variant = variant
        self.batch = int(batch)
        self.band_width = band_width
        self.chunk_lb = int(chunk_lb)
        self.rows_per_step = int(rows_per_step)
        self.block_k = int(block_k)
        self.row_block = int(row_block)
        self.quarantine = bool(quarantine)
        self.gather = gather
        self.slab_budget = None if slab_budget is None else int(slab_budget)

    def run_ingest(
        self,
        tail,
        chunk,
        ub,
        best,
        offset: int,
        *,
        pad_to: int | None = None,
        chunk_index: int | None = None,
    ) -> tuple[torch.Tensor, IngestResult]:
        """Advance the carried stream state over one chunk (the seam call)."""
        return ingest_chunk(
            tail, chunk, self.queries_n, self.u, self.low, ub, best, offset,
            length=self.length, window=self.window, variant=self.variant,
            batch=self.batch, band_width=self.band_width,
            chunk_lb=self.chunk_lb, rows_per_step=self.rows_per_step,
            block_k=self.block_k, row_block=self.row_block, pad_to=pad_to,
            quarantine=self.quarantine, chunk_index=chunk_index,
            gather=self.gather, slab_budget=self.slab_budget,
            device=self.device,
        )
