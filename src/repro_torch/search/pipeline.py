"""The staged search pipeline: SearchPlan → prepare → cascade → execute.

Port of ``repro/search/pipeline.py`` for offline and streaming search: the
``eapruned`` and ``eapruned_nolb`` variants under both round drivers and
both gather modes, with the ``EAInfo`` counters on the host rounds
(``with_info``), the ``full`` / ``pruned`` baselines
(``_baseline_search_impl``), and one streaming ingest
(``run_stream_ingest``: the same stages over one ingest's context, host
rounds seeded with the carried incumbents). Stages::

    SearchPlan (make_plan: validated knobs)
        ├─ prepare_ref      window stats + §2.6 quarantine mask/sanitize
        ├─ prepare_queries  z-norm + LB_Keogh envelopes
        ├─ cascade          LB_Kim/LB_Keogh per window (kernel B on CUDA),
        │                   +inf for quarantined windows, stable sort
        └─ execute          one of two drivers:
             run_host_rounds  best-first (Q × batch)-lane rounds: one call of
                              kernel A (gather="fused") or of kernel D on a
                              (Q, batch, l) slab (gather="slab") per round
             run_persistent   the whole best-first order in one launch:
                              kernel C (fused) or kernel E on the
                              (Q, n_win, l) slab (slab)

``repro`` runs the round loop as a ``lax.while_loop``; here it is a Python
loop around one round step (``_round_step``), which reads the loop's
state from buffers that keep their addresses for the call and writes the
next state back into them. Every round ends in the host reading
``any(active)``, the only host sync of a round (the round kernels check
their lanes on the device). On the card, a call that is still going after
``GRAPH_AFTER_ROUNDS`` eager rounds, and can run as many more, captures
the step once as a CUDA graph and replays it each later round, so the
host issues one graph launch a round instead of some forty operations.
On the CPU, and in calls that end sooner (a few-round search or stream
ingest), every round runs the step eagerly. The persistent sweep makes one host
sync, the out-of-range count of kernel C. The counters add up per query
in int64 (``repro`` adds them in int32, which a query at N = 1e6,
l = 1024 overflows); they are -1 when not collected.
Each offline stage, driver and round is a span of ``repro_torch.spans``,
and the drivers count live lanes and pruned windows there, while a
recording is on; a stream's ingests record their rounds only.

The executor seam (``Executor.run_range``) binds the offline core to one
workload and searches any window-start range of it from carried
incumbents: ``HostRoundsExecutor``, ``PersistentExecutor`` and
``HedgedExecutor``, which races a straggling attempt on a backup and
also wraps streaming ingest executors (``run_ingest``). The
fault-tolerant layer (``search.resilient``) schedules on it.

Sharded search (``make_sharded_search``, ``ShardedExecutor``) runs one
shard a rank of a ``torch.distributed`` group: ``repro``'s per-axis
``lax.pmin`` / ``pmax`` / ``psum`` are ``all_reduce``s with ``MIN`` /
``MAX`` / ``SUM``, and its ``lax.while_loop`` a Python loop that reads
the reduced continue flag once a round.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import NamedTuple, Protocol

import torch

from repro_torch import spans
from repro_torch.core import guards
from repro_torch.core.batch import (
    block_sweep,
    _batch,
    _multi_batch,
    _multi_batch_fused,
    ea_pruned_dtw_persistent,
    ea_pruned_dtw_persistent_fused,
)
from repro_torch.core.common import (
    BIG,
    DEAD_LANE_UB,
    as_float32,
    block_until_ready,
    pad_lanes_to_blocks,
    resolve_device,
)
from repro_torch.core.dtw import dtw_batch
from repro_torch.core.lower_bounds import cascade_keogh_cumulative, envelope
from repro_torch.core.pruned_dtw import pruned_dtw_batch
from repro_torch.distributed.fault_tolerance import (
    GUARD_ERRORS,
    TRANSIENT,
    StragglerMonitor,
    WorkerHealth,
    hedge_race,
)
from repro_torch.kernels import ops
from repro_torch.search.cascade import cascade_lower_bounds
from repro_torch.search.incumbents import (
    IncumbentState,
    fold_min,
    initial_state,
    merge_states,
)
from repro_torch.search.znorm import (
    gather_norm_windows,
    sanitize_series,
    window_finite_mask,
    window_stats,
    znorm,
)

VARIANTS = ("full", "pruned", "eapruned", "eapruned_nolb")
MULTI_VARIANTS = ("eapruned", "eapruned_nolb")
ROUND_DRIVERS = ("host", "persistent")
GATHER_MODES = ("fused", "slab")


@dataclass(frozen=True)
class SearchPlan:
    """Resolved, validated search knobs (``repro``'s names; its ``backend``
    knob has no counterpart: the port dispatches by device)."""
    length: int
    window: int
    variant: str = "eapruned"
    batch: int = 64
    band_width: int | None = None
    chunk: int = 4096
    rows_per_step: int = 1
    block_k: int = 8
    row_block: int = 128
    rounds: str = "host"
    quarantine: bool = True
    warm_start: int = 0
    gather: str = "fused"
    slab_budget: int | None = None

    @property
    def use_lb(self) -> bool:
        return self.variant != "eapruned_nolb"

    @property
    def use_cb(self) -> bool:
        return self.variant == "eapruned"

    def knobs(self) -> dict:
        """The batch-primitive keyword block (``core.batch`` tuning)."""
        return dict(
            rows_per_step=self.rows_per_step, block_k=self.block_k,
            row_block=self.row_block,
        )


def make_plan(
    *,
    length: int,
    window: int,
    variant: str = "eapruned",
    batch: int = 64,
    band_width: int | None = None,
    chunk: int = 4096,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    rounds: str = "host",
    quarantine: bool = True,
    warm_start: int = 0,
    gather: str = "fused",
    slab_budget: int | None = None,
    with_info: bool = False,
    allowed_variants: tuple[str, ...] = VARIANTS,
) -> SearchPlan:
    """Validate knobs into a :class:`SearchPlan` (``repro``'s checks)."""
    if variant not in allowed_variants:
        raise guards.SearchInputError(
            f"variant {variant!r} not in {allowed_variants}"
        )
    if rounds not in ROUND_DRIVERS:
        raise ValueError(f"rounds {rounds!r} not in {ROUND_DRIVERS}")
    if gather not in GATHER_MODES:
        raise guards.SearchInputError(
            f"gather {gather!r} not in {GATHER_MODES}"
        )
    if slab_budget is not None and int(slab_budget) <= 0:
        raise guards.SearchInputError("slab_budget must be positive bytes")
    if rounds == "persistent" and with_info:
        raise ValueError(
            "rounds='persistent' is counter-free; use the host driver for "
            "with_info stats rounds"
        )
    guards.ensure_knobs(
        length=length, window=window, batch=batch, band_width=band_width,
        block_k=block_k, row_block=row_block, rows_per_step=rows_per_step,
    )
    return SearchPlan(
        length=int(length), window=int(window), variant=variant,
        batch=int(batch), band_width=band_width, chunk=int(chunk),
        rows_per_step=int(rows_per_step), block_k=int(block_k),
        row_block=int(row_block), rounds=rounds, quarantine=bool(quarantine),
        warm_start=int(warm_start), gather=gather,
        slab_budget=None if slab_budget is None else int(slab_budget),
    )


def _ensure_slab_budget(plan: SearchPlan, n_lanes: int, what: str) -> None:
    """A slab must fit ``plan.slab_budget``; raises before any O(K·l)
    allocation. Fused paths never call this: not building the slab is the
    point."""
    if plan.slab_budget is None:
        return
    need = int(n_lanes) * int(plan.length) * 4  # float32 windows
    if need > plan.slab_budget:
        raise guards.SearchInputError(
            f"{what}: gather='slab' would materialize {need} bytes of "
            f"candidate windows ({n_lanes} lanes x {plan.length} samples) "
            f"but slab_budget={plan.slab_budget}; use gather='fused' or "
            "raise the budget"
        )


# ---------------------------------------------------------------------------
# prepare — window stats + §2.6 quarantine + query envelopes
# ---------------------------------------------------------------------------

class PreparedRef(NamedTuple):
    """Reference-side stage-1 products."""
    ref: torch.Tensor            # sanitized series (raw when quarantine off)
    mu: torch.Tensor             # (n_win,) per-window means
    sigma: torch.Tensor          # (n_win,) per-window raw stds
    valid: torch.Tensor | None   # (n_win,) surviving-window mask; None = all
    n_quar: torch.Tensor         # scalar: windows quarantined here


class PreparedQueries(NamedTuple):
    """Query-side stage-1 products."""
    qn: torch.Tensor   # (Q, l) z-normalized queries
    u: torch.Tensor    # (Q, l) upper LB_Keogh envelope
    low: torch.Tensor  # (Q, l) lower LB_Keogh envelope


def prepare_ref(plan: SearchPlan, ref: torch.Tensor, valid=None) -> PreparedRef:
    """Window stats + the §2.6 quarantine prepass.

    Windows overlapping a non-finite sample are masked out of ``valid`` and
    counted; the series is then zero-filled at the bad samples so the
    shared prefix sums stay finite for the surviving windows.
    """
    if plan.quarantine:
        finite_ok = window_finite_mask(ref, plan.length)
        if valid is None:
            n_quar = (~finite_ok).sum()
            valid = finite_ok
        else:
            n_quar = (valid & ~finite_ok).sum()
            valid = valid & finite_ok
        ref = sanitize_series(ref)
    else:
        n_quar = torch.zeros((), dtype=torch.int64, device=ref.device)
    mu, sigma = window_stats(ref, plan.length)
    return PreparedRef(ref=ref, mu=mu, sigma=sigma, valid=valid, n_quar=n_quar)


def prepare_queries(plan: SearchPlan, queries: torch.Tensor) -> PreparedQueries:
    """Z-normalize the workload's queries and build their envelopes."""
    qn = znorm(queries[:, : plan.length])
    u, low = envelope(qn, plan.window)
    return PreparedQueries(qn=qn, u=u, low=low)


# ---------------------------------------------------------------------------
# cascade — the one LB gate
# ---------------------------------------------------------------------------

def cascade(
    plan: SearchPlan, prep: PreparedRef, qn: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query lower bounds → best-first order, both ``(Q, n_win)``.

    Quarantined windows carry ``+inf`` bounds and sort behind every live
    one. The sort is stable (``jnp.argsort`` is): flat windows tie exactly,
    and the no-LB variant sorts a 0/``+inf`` mask, so ties must break by
    start index.
    """
    n_win = prep.mu.shape[0]
    nq = qn.shape[0]
    if plan.use_lb:
        lbs = cascade_lower_bounds(
            prep.ref, qn, prep.mu, prep.sigma, plan.length, plan.window,
            chunk=plan.chunk, valid=prep.valid,
        )
    elif prep.valid is not None:
        lbs = torch.where(prep.valid, 0.0, float("inf")).to(qn.dtype)
        lbs = lbs.expand(nq, n_win)
    else:
        order = torch.arange(n_win, device=qn.device).expand(nq, n_win)
        return order, torch.zeros((nq, n_win), dtype=qn.dtype, device=qn.device)
    lb_sorted, order = torch.sort(lbs, dim=1, stable=True)
    return order, lb_sorted


# ---------------------------------------------------------------------------
# host-rounds executor
# ---------------------------------------------------------------------------

class SearchStats(NamedTuple):
    """Per-query work accounting of one execution."""
    rounds: torch.Tensor     # (Q,) batch rounds
    lanes: torch.Tensor      # (Q,) candidate lanes submitted
    lb_pruned: torch.Tensor  # (Q,) candidates never evaluated (LB ordering)
    rows: torch.Tensor       # (Q,) DTW rows issued (-1: fast rounds)
    cells: torch.Tensor      # (Q,) admissible DTW cells (-1: fast rounds)


def _dtw_round_fused(plan, prep, pq, starts, ub_lanes, *, use_cb: bool,
                     with_info: bool = False):
    """One fused-gather EAPrunedDTW round over ``(Q, K)`` lane starts:
    kernel A slices and normalizes the windows itself. Returns the
    distances, or ``(distances, EAInfo)`` with ``with_info``."""
    return _multi_batch_fused(
        pq.qn, prep.ref, starts, ub_lanes, window=plan.window,
        mu=prep.mu, sigma=prep.sigma,
        envelopes=(pq.u, pq.low) if use_cb else None,
        band_width=plan.band_width, with_info=with_info, **plan.knobs(),
    )


def _dtw_round_slab(plan, prep, pq, starts, ub_lanes, *, use_cb: bool,
                    with_info: bool = False):
    """One slab EAPrunedDTW round: the windows gathered into a
    ``(Q, K, l)`` slab, with the ``cb`` slab beside it when ``use_cb``, for
    kernel D. Returns as :func:`_dtw_round_fused`."""
    cand = gather_norm_windows(prep.ref, starts, plan.length, prep.mu,
                               prep.sigma)
    cb = None
    if use_cb:
        cb = cascade_keogh_cumulative(cand, pq.u[:, None, :],
                                      pq.low[:, None, :])
    return _multi_batch(
        pq.qn, cand, ub_lanes, window=plan.window,
        band_width=plan.band_width, cb=cb, with_info=with_info,
        **plan.knobs(),
    )


def _dtw_round(plan, prep, pq, starts, ub_lanes, *, use_cb: bool,
               with_info: bool = False):
    """The plan's round (fused or slab): ``(d, EAInfo or None)``."""
    fn = _dtw_round_fused if plan.gather == "fused" else _dtw_round_slab
    out = fn(plan, prep, pq, starts, ub_lanes, use_cb=use_cb,
             with_info=with_info)
    return out if with_info else (out, None)


def _query_totals(info, nq: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query int64 ``(rows, cells)`` of a round's ``(Q, K)`` counters
    (zeros without counters)."""
    if info is None:
        z = torch.zeros(nq, dtype=torch.int64, device=dev)
        return z, z
    return (info.rows.sum(dim=1, dtype=torch.int64),
            info.cells.sum(dim=1, dtype=torch.int64))


def _dead_or(live: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    """Per-lane ub: the query's incumbent where ``live``, else the sentinel."""
    return torch.where(live, ub[:, None].expand(live.shape), DEAD_LANE_UB)


def warm_prepass(
    plan: SearchPlan,
    prep: PreparedRef,
    pq: PreparedQueries,
    order: torch.Tensor,
    lb_sorted: torch.Tensor,
    state0: IncumbentState,
    with_info: bool = False,
    offset=0,
):
    """Full-DP each query's ``min(warm_start, batch)`` best-LB candidates to
    seed the incumbents (changes work, not results). Returns
    ``(state, pre, rows_pre, cells_pre)``, the counters per query in int64
    (zeros without ``with_info``)."""
    nq, n_win = order.shape
    pre = min(int(plan.warm_start), plan.batch)
    if pre <= 0:
        return (state0, 0, *_query_totals(None, nq, order.device))
    if n_win < pre:
        order = torch.cat([order, order.new_zeros(nq, pre - n_win)], dim=1)
        lb_sorted = torch.cat(
            [lb_sorted, lb_sorted.new_full((nq, pre - n_win), float("inf"))],
            dim=1,
        )
    pre_starts = order[:, :pre]
    pre_lbs = lb_sorted[:, :pre]
    fin = torch.isfinite(pre_lbs)
    ub_pre = _dead_or(fin & (pre_lbs < state0.ub[:, None]), state0.ub)
    if plan.gather != "fused":
        _ensure_slab_budget(plan, nq * pre, "warm_prepass")
    d0, info0 = _dtw_round(plan, prep, pq, pre_starts, ub_pre, use_cb=False,
                           with_info=with_info)
    d0 = torch.where(fin, d0, float("inf"))
    state, _ = fold_min(state0, pre_starts, d0, offset=offset)
    return (state, pre, *_query_totals(info0, nq, order.device))


def run_host_rounds(
    plan: SearchPlan,
    prep: PreparedRef,
    pq: PreparedQueries,
    order: torch.Tensor,
    lb_sorted: torch.Tensor,
    state0: IncumbentState,
    *,
    with_info: bool = False,
    offset=0,
) -> tuple[IncumbentState, SearchStats]:
    """The host round driver: best-first ``(Q × batch)``-lane rounds.

    Per-query drop-out: a query leaves when it has no rounds left or its
    next batch's smallest lower bound can no longer beat its incumbent; a
    finished query's lanes ride along with the dead-lane sentinel. Within a
    live query's batch, lanes whose own bound reaches the incumbent are
    submitted dead too. With ``with_info`` every round is a counter round
    (kernel A's or D's counter variant) and each query's rows and cells add
    up in int64, its dead lanes included (one row each, as ``repro``
    counts them); without, they are -1. Every round is one
    :func:`_round_step`; on the card, once the call has run a few rounds
    (:func:`_capture_now`), a replay of it captured once
    (:class:`_RoundGraph`).
    """
    nq, n_win = order.shape
    batch = plan.batch
    dev = order.device
    state, pre, rows, cells = warm_prepass(
        plan, prep, pq, order, lb_sorted, state0, with_info=with_info,
        offset=offset,
    )

    n_rounds = -(-n_win // batch)
    pad = n_rounds * batch - n_win
    order_p = torch.cat([order, order.new_zeros(nq, pad)], dim=1)
    lb_p = torch.cat([lb_sorted, lb_sorted.new_full((nq, pad), float("inf"))],
                     dim=1)

    active = torch.ones(nq, dtype=torch.bool, device=dev)
    if plan.use_lb:
        active = lb_p[:, 0] < state.ub
    if plan.gather != "fused":
        _ensure_slab_budget(plan, nq * batch, "run_host_rounds")
    # ``lanes`` counts distinct candidates examined: round 0 re-submits the
    # prepass candidates, so the prepass stands alone only for a query that
    # never enters the round loop.
    st = _RoundState(
        r=torch.zeros(nq, dtype=torch.int64, device=dev),
        active=active,
        ub=state.ub.clone(),
        best=state.best.clone(),
        lanes=torch.where(active, 0, pre).to(torch.int64),
        rows=rows.clone() if with_info else None,
        cells=cells.clone() if with_info else None,
        # While a recording is on, each round's live lanes add up on the
        # device (one add a round) and are counted once, after the loop.
        live_lanes=(torch.zeros((nq, batch), dtype=torch.int64, device=dev)
                    if spans.on() else None),
        go=torch.empty((), dtype=torch.bool, device=dev),
    )
    cols = torch.arange(batch, device=dev)

    def step():
        _round_step(plan, prep, pq, order_p, lb_p, cols, n_rounds, st,
                    with_info=with_info, offset=offset)

    # The first rounds run eagerly (the first builds and loads the round
    # kernel, so the capture issues no set-up); a call still going once it
    # has run them captures its step and replays it from then on.
    graph = None
    n_iter = 0
    go = bool(st.active.any())
    while go:
        n_iter += 1
        with spans.span("round"):
            with spans.span("round.issue"):
                if graph is None and _capture_now(dev, n_iter, n_rounds):
                    graph = _RoundGraph(step, dev)
                if graph is None:
                    step()
                else:
                    graph.replay()
            go = bool(st.go)

    if graph is not None:
        spans.count("host_rounds.graph_rounds", graph.replays)
    rows, cells = st.rows, st.cells
    if not with_info:
        rows = cells = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    if st.live_lanes is not None:
        spans.count("host_rounds.live_lanes", st.live_lanes)
        spans.count("host_rounds.lanes_launched", nq * batch * n_iter)
    lb_pruned = n_win - torch.clamp_max(st.lanes, n_win)
    spans.count("cascade.pruned", lb_pruned)
    spans.count("cascade.windows", nq * n_win)
    return IncumbentState(ub=st.ub, best=st.best), SearchStats(
        rounds=st.r,
        lanes=st.lanes,
        lb_pruned=lb_pruned,
        rows=rows,
        cells=cells,
    )


# The round loop runs this many rounds eagerly before it captures its
# step, where the call can run as many more. A capture costs the host 1.4-
# 4.6 ms (2.0 at the median), and a replayed round saves 0.3-0.5 ms at
# l = 1024 and 0.46-0.59 ms at l = 128 (0.64-0.75 ms a round eager against
# 0.17-0.18 replayed, N = 1e6, Q = 8, on an H100); most calls that pass
# three rounds run many more, so the capture pays for itself, and a call
# that ends in fewer captures nothing (PERF.md §6: stream ingests, small
# searches, the short query).
GRAPH_AFTER_ROUNDS = 3


def _capture_now(dev: torch.device, n_iter: int, n_rounds: int) -> bool:
    """Whether the round loop captures its step before round ``n_iter``
    (from 1): on the card, once it has run ``GRAPH_AFTER_ROUNDS`` rounds
    eagerly, where it can still run as many more."""
    return (dev.type == "cuda" and n_iter == GRAPH_AFTER_ROUNDS + 1
            and n_rounds >= 2 * GRAPH_AFTER_ROUNDS)


@dataclass
class _RoundState:
    """The host round loop's state, in buffers that keep their addresses for
    the whole call: each round reads them and writes the next state back in
    place, so a captured round replays against them."""
    r: torch.Tensor                   # (Q,) int64 rounds run
    active: torch.Tensor              # (Q,) bool: the query runs this round
    ub: torch.Tensor                  # (Q,) incumbents
    best: torch.Tensor                # (Q,) their starts
    lanes: torch.Tensor               # (Q,) int64 candidates examined
    rows: torch.Tensor | None         # (Q,) int64, with the counters
    cells: torch.Tensor | None
    live_lanes: torch.Tensor | None   # (Q, batch) int64, while recording
    go: torch.Tensor                  # () bool: any query still active


def _round_step(plan, prep, pq, order_p, lb_p, cols, n_rounds: int,
                st: _RoundState, *, with_info: bool, offset) -> None:
    """One host round, in place on ``st``: gather each active query's next
    batch of candidates, run kernel A (or D) on its live lanes, fold the
    distances into the incumbents, and drop the queries that are done.
    Issues device work only: no host sync."""
    nq, batch = st.r.shape[0], plan.batch
    idx = torch.clamp_max(st.r, n_rounds - 1)[:, None] * batch + cols
    starts = order_p.gather(1, idx)
    lbs_b = lb_p.gather(1, idx)
    live = st.active[:, None] & (lbs_b < st.ub[:, None])
    if st.live_lanes is not None:
        st.live_lanes += live
    ub_lanes = _dead_or(live, st.ub)
    d, info = _dtw_round(plan, prep, pq, starts, ub_lanes,
                         use_cb=plan.use_cb, with_info=with_info)
    if with_info:
        rows_q, cells_q = _query_totals(info, nq, st.r.device)
        st.rows += rows_q
        st.cells += cells_q
    d = torch.where(torch.isfinite(lbs_b) & st.active[:, None], d,
                    float("inf"))
    state, _ = fold_min(IncumbentState(ub=st.ub, best=st.best), starts, d,
                        offset=offset)
    st.ub.copy_(state.ub)
    st.best.copy_(state.best)
    st.r += st.active
    more = st.r < n_rounds
    if plan.use_lb:
        nxt = lb_p.gather(
            1, torch.clamp_max(st.r, n_rounds - 1)[:, None] * batch)[:, 0]
        more &= nxt < st.ub
    st.lanes += st.active * batch
    st.active &= more
    torch.any(st.active, out=st.go)


@functools.lru_cache(maxsize=None)
def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The side stream every capture on ``dev`` runs on: the allocator
    caches blocks by stream, so a new stream a capture would hold more."""
    return torch.cuda.Stream(dev)


# The last round graph captured on each card. It is never replayed again,
# but it keeps its memory pool alive for the next capture there, which
# allocates from that pool and then frees it: so each capture reuses the
# blocks of the one before, instead of asking the driver for new ones (and
# giving them back, which synchronizes the card).
_LAST_GRAPH: dict[torch.device, torch.cuda.CUDAGraph] = {}
_FAILED_POOLS: list[torch.cuda.CUDAGraph] = []


class _RoundGraph:
    """``step``'s device work, captured once as a CUDA graph and replayed
    once a round.

    The capture runs on a side stream in ``"global"`` mode, so a host sync
    inside the step raises instead of passing silently. (Not through
    ``torch.cuda.graph``, whose entry synchronizes and empties the
    allocator's cache, which the next search would pay again.) The graph
    allocates from the pool of the card's last graph (``_LAST_GRAPH``),
    and takes its place there. Nothing runs during the capture, so the
    launches the wrappers of ``kernels.ops`` counted in it are put back,
    and each replay adds them again (``ops.counted_launches``), as an eager
    round counts them.
    """

    def __init__(self, step, dev: torch.device):
        self.dev = dev
        self.replays = 0
        before = ops.counted_launches()
        last = _LAST_GRAPH.get(dev)
        with torch.cuda.device(dev):
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(_capture_stream(dev)):
                    self.graph.capture_begin(
                        pool=None if last is None else last.pool(),
                        capture_error_mode="global")
                    try:
                        step()
                    finally:
                        self.graph.capture_end()
            except BaseException:
                # A capture that fails is not ended in the allocator, which
                # would route the side stream's allocations to the pool on.
                with contextlib.suppress(RuntimeError):
                    torch.cuda.memory._cuda_endAllocateToPool(
                        torch.cuda.current_device(), self.graph.pool())
                self.graph.reset()
                # The allocators' books of that pool stay half open: the
                # next capture starts a pool of its own, and the graph that
                # holds this one is kept, so that the pool is never used or
                # released again.
                if last is not None:
                    _FAILED_POOLS.append(_LAST_GRAPH.pop(dev))
                raise
            finally:
                self.launches = {
                    f: f.launches - n for f, n in before.items()
                    if f.launches != n}
                for f in self.launches:
                    f.launches = before[f]
            _LAST_GRAPH[dev] = self.graph
            if last is not None:
                last.reset()
        spans.count("host_rounds.graph_captures", 1)

    def replay(self) -> None:
        with torch.cuda.device(self.dev):
            self.graph.replay()
        self.replays += 1
        for f, n in self.launches.items():
            f.launches += n


# ---------------------------------------------------------------------------
# persistent-sweep executor
# ---------------------------------------------------------------------------

def run_persistent(
    plan: SearchPlan,
    prep: PreparedRef,
    pq: PreparedQueries,
    order: torch.Tensor,
    lb_sorted: torch.Tensor,
    state0: IncumbentState,
) -> tuple[IncumbentState, SearchStats]:
    """One launch for the whole workload (DESIGN.md §2.5): kernel C over
    the reference (``gather="fused"``), or kernel E over the ``(Q, n_win,
    l)`` best-first slab (``gather="slab"``).

    ``plan.warm_start > 0`` runs the same :func:`warm_prepass` as the host
    driver and seeds the sweep with its bounds; the sweep takes no ``best``
    seed (an unbeaten seed comes back with start -1), so its result is
    folded against the prepass state and a prepass winner keeps its start.
    ``rounds`` counts dispatches: 1, or 2 with the prepass. ``lanes`` is
    ``blocks × block_k`` clamped to the windows; on CUDA ``blocks`` may
    differ from ``repro``'s and between runs (``kernels.ops``), the winner
    does not.
    """
    nq, n_win = order.shape
    state0, pre, _, _ = warm_prepass(plan, prep, pq, order, lb_sorted, state0)
    # The one place lanes are padded to block_k (+inf bounds, which never
    # run), as repro pads them: the kernels take a ragged final block too,
    # so this only keeps repro's slab accounting.
    lb_p, order_p, _ = pad_lanes_to_blocks(plan.block_k, lb_sorted, order)
    env = (pq.u, pq.low) if plan.use_cb else None
    if plan.gather == "fused":
        bd, bs, blocks = ea_pruned_dtw_persistent_fused(
            pq.qn, prep.ref, lb_p, order_p, state0.ub, window=plan.window,
            mu=prep.mu, sigma=prep.sigma, band_width=plan.band_width,
            envelopes=env, **plan.knobs(),
        )
    else:
        _ensure_slab_budget(plan, nq * order_p.shape[1], "run_persistent")
        cand = gather_norm_windows(prep.ref, order_p, plan.length, prep.mu,
                                   prep.sigma)                # (Q, k_pad, l)
        bd, bs, blocks = ea_pruned_dtw_persistent(
            pq.qn, cand, lb_p, order_p, state0.ub, window=plan.window,
            band_width=plan.band_width, envelopes=env, **plan.knobs(),
        )
    # Strict-improvement fold against the (possibly prepass-seeded) state:
    # unbeaten seeds keep their start, a tighter sweep result adopts its.
    improved = bd < state0.ub
    state = IncumbentState(
        ub=torch.where(improved, bd, state0.ub),
        best=torch.where(improved, bs.to(state0.best.dtype), state0.best),
    )
    # Visited blocks are a best-first prefix per query, so only the final
    # padded block can hold non-candidates: clamp to n_win.
    lanes = torch.clamp_max(blocks.to(torch.int64) * plan.block_k, n_win)
    lb_pruned = n_win - lanes
    spans.count("cascade.pruned", lb_pruned)
    spans.count("cascade.windows", nq * n_win)
    no_info = torch.full((nq,), -1, dtype=torch.int64, device=order.device)
    return state, SearchStats(
        rounds=torch.full((nq,), 2 if pre else 1, dtype=torch.int64,
                          device=order.device),
        lanes=lanes,
        lb_pruned=lb_pruned,
        rows=no_info,
        cells=no_info,
    )


def _offline_search_impl(
    ref: torch.Tensor, queries: torch.Tensor, ub_init, plan: SearchPlan,
    with_info: bool = False,
) -> tuple[IncumbentState, SearchStats, torch.Tensor]:
    """prepare → cascade → host rounds or persistent sweep: the offline
    core behind ``multi_query_search`` and ``subsequence_search`` (Q=1).
    Returns ``(IncumbentState, SearchStats, n_quar)``; ``with_info``
    collects the host rounds' counters."""
    with spans.span("prepare_ref"):
        prep = prepare_ref(plan, ref)
    with spans.span("prepare_queries"):
        pq = prepare_queries(plan, queries)
    with spans.span("cascade"):
        order, lb_sorted = cascade(plan, prep, pq.qn)
    state0 = initial_state(pq.qn.shape[0], pq.qn.dtype, ub_init,
                           best_dtype=order.dtype, device=ref.device)
    if plan.rounds == "persistent":
        with spans.span("persistent_sweep"):
            state, stats = run_persistent(plan, prep, pq, order, lb_sorted,
                                          state0)
    else:
        with spans.span("host_rounds"):
            state, stats = run_host_rounds(plan, prep, pq, order, lb_sorted,
                                           state0, with_info=with_info)
    return state, stats, prep.n_quar


def run_stream_ingest(
    plan: SearchPlan, ctx: torch.Tensor, valid: torch.Tensor | None,
    pq: PreparedQueries, state0: IncumbentState, offset,
) -> tuple[IncumbentState, SearchStats, torch.Tensor]:
    """One ingest over the windows of ``ctx``: prepare → cascade → rounds.

    ``valid`` masks which of the ``len(ctx) - length + 1`` window starts
    really exist (the fixed-shape buffers mask their garbage prefix and
    padding suffix; ``None``: all of them); ``offset`` is the stream coordinate of ``ctx[0]`` (a
    Python int, negative at stream start in the fixed-shape form). The
    carried incumbents ride in as ``state0`` and gate round 0 exactly like
    a warm ``ub_init`` in the offline driver. Returns ``(IncumbentState,
    SearchStats, n_quar)`` with ``best`` in stream coordinates.
    """
    prep = prepare_ref(plan, ctx, valid=valid)
    order, lb_sorted = cascade(plan, prep, pq.qn)
    state, stats = run_host_rounds(plan, prep, pq, order, lb_sorted, state0,
                                   offset=offset)
    return state, stats, prep.n_quar


# ---------------------------------------------------------------------------
# the full / pruned baselines: one query, a scalar incumbent
# ---------------------------------------------------------------------------

def _baseline_search_impl(
    ref: torch.Tensor, query: torch.Tensor, plan: SearchPlan,
    with_info: bool = False,
) -> tuple[IncumbentState, SearchStats, torch.Tensor]:
    """Single-query core of the paper's baselines, ``full`` (UCR: exact DTW,
    ``core/dtw.py``) and ``pruned`` (UCR-USP: ``core/pruned_dtw.py``); port
    of ``repro``'s ``_baseline_search_impl``, which ``subsequence_search``
    sends these two variants to. Their distances take one scalar threshold,
    so there is no ``(Q, K)`` lane form: the same prepare and cascade
    stages, then host rounds with a scalar incumbent, or ``block_sweep``
    over the gathered best-first slab for ``rounds="persistent"``. The EA
    variants run here as ``repro`` runs them (kernel D a round, or kernel E
    for the sweep), with their lanes on a non-finite bound submitted dead.

    Counters (``with_info``, host rounds): ``pruned`` and the EA variants
    count the rows and cells of every lane of every round, padding and
    quarantined lanes included, as ``repro`` does; ``full`` counts
    analytically, ``k*m`` rows and ``k*min(window cells, m*m)`` cells a
    round of ``k`` lanes. The sweep is counter-free: one dispatch, ``rows``
    and ``cells`` -1. Returns ``(IncumbentState, SearchStats, n_quar)``
    shaped like Q = 1.
    """
    query_n = znorm(query[: plan.length])
    prep = prepare_ref(plan, ref)
    n_win = prep.mu.shape[0]
    order, lb_sorted = cascade(plan, prep, query_n[None])
    order, lb_sorted = order[0], lb_sorted[0]
    u, low = envelope(query_n, plan.window)
    ea = plan.variant in MULTI_VARIANTS
    knobs = plan.knobs()
    dev = ref.device

    def evaluate(cand, ub, cb, info: bool):
        """A batch's distances under ``ub`` (scalar or per lane) and, with
        ``info``, its int64 ``(rows, cells)`` totals."""
        k, m = cand.shape[0], plan.length
        if ea:
            out = _batch(
                query_n, cand, ub, window=plan.window,
                band_width=plan.band_width, cb=cb, with_info=info, **knobs,
            )
        elif plan.variant == "pruned":
            out = pruned_dtw_batch(query_n.expand(k, -1), cand, ub,
                                   window=plan.window, with_info=info)
        else:
            d = dtw_batch(query_n.expand(k, -1), cand, window=plan.window)
            if not info:
                return d, None
            # full DTW issues every in-window cell
            w = plan.window
            win_cells = m * (2 * w + 1) - w * (w + 1)
            return d, (torch.tensor(k * m, device=dev),
                       torch.tensor(k * min(win_cells, m * m), device=dev))
        if not info:
            return out, None
        d, counts = out
        return d, (counts.rows.sum(dtype=torch.int64),
                   counts.cells.sum(dtype=torch.int64))

    def stats(rounds, lanes, rows=-1, cells=-1) -> SearchStats:
        one = lambda v: torch.as_tensor(v, dtype=torch.int64,
                                        device=dev).reshape(1)
        return SearchStats(
            rounds=one(rounds), lanes=one(lanes),
            lb_pruned=one(n_win - min(int(lanes), n_win)),
            rows=one(rows), cells=one(cells),
        )

    if plan.rounds == "persistent":
        lb_p, order_p, _ = pad_lanes_to_blocks(plan.block_k, lb_sorted, order)
        # The baselines take gathered windows whatever plan.gather says,
        # as in repro; the slab must still fit the budget.
        _ensure_slab_budget(plan, order_p.shape[0], "baseline persistent")
        cand_all = gather_norm_windows(prep.ref, order_p, plan.length,
                                       prep.mu, prep.sigma)
        seed = torch.full((1,), BIG, dtype=torch.float32, device=dev)
        if ea:
            env = (u[None], low[None]) if plan.use_cb else None
            bd, bs, blocks = ea_pruned_dtw_persistent(
                query_n[None], cand_all[None], lb_p[None], order_p[None],
                seed, window=plan.window, band_width=plan.band_width,
                envelopes=env, **knobs,
            )
            ub, best, blocks = bd[0], bs[0], blocks[0]
        else:
            ub, best, blocks = block_sweep(
                cand_all, lb_p, order_p, seed[0], plan.block_k,
                lambda c, lbb, ub_lanes: evaluate(c, ub_lanes, None, False)[0],
            )
        lanes = min(int(blocks) * plan.block_k, n_win)
        state = IncumbentState(ub=ub.reshape(1),
                               best=best.to(order.dtype).reshape(1))
        # rounds counts dispatches: one sweep
        return state, stats(1, lanes), prep.n_quar

    batch = plan.batch
    n_rounds = -(-n_win // batch)
    pad = n_rounds * batch - n_win
    order_p = torch.cat([order, order.new_zeros(pad)])
    lb_p = torch.cat([lb_sorted, lb_sorted.new_full((pad,), float("inf"))])
    ub = torch.tensor(BIG, dtype=torch.float32, device=dev)
    best = torch.tensor(-1, dtype=order.dtype, device=dev)
    r = 0
    rows = cells = torch.zeros((), dtype=torch.int64, device=dev)
    while r < n_rounds:
        if plan.use_lb and not bool(lb_p[r * batch] < ub):
            break
        starts = order_p[r * batch : (r + 1) * batch]
        lbs = lb_p[r * batch : (r + 1) * batch]
        cand = gather_norm_windows(prep.ref, starts, plan.length, prep.mu,
                                   prep.sigma)
        cb = cascade_keogh_cumulative(cand, u, low) if plan.use_cb else None
        fin = torch.isfinite(lbs)
        # EA lanes on a non-finite bound (padding, quarantine) ride dead;
        # full/pruned take the scalar incumbent on every lane.
        ub_b = torch.where(fin, ub, DEAD_LANE_UB) if ea else ub
        d, counts = evaluate(cand, ub_b, cb, with_info)
        if with_info:
            rows, cells = rows + counts[0], cells + counts[1]
        d = torch.where(fin, d, float("inf"))
        k = torch.argmin(d)
        improved = d[k] < ub
        ub = torch.where(improved, d[k], ub)
        best = torch.where(improved, starts[k], best)
        r += 1
    state = IncumbentState(ub=ub.reshape(1), best=best.reshape(1))
    if with_info:
        return state, stats(r, r * batch, rows, cells), prep.n_quar
    return state, stats(r, r * batch), prep.n_quar


# ---------------------------------------------------------------------------
# sharded executor (torch.distributed: one rank a shard, all-reduce MIN)
# ---------------------------------------------------------------------------

def _shard_layout(mesh, axis_names) -> tuple[list, int, int]:
    """``(groups, n_shards, shard)`` of a mesh config.

    ``mesh`` is a process group (``None``: the default group) or a
    ``DeviceMesh``; with a mesh, ``axis_names`` name the dimensions the
    windows are sharded over, a reduction runs
    over each named dimension's group in turn, and a rank's shard is its
    row-major coordinate over those dimensions, as ``repro``'s
    ``P(axis_names)`` orders shards.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise guards.SearchInputError(
            "sharded search needs torch.distributed's default process group "
            "(torch.distributed.init_process_group)"
        )
    if not isinstance(mesh, DeviceMesh):
        return [mesh], dist.get_world_size(mesh), dist.get_rank(mesh)
    dims = [mesh.mesh_dim_names.index(a) for a in axis_names]
    coord = mesh.get_coordinate()
    n_shards, shard = 1, 0
    for d in dims:
        n_shards *= mesh.size(d)
        shard = shard * mesh.size(d) + coord[d]
    return [mesh.get_group(a) for a in axis_names], n_shards, shard


def _all_reduce(x: torch.Tensor, op, groups) -> torch.Tensor:
    """``x`` reduced by ``op`` over every group in turn (in place)."""
    import torch.distributed as dist

    for g in groups:
        dist.all_reduce(x, op=op, group=g)
    return x


def make_sharded_search(mesh, axis_names, plan: SearchPlan, device=None):
    """Build the sharded search program of a mesh config.

    Returns ``search_fn(ref, queries) -> (best_dist (Q,), best_start (Q,),
    rounds, n_quar)``, every value the same on every rank. Port of
    ``repro``'s ``shard_map`` program: each rank of ``mesh`` (see
    :func:`_shard_layout`) is one shard and runs on ``device`` (the card
    by default). Every rank is given the same ``ref`` and ``queries``; the
    ``per = ceil(n_win / n_shards)`` window starts ``[lo, lo + per)`` are
    this rank's, padding starts past ``n_win`` clamped and invalid.

    A rank computes the window stats of the whole reference, counts its
    own quarantined windows (summed over the shards), runs the cascade on
    its contiguous range (one launch of kernel B on ``ref[lo : hi + l -
    1]``; padding lanes ``+inf``), sorts stably, and then runs best-first
    rounds in lockstep with its peers: the lane gating of the host rounds,
    one round of kernel A (``gather="fused"``) or D (``"slab"``) with the
    ``cb`` suffix, the fold into its own incumbents, then ``ub =
    all_reduce(min(ub, local ub), MIN)`` and the continue flag
    ``all_reduce(any(next), MAX)``, read once a round on the host. There
    is no warm prepass, and ``plan.variant`` and ``plan.rounds`` are
    ignored, as in ``repro``. The reconcile takes the global minimum
    distance and the smallest start among the shards whose own distance
    ``torch.isclose``s it (``repro``'s ``jnp.isclose`` pairing).
    """
    import torch.distributed as dist

    groups, n_shards, shard = _shard_layout(mesh, axis_names)
    dev = resolve_device(device)
    batch, length = plan.batch, plan.length

    def search_fn(ref, queries):
        ref = as_float32(ref, dev)
        queries = as_float32(queries, dev)
        pq = prepare_queries(plan, queries)
        nq = pq.qn.shape[0]
        if plan.gather != "fused":
            _ensure_slab_budget(plan, nq * batch, "make_sharded_search")
        n_win = ref.shape[0] - length + 1
        per = -(-n_win // n_shards)
        lo = shard * per
        hi = min(lo + per, n_win)                  # this shard's real windows
        own = torch.arange(lo, lo + per, device=dev)
        starts, valid = torch.clamp_max(own, n_win - 1), own < n_win
        # Mask on the raw series, sanitize, then the whole series' stats.
        prep = prepare_ref(plan, ref)
        if prep.valid is not None:
            q_ok = prep.valid[starts]
            n_quar = (valid & ~q_ok).sum(dtype=torch.int64)
            valid = valid & q_ok
        else:
            n_quar = torch.zeros((), dtype=torch.int64, device=dev)
        n_quar = _all_reduce(n_quar, dist.ReduceOp.SUM, groups)

        lbs = torch.full((nq, per), float("inf"), device=dev)
        if hi > lo:
            lbs[:, : hi - lo] = cascade_lower_bounds(
                prep.ref[lo : hi + length - 1], pq.qn, prep.mu[lo:hi],
                prep.sigma[lo:hi], length, plan.window, chunk=plan.chunk,
                valid=valid[: hi - lo],
            )
        lb_sorted, order = torch.sort(lbs, dim=1, stable=True)
        n_rounds = -(-per // batch)
        pad = n_rounds * batch - per
        starts_p = torch.cat([starts[order], order.new_zeros(nq, pad)], dim=1)
        lb_p = torch.cat(
            [lb_sorted, lb_sorted.new_full((nq, pad), float("inf"))], dim=1)

        cols = torch.arange(batch, device=dev)
        r = torch.zeros(nq, dtype=torch.int64, device=dev)
        ub = torch.full((nq,), BIG, dtype=torch.float32, device=dev)
        loc = initial_state(nq, device=dev)
        go = True
        while go:
            idx = torch.clamp_max(r, n_rounds - 1)[:, None] * batch + cols
            s = starts_p.gather(1, idx)
            lb = lb_p.gather(1, idx)
            local_more = (r < n_rounds) & (lb[:, 0] < ub)
            ub_lanes = _dead_or(local_more[:, None] & (lb < ub[:, None]), ub)
            d, _ = _dtw_round(plan, prep, pq, s, ub_lanes, use_cb=True)
            d = torch.where(torch.isfinite(lb) & local_more[:, None], d,
                            float("inf"))
            loc, _ = fold_min(loc, s, d)
            ub = _all_reduce(torch.minimum(ub, loc.ub), dist.ReduceOp.MIN,
                             groups)
            r = r + local_more.to(r.dtype)
            nxt = lb_p.gather(1, torch.clamp_max(r, n_rounds - 1)[:, None]
                              * batch)[:, 0]
            more = ((r < n_rounds) & (nxt < ub)).any().to(torch.int32)
            go = bool(_all_reduce(more, dist.ReduceOp.MAX, groups))

        # Per-query global argmin: the least distance, then the least start
        # among the shards that reach it (within isclose).
        g_min = _all_reduce(loc.ub.clone(), dist.ReduceOp.MIN, groups)
        cand = torch.where(torch.isclose(loc.ub, g_min), loc.best,
                           torch.iinfo(torch.int64).max)
        g_start = _all_reduce(cand, dist.ReduceOp.MIN, groups)
        rounds = _all_reduce(r.max(), dist.ReduceOp.MAX, groups)
        return g_min, g_start, rounds, n_quar

    return search_fn


# ---------------------------------------------------------------------------
# Executor protocol — the range-execution seam
# ---------------------------------------------------------------------------

class RangeResult(NamedTuple):
    """Outcome of one work range: folded incumbents + accounting."""
    state: IncumbentState       # (Q,) incumbents, best in GLOBAL coordinates
    stats: SearchStats
    quarantined: torch.Tensor   # windows of this range excluded by §2.6


class Executor(Protocol):
    """``run_range(plan, state, lo, hi)``: search window starts [lo, hi).

    The seam the fault-tolerant layer schedules on: an executor is bound to
    one (reference, queries) workload at construction and searches any
    window-start range of it against carried incumbents, returning results
    in global window coordinates, as tensors on its device with the work
    possibly still queued. Implementations: host rounds, persistent sweep,
    sharded program.
    """

    def run_range(
        self, plan: SearchPlan, state: IncumbentState, lo: int, hi: int
    ) -> RangeResult:
        ...


class _OfflineRangeExecutor:
    """Shared range logic for the host-rounds/persistent executors.

    A range is searched as the offline core over its slice: windows
    ``[lo, hi)`` live in ``ref[lo : hi + length - 1]``, the carried
    incumbents ride in as warm ``ub_init`` seeds, and achieved starts map
    back by ``+ lo``. The range's window stats come from its own slice, so
    its distances may differ from a whole-reference search's in the last
    float32 bits. ``device=None`` is the card (raises without one).
    """

    _rounds: str

    def __init__(self, ref, queries, device=None):
        self.device = resolve_device(device)
        self.ref = as_float32(ref, self.device)
        queries = as_float32(queries, self.device)
        self.queries = queries[None] if queries.ndim == 1 else queries

    def run_range(
        self, plan: SearchPlan, state: IncumbentState, lo: int, hi: int
    ) -> RangeResult:
        plan = dataclasses.replace(plan, rounds=self._rounds)
        seg = self.ref[lo : hi + plan.length - 1]
        seed_ub = as_float32(state.ub, self.device)
        res_state, stats, n_quar = _offline_search_impl(
            seg, self.queries, seed_ub, plan, False,
        )
        best = torch.where(res_state.best >= 0, res_state.best + lo, -1)
        # Seed-unbeaten queries keep their incoming start (the seed's
        # achiever lives outside this range).
        seed_best = torch.as_tensor(state.best, device=self.device)
        best = torch.where(res_state.ub < seed_ub, best,
                           seed_best.to(best.dtype))
        return RangeResult(
            state=IncumbentState(ub=res_state.ub, best=best),
            stats=stats, quarantined=n_quar,
        )


class HostRoundsExecutor(_OfflineRangeExecutor):
    """Best-first host-round dispatches over the range (the default):
    kernel B once, then kernel A a round."""
    _rounds = "host"


class PersistentExecutor(_OfflineRangeExecutor):
    """The range's whole best-first order in one launch (DESIGN.md §2.5):
    kernel B once, then kernel C once."""
    _rounds = "persistent"


class ShardedExecutor:
    """Range execution on a mesh: :func:`make_sharded_search` over the
    range's slice ``ref[lo : hi + length - 1]``, every rank calling
    ``run_range`` with the same arguments.

    The same ``run_range`` contract as the host executors, so the
    resilient layer can schedule mesh-sized ranges; one program is built
    per plan. Incoming incumbent *bounds* seed nothing (the program starts
    cold at ``BIG``, as ``repro``'s does); the fold afterwards keeps
    whichever side is tighter. ``rounds`` is the program's, broadcast to
    ``(Q,)``; ``lanes``, ``lb_pruned``, ``rows`` and ``cells`` are -1.
    """

    def __init__(self, mesh, axis_names, ref, queries, device=None):
        self.mesh = mesh
        self.axis_names = None if axis_names is None else tuple(axis_names)
        self.device = resolve_device(device)
        self.ref = as_float32(ref, self.device)
        queries = as_float32(queries, self.device)
        self.queries = queries[None] if queries.ndim == 1 else queries
        self._fns: dict[SearchPlan, object] = {}

    def _fn(self, plan: SearchPlan):
        if plan not in self._fns:
            self._fns[plan] = make_sharded_search(
                self.mesh, self.axis_names, plan, device=self.device
            )
        return self._fns[plan]

    def run_range(
        self, plan: SearchPlan, state: IncumbentState, lo: int, hi: int
    ) -> RangeResult:
        seg = self.ref[lo : hi + plan.length - 1]
        best_d, best_s, rounds, n_quar = self._fn(plan)(seg, self.queries)
        seed_ub = as_float32(state.ub, self.device)
        seed_best = torch.as_tensor(state.best, device=self.device)
        # A range with no searchable window comes back (BIG, -1): it keeps
        # the carried state even where that is +inf (``repro`` takes BIG
        # with the start lo - 1 there).
        improved = (best_d < seed_ub) & (best_s >= 0)
        merged = IncumbentState(
            ub=torch.where(improved, best_d, seed_ub),
            best=torch.where(improved, best_s + lo, seed_best.to(best_s.dtype)),
        )
        nq = self.queries.shape[0]
        no_info = torch.full((nq,), -1, dtype=torch.int64, device=self.device)
        return RangeResult(
            state=merged,
            stats=SearchStats(
                rounds=rounds.expand(nq), lanes=no_info, lb_pruned=no_info,
                rows=no_info, cells=no_info,
            ),
            quarantined=n_quar,
        )


def get_executor(
    plan: SearchPlan, ref, queries, *, mesh=None, axis_names=None,
    device=None,
) -> Executor:
    """Bind the executor ``plan.rounds`` selects to one workload; with a
    ``mesh`` (a process group or ``DeviceMesh``), the sharded one."""
    if mesh is not None:
        return ShardedExecutor(mesh, axis_names, ref, queries, device=device)
    if plan.rounds == "persistent":
        return PersistentExecutor(ref, queries, device=device)
    return HostRoundsExecutor(ref, queries, device=device)


def _merge_range_results(a: RangeResult, b: RangeResult) -> RangeResult:
    """Fold a duplicate completion into the primary's (idempotent).

    Incumbents merge under strict improvement; stats and the quarantine
    count stay the primary's — both attempts scanned the same windows, so
    counting the backup's quarantined windows again would double-count.
    """
    return a._replace(state=merge_states(a.state, b.state))


def _merge_ingest_results(a, b):
    """Same rule for ``run_ingest``'s ``(new_tail, IngestResult)`` pairs."""
    tail_a, res_a = a
    _tail_b, res_b = b
    merged = merge_states(
        IncumbentState(ub=res_a.ub, best=res_a.best),
        IncumbentState(ub=res_b.ub, best=res_b.best),
    )
    return tail_a, res_a._replace(ub=merged.ub, best=merged.best)


class HedgedExecutor:
    """Race a straggling attempt on the next-healthiest wrapped executor.

    Wraps N executors behind the same seam (``run_range``, and
    ``run_ingest`` when the wrapped executors are streaming ingest
    executors). Every attempt runs on the healthiest available executor;
    when it takes longer than the hedge delay — explicit ``hedge_delay``,
    or derived as ``threshold × EWMA`` of the fleet's attempt latency —
    the same work is raced on up to ``hedge_max_inflight`` backups and the
    race is adjudicated on the virtual timeline
    (``fault_tolerance.hedge_race``). Duplicate completions merge through
    the strict-improvement fold (``incumbents.merge_states``), so a hedge
    can never change the answer — only the latency.

    An attempt's time includes its device work: the result's device is
    synchronized before the clock is read again (one sync an attempt).

    Health: one ``WorkerHealth`` (EWMA + circuit breaker) per wrapped
    executor. Routing prefers breaker-ready executors that are not
    straggling (EWMA ≤ ``threshold ×`` the fleet EWMA), in index order. A
    transient failure of the *primary* attempt records breaker state and
    re-raises: retry policy belongs to the layer above
    (``resilient_search``, the supervisor). Backup failures are absorbed.

    Counters: ``hedges_launched`` / ``hedges_won`` (a backup virtually
    finished first) / ``last_effective_dt`` (the latency a client of the
    race would have seen). ``clock`` is injectable; with a fake clock every
    race is deterministic.
    """

    def __init__(
        self,
        executors,
        *,
        hedge_delay: float | None = None,
        hedge_max_inflight: int = 2,
        threshold: float = 3.0,
        alpha: float = 0.2,
        breaker_threshold: int = 3,
        breaker_cooldown: float = 1.0,
        clock=time.time,
    ):
        self._executors = tuple(executors)
        if not self._executors:
            raise guards.SearchInputError(
                "HedgedExecutor needs at least one executor"
            )
        if hedge_max_inflight < 1:
            raise guards.SearchInputError("hedge_max_inflight must be >= 1")
        self.hedge_delay = hedge_delay
        self.hedge_max_inflight = int(hedge_max_inflight)
        self._clock = clock
        self.monitor = StragglerMonitor(threshold=threshold, alpha=alpha)
        self.health = tuple(
            WorkerHealth(
                threshold=threshold, alpha=alpha,
                breaker_threshold=breaker_threshold,
                breaker_cooldown=breaker_cooldown, clock=clock,
            )
            for _ in self._executors
        )
        self.hedges_launched = 0
        self.hedges_won = 0
        self.last_effective_dt: float | None = None
        self._steps = 0

    # -- routing ----------------------------------------------------------
    def _order(self) -> list[int]:
        """Executor indices, healthiest first: breaker-ready before open,
        non-straggling before straggling, index order as the tiebreak."""
        fleet = self.monitor.ewma

        def key(i: int):
            h = self.health[i]
            slow = (
                h.ewma is not None
                and fleet is not None
                and h.ewma > self.monitor.threshold * fleet
            )
            return (0 if h.ready() else 1, 1 if slow else 0, i)

        return sorted(range(len(self._executors)), key=key)

    def _delay(self) -> float | None:
        if self.hedge_delay is not None:
            return self.hedge_delay
        if self.monitor.ewma is None:
            return None  # no baseline yet: never hedge the first attempt
        return self.monitor.threshold * self.monitor.ewma

    def health_snapshots(self) -> tuple:
        return tuple(h.snapshot() for h in self.health)

    # -- the race ---------------------------------------------------------
    def _call(self, i: int, method: str, args, kwargs):
        """One attempt on executor ``i``, waited for on its device."""
        out = getattr(self._executors[i], method)(*args, **kwargs)
        return block_until_ready(out)

    def _attempt(self, method: str, args, kwargs, merge):
        primary = self._order()[0]
        self.health[primary].acquire()
        t0 = self._clock()
        try:
            result = self._call(primary, method, args, kwargs)
        except GUARD_ERRORS:
            raise
        except TRANSIENT:
            self.health[primary].fail()
            raise
        dt_p = self._clock() - t0
        delay = self._delay()  # pre-observe: the baseline excludes this dt
        self.health[primary].observe(dt_p)
        effective = dt_p
        if delay is not None and dt_p > delay and len(self._executors) > 1:
            used = {primary}

            def backups():
                while True:
                    cands = [
                        i for i in self._order()
                        if i not in used and self.health[i].ready()
                    ]
                    if not cands:
                        return
                    i = cands[0]
                    used.add(i)

                    def thunk(i=i):
                        self.health[i].acquire()
                        return self._call(i, method, args, kwargs)

                    yield i, thunk

            race = hedge_race(
                dt_p, delay, backups(), clock=self._clock,
                max_inflight=self.hedge_max_inflight,
                on_failure=lambda tag, _e: self.health[tag].fail(),
            )
            self.hedges_launched += race.launched
            if race.won:
                self.hedges_won += 1
            for tag, res_b, dt_b in race.completions:
                self.health[tag].observe(dt_b)
                result = merge(result, res_b)
            effective = race.effective_dt
        self.monitor.observe(self._steps, effective)
        self._steps += 1
        self.last_effective_dt = effective
        return result

    # -- the seam ---------------------------------------------------------
    def run_range(
        self, plan: SearchPlan, state: IncumbentState, lo: int, hi: int
    ) -> RangeResult:
        return self._attempt(
            "run_range", (plan, state, lo, hi), {}, _merge_range_results
        )

    def run_ingest(self, *args, **kwargs):
        """Forward one streaming ingest through the race (duck-typed: the
        wrapped executors must expose ``run_ingest``, e.g.
        ``search.streaming.StreamIngestExecutor``)."""
        return self._attempt(
            "run_ingest", args, kwargs, _merge_ingest_results
        )
