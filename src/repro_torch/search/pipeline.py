"""The staged search pipeline: SearchPlan → prepare → cascade → execute.

Port of ``repro/search/pipeline.py`` for offline search with the
``eapruned`` and ``eapruned_nolb`` variants, under both round drivers and
both gather modes. Stages::

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
loop that reads ``any(active)`` once per round, the only host sync of a
round (the round kernels check their lanes on the device). The persistent
sweep makes one host sync, the out-of-range count of kernel C. Not ported
yet, and raising ``NotImplementedError`` naming ROADMAP.md Queue 1 item 6:
``with_info=True`` and the ``full``/``pruned`` variants.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.core import guards
from repro_torch.core.batch import (
    ea_pruned_dtw_multi_batch,
    ea_pruned_dtw_multi_batch_fused,
    ea_pruned_dtw_persistent,
    ea_pruned_dtw_persistent_fused,
)
from repro_torch.core.common import DEAD_LANE_UB, pad_lanes_to_blocks
from repro_torch.core.lower_bounds import cascade_keogh_cumulative, envelope
from repro_torch.search.cascade import cascade_lower_bounds
from repro_torch.search.incumbents import IncumbentState, fold_min, initial_state
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

_SLAB_COUNTERS = "ROADMAP.md Queue 1 item 6, 'Slab arms, counters, baselines'"


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
    """Validate knobs into a :class:`SearchPlan` (``repro``'s checks, then
    ``NotImplementedError`` for what this slice does not port)."""
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
    if variant not in MULTI_VARIANTS:
        raise NotImplementedError(
            f"variant {variant!r} is not ported yet ({_SLAB_COUNTERS})"
        )
    if with_info:
        raise NotImplementedError(
            f"with_info stats rounds are not ported yet ({_SLAB_COUNTERS})"
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


def _dtw_round_fused(plan, prep, pq, starts, ub_lanes, *, use_cb: bool):
    """One fused-gather EAPrunedDTW round over ``(Q, K)`` lane starts:
    kernel A slices and normalizes the windows itself."""
    return ea_pruned_dtw_multi_batch_fused(
        pq.qn, prep.ref, starts, ub_lanes, window=plan.window,
        mu=prep.mu, sigma=prep.sigma,
        envelopes=(pq.u, pq.low) if use_cb else None,
        band_width=plan.band_width, **plan.knobs(),
    )


def _dtw_round_slab(plan, prep, pq, starts, ub_lanes, *, use_cb: bool):
    """One slab EAPrunedDTW round: the windows gathered into a
    ``(Q, K, l)`` slab, with the ``cb`` slab beside it when ``use_cb``, for
    kernel D."""
    cand = gather_norm_windows(prep.ref, starts, plan.length, prep.mu,
                               prep.sigma)
    cb = None
    if use_cb:
        cb = cascade_keogh_cumulative(cand, pq.u[:, None, :],
                                      pq.low[:, None, :])
    return ea_pruned_dtw_multi_batch(
        pq.qn, cand, ub_lanes, window=plan.window,
        band_width=plan.band_width, cb=cb, **plan.knobs(),
    )


def _dtw_round(plan, prep, pq, starts, ub_lanes, *, use_cb: bool):
    fn = _dtw_round_fused if plan.gather == "fused" else _dtw_round_slab
    return fn(plan, prep, pq, starts, ub_lanes, use_cb=use_cb)


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
    offset=0,
) -> tuple[IncumbentState, int]:
    """Full-DP each query's ``min(warm_start, batch)`` best-LB candidates to
    seed the incumbents (changes work, not results). Returns
    ``(state, pre)``."""
    nq, n_win = order.shape
    pre = min(int(plan.warm_start), plan.batch)
    if pre <= 0:
        return state0, 0
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
    d0 = _dtw_round(plan, prep, pq, pre_starts, ub_pre, use_cb=False)
    d0 = torch.where(fin, d0, float("inf"))
    state, _ = fold_min(state0, pre_starts, d0, offset=offset)
    return state, pre


def run_host_rounds(
    plan: SearchPlan,
    prep: PreparedRef,
    pq: PreparedQueries,
    order: torch.Tensor,
    lb_sorted: torch.Tensor,
    state0: IncumbentState,
    *,
    offset=0,
) -> tuple[IncumbentState, SearchStats]:
    """The host round driver: best-first ``(Q × batch)``-lane rounds.

    Per-query drop-out: a query leaves when it has no rounds left or its
    next batch's smallest lower bound can no longer beat its incumbent; a
    finished query's lanes ride along with the dead-lane sentinel. Within a
    live query's batch, lanes whose own bound reaches the incumbent are
    submitted dead too.
    """
    nq, n_win = order.shape
    batch = plan.batch
    dev = order.device
    state, pre = warm_prepass(plan, prep, pq, order, lb_sorted, state0,
                              offset=offset)

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
    r = torch.zeros(nq, dtype=torch.int64, device=dev)
    # ``lanes`` counts distinct candidates examined: round 0 re-submits the
    # prepass candidates, so the prepass stands alone only for a query that
    # never enters the round loop.
    lanes = torch.where(active, 0, pre).to(torch.int64)
    cols = torch.arange(batch, device=dev)

    while bool(active.any()):
        idx = torch.clamp_max(r, n_rounds - 1)[:, None] * batch + cols
        starts = order_p.gather(1, idx)
        lbs_b = lb_p.gather(1, idx)
        ub_lanes = _dead_or(active[:, None] & (lbs_b < state.ub[:, None]),
                            state.ub)
        d = _dtw_round(plan, prep, pq, starts, ub_lanes, use_cb=plan.use_cb)
        d = torch.where(torch.isfinite(lbs_b) & active[:, None], d,
                        float("inf"))
        state, _ = fold_min(state, starts, d, offset=offset)
        r_new = r + active.to(r.dtype)
        more = r_new < n_rounds
        if plan.use_lb:
            nxt = lb_p.gather(1, torch.clamp_max(r_new, n_rounds - 1)[:, None]
                              * batch)[:, 0]
            more = more & (nxt < state.ub)
        lanes = lanes + active.to(lanes.dtype) * batch
        active = active & more
        r = r_new

    no_info = torch.full((nq,), -1, dtype=torch.int64, device=dev)
    return state, SearchStats(
        rounds=r,
        lanes=lanes,
        lb_pruned=n_win - torch.clamp_max(lanes, n_win),
        rows=no_info,
        cells=no_info,
    )


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
    state0, pre = warm_prepass(plan, prep, pq, order, lb_sorted, state0)
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
    no_info = torch.full((nq,), -1, dtype=torch.int64, device=order.device)
    return state, SearchStats(
        rounds=torch.full((nq,), 2 if pre else 1, dtype=torch.int64,
                          device=order.device),
        lanes=lanes,
        lb_pruned=n_win - lanes,
        rows=no_info,
        cells=no_info,
    )


def _offline_search_impl(
    ref: torch.Tensor, queries: torch.Tensor, ub_init, plan: SearchPlan
) -> tuple[IncumbentState, SearchStats, torch.Tensor]:
    """prepare → cascade → host rounds or persistent sweep: the offline
    core behind ``multi_query_search`` and ``subsequence_search`` (Q=1).
    Returns ``(IncumbentState, SearchStats, n_quar)``."""
    prep = prepare_ref(plan, ref)
    pq = prepare_queries(plan, queries)
    order, lb_sorted = cascade(plan, prep, pq.qn)
    state0 = initial_state(pq.qn.shape[0], pq.qn.dtype, ub_init,
                           best_dtype=order.dtype, device=ref.device)
    if plan.rounds == "persistent":
        state, stats = run_persistent(plan, prep, pq, order, lb_sorted, state0)
    else:
        state, stats = run_host_rounds(plan, prep, pq, order, lb_sorted,
                                       state0)
    return state, stats, prep.n_quar
