"""Batched EAPrunedDTW rounds and persistent sweeps (port of
``repro/core/batch.py``).

The unit of search work is a round of ``Q × K`` lanes evaluated in one
dispatch; each lane early-abandons against its own upper bound (DESIGN.md
§2.4). The persistent sweeps carry the incumbent across the whole
best-first order in one dispatch instead (DESIGN.md §2.5). Each comes in
two forms: fused gather (the raw reference plus per-lane ``(start, mu,
sigma)`` descriptors, slicing and z-normalization inside the kernel,
DESIGN.md §2.10) and slab (a pre-gathered ``(Q, K, m)`` window slab, the
``gather="slab"`` comparison arm):

  * ``ea_pruned_dtw_multi_batch_fused`` — round, fused (kernel A);
  * ``ea_pruned_dtw_batch`` / ``ea_pruned_dtw_multi_batch`` — round, slab
    (kernel D); ``ea_search_round`` — one slab round plus the strict
    argmin fold into a scalar incumbent;
  * ``ea_pruned_dtw_persistent_fused`` — sweep, fused (kernel C);
  * ``ea_pruned_dtw_persistent`` — sweep, slab (kernel E);
  * ``block_sweep`` — the baselines' persistent sweep, one query over a
    window slab with a scalar incumbent, any per-block distance function.

The three rounds take ``with_info=True`` and then also return the per-lane
``EAInfo`` counters (the counter variants of kernels A and D on CUDA).

Dispatch is by the device of the tensors: each ``kernels.ops`` wrapper
launches its CUDA kernel for CUDA tensors and runs its plain version for
CPU tensors. ``repro``'s ``backend`` knob has no counterpart.

Checks follow ``repro``'s split (``core/guards.py``): the public round
primitives make the static shape and knob checks, and then the value
checks (a finite query, no NaN ``ub``, ``cb >= 0``), which cost one host
read a call. ``repro`` skips the value checks on traced arrays, so its
jitted round loops never pay them; the port's round loops
(``search.pipeline``, ``search.streaming``) call the unchecked
``_multi_batch``, ``_multi_batch_fused`` and ``_batch`` instead, so no
round gains a host sync.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.core.common import clamp_sigma
from repro_torch.core.ea_pruned_dtw import EAInfo
from repro_torch.kernels import ops
from repro_torch.kernels.dtw_band import SWEEP_CHUNK, _sweep


def _with_info(out, with_info: bool):
    """A round wrapper's output as ``repro``'s batch primitives return it:
    the distances, or ``(distances, EAInfo)``."""
    if not with_info:
        return out
    d, rows, cells = out
    return d, EAInfo(rows=rows, cells=cells)


def ea_pruned_dtw_multi_batch_fused(
    queries: torch.Tensor,
    ref: torch.Tensor,
    starts: torch.Tensor,
    ub,
    window: int,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    envelopes: tuple[torch.Tensor, torch.Tensor] | None = None,
    band_width: int | None = None,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    with_info: bool = False,
    ref_budget: int | None = None,
):
    """Fused-gather multi-query round: ``(Q, K)`` distances (``+inf`` where
    a lane abandoned).

    Args:
      queries: ``(Q, m)`` z-normalized queries.
      ref: ``(N,)`` raw (sanitized) reference series.
      starts: ``(Q, K)`` window start per lane; a lane whose start lies
        outside ``[0, N - m]`` returns NaN (checked on the device, without
        a host sync).
      ub: per-lane upper bounds, broadcast to ``(Q, K)``; negative entries
        are dead-lane sentinels.
      window: Sakoe-Chiba window.
      mu, sigma: full ``(N_win,)`` window stats tables, indexed by
        ``starts`` here; ``sigma`` is raw and clamped at this boundary.
      envelopes: optional ``(u, low)`` pair of ``(Q, m)`` query envelopes;
        enables UCR ``cb`` tightening.
      band_width: columns per row (``None`` = ``default_band_width``).
      rows_per_step, block_k, row_block, ref_budget: ``repro``'s tuning
        knobs; accepted, no effect on results.
      with_info: also return the per-lane ``EAInfo`` counters.

    Returns ``(Q, K)`` distances; with ``with_info`` a ``(distances,
    EAInfo)`` pair of ``(Q, K)`` tensors. Raises ``NonFiniteInputError``
    on a non-finite query or a NaN ``ub`` (one host read; ``repro``'s
    fused primitive skips these checks).
    """
    if queries.dim() != 2:
        raise guards.SearchInputError(
            "fused multi batch requires (Q, m) univariate queries"
        )
    check_batch_values(queries, ub, multi=True)
    return _multi_batch_fused(
        queries, ref, starts, ub, window, mu, sigma, envelopes=envelopes,
        band_width=band_width, block_k=block_k, row_block=row_block,
        with_info=with_info, ref_budget=ref_budget)


def _multi_batch_fused(queries, ref, starts, ub, window, mu, sigma,
                       envelopes=None, band_width=None, rows_per_step=1,
                       block_k=8, row_block=128, with_info=False,
                       ref_budget=None):
    """``ea_pruned_dtw_multi_batch_fused`` without its checks: the round
    loops' entry."""
    del rows_per_step
    length = int(queries.shape[1])
    # Clamped for the table gather only: the round flags the lane itself.
    idx = starts.long().clamp(0, mu.shape[0] - 1)
    mu_l = mu[idx].to(torch.float32).contiguous()
    sg_l = clamp_sigma(sigma[idx]).to(torch.float32).contiguous()
    ub_l = torch.as_tensor(ub, dtype=torch.float32, device=ref.device)
    ub_l = ub_l.expand(starts.shape).contiguous()
    u = low = None
    if envelopes is not None:
        u, low = (e.to(torch.float32).contiguous() for e in envelopes)
    return _with_info(ops.dtw_ea_multi_fused(
        queries.to(torch.float32).contiguous(), ref.to(torch.float32).contiguous(),
        starts.to(torch.int32).contiguous(), mu_l, sg_l, ub_l, window, length,
        u=u, low=low, use_cb=envelopes is not None, band_width=band_width,
        block_k=block_k, row_block=row_block, ref_budget=ref_budget,
        with_info=with_info,
    ), with_info)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def check_batch_args(query, candidates, window, cb=None, multi=False):
    """Shape checks of the slab primitives (``repro``'s
    ``core/guards.py::check_batch_args``, static part); raises
    ``SearchInputError``. ``multi`` selects the ``(Q, m)`` x ``(Q, K, m)``
    contract, else ``(m[, dims])`` x ``(K, m[, dims])``."""
    qnd, cnd = query.dim(), candidates.dim()
    if multi:
        if qnd != 2:
            raise guards.SearchInputError(
                "multi-query batch requires (Q, m) univariate queries, got "
                f"shape {tuple(query.shape)}"
            )
        if cnd != 3:
            raise guards.SearchInputError(
                "multi-query candidates must be (Q, K, m), got shape "
                f"{tuple(candidates.shape)}"
            )
        if candidates.shape[0] != query.shape[0]:
            raise guards.SearchInputError(
                f"candidates Q={candidates.shape[0]} != queries "
                f"Q={query.shape[0]}"
            )
    elif qnd not in (1, 2):
        raise guards.SearchInputError(
            f"query must be (m,) or (m, dims), got shape {tuple(query.shape)}"
        )
    elif cnd != qnd + 1:
        raise guards.SearchInputError(
            f"candidates must be (K,) + query shape {tuple(query.shape)}, "
            f"got shape {tuple(candidates.shape)}"
        )
    m = query.shape[1 if multi else 0]
    if candidates.shape[2 if multi else 1] != m:
        raise guards.SearchInputError(
            f"candidate length {candidates.shape[2 if multi else 1]} != "
            f"query length {m}"
        )
    guards.ensure_knobs(window=window)
    if cb is not None and cb.shape[-1] != m:
        raise guards.SearchInputError(
            f"cb last-axis length {cb.shape[-1]} != query length {m}"
        )


def check_batch_values(query, ub, cb=None, multi=False):
    """``repro``'s value checks of the batch primitives, in its order, at
    one host read: ``cb`` non-negative (``SearchInputError``), the query
    finite and ``ub`` free of NaN (``NonFiniteInputError``)."""
    dev = query.device
    ub = torch.as_tensor(ub, device=dev)
    cb_neg = ((cb < 0).any() if cb is not None
              else torch.zeros((), dtype=torch.bool, device=dev))
    cb_neg, bad, ub_nan = torch.stack([
        cb_neg.long(), (~torch.isfinite(query)).sum(),
        torch.isnan(ub).any().long()]).tolist()
    if cb_neg:
        raise guards.SearchInputError(
            "cb must be non-negative (cumulative LB_Keogh suffix sums)")
    if bad:
        raise guards.NonFiniteInputError(
            f"{'queries' if multi else 'query'} contains {bad} "
            "non-finite value(s); queries must be finite (reference-side "
            "non-finites are quarantined instead)")
    if ub_nan:
        raise guards.NonFiniteInputError(
            "ub contains NaN (use +inf / BIG for cold)")


def ea_pruned_dtw_batch(
    query: torch.Tensor,
    candidates: torch.Tensor,
    ub,
    window: int,
    band_width: int | None = None,
    cb: torch.Tensor | None = None,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    with_info: bool = False,
):
    """Banded EAPrunedDTW of one query against K windows: ``(K,)``
    distances, ``+inf`` where a lane abandoned.

    Args:
      query: ``(m,)`` or ``(m, dims)`` z-normalized query. A multivariate
        query runs the full-row ``core.ea_pruned_dtw`` on each candidate
        with no kernel, as ``repro`` runs its jax backend for one (its
        kernel is univariate).
      candidates: ``(K, m[, dims])`` normalized windows.
      ub: scalar upper bound shared by every lane, or ``(K,)`` per lane.
      window: Sakoe-Chiba window.
      band_width: columns per row (``None`` = ``default_band_width``).
      cb: optional ``(K, m)`` cumulative LB_Keogh suffixes (UCR
        tightening).
      rows_per_step, block_k, row_block: ``repro``'s tuning knobs; no
        effect on results.
      with_info: also return the per-lane ``EAInfo`` counters, as a
        ``(distances, EAInfo)`` pair (a multivariate query's are the
        full-row algorithm's).

    Raises ``SearchInputError`` on malformed shapes, knobs or a negative
    ``cb``, and ``NonFiniteInputError`` on a non-finite query or a NaN
    ``ub``.
    """
    check_batch_args(query, candidates, window, cb=cb)
    check_batch_values(query, ub, cb)
    return _batch(query, candidates, ub, window, band_width, cb,
                  block_k=block_k, row_block=row_block, with_info=with_info)


def _batch(query, candidates, ub, window, band_width=None, cb=None,
           rows_per_step=1, block_k=8, row_block=128, with_info=False):
    """``ea_pruned_dtw_batch`` without its checks: the round loops' entry."""
    del rows_per_step
    if query.dim() == 2:
        return _multivariate(query, candidates, ub, window, cb, with_info)
    return _with_info(ops.dtw_ea(
        _f32(query), _f32(candidates), ub, window,
        cb=None if cb is None else _f32(cb), band_width=band_width,
        block_k=block_k, row_block=row_block, with_info=with_info,
    ), with_info)


def _multivariate(query, candidates, ub, window, cb, with_info):
    """An ``(m, dims)`` query against ``(K, m, dims)`` candidates: the
    full-row ``core.ea_pruned_dtw`` lane by lane, each under its own
    ``ub``."""
    from repro_torch.core.ea_pruned_dtw import ea_pruned_dtw

    k = candidates.shape[0]
    ub = torch.as_tensor(ub, dtype=torch.float32,
                         device=candidates.device).expand(k)
    lanes = [ea_pruned_dtw(_f32(query), _f32(candidates[i]), ub[i],
                           window=window, with_info=with_info,
                           cb=None if cb is None else _f32(cb[i]))
             for i in range(k)]
    if not with_info:
        return torch.stack(lanes).to(torch.float32)
    return (torch.stack([d for d, _ in lanes]).to(torch.float32),
            EAInfo(rows=torch.stack([i.rows for _, i in lanes]),
                   cells=torch.stack([i.cells for _, i in lanes])))


def ea_search_round(
    query: torch.Tensor,
    candidates: torch.Tensor,
    ub,
    best_idx,
    cand_idx: torch.Tensor,
    window: int,
    band_width: int | None = None,
    cb: torch.Tensor | None = None,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One search round: ``ea_pruned_dtw_batch`` (kernel D on the card)
    plus the incumbent update.

    ``cand_idx`` ``(K,)`` carries each candidate's global index, for the
    argmin bookkeeping across rounds. Returns the updated ``(ub,
    best_idx)`` as 0-d tensors on the candidates' device. Ties keep the
    incumbent (strict improvement only, the paper's rule for early
    abandoning); ``torch.argmin`` takes the first lane among equal minima,
    as ``jnp.argmin`` does.
    """
    dev = candidates.device
    ub = torch.as_tensor(ub, dtype=torch.float32, device=dev)
    best_idx = torch.as_tensor(best_idx, device=dev)
    d = ea_pruned_dtw_batch(
        query, candidates, ub, window, band_width, cb,
        rows_per_step=rows_per_step, block_k=block_k, row_block=row_block,
    )
    k = torch.argmin(d)
    improved = d[k] < ub
    new_best = torch.as_tensor(cand_idx, device=dev)[k].to(best_idx.dtype)
    return (torch.where(improved, d[k], ub),
            torch.where(improved, new_best, best_idx))


def ea_pruned_dtw_multi_batch(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    ub,
    window: int,
    band_width: int | None = None,
    cb: torch.Tensor | None = None,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    with_info: bool = False,
):
    """Banded EAPrunedDTW of Q queries against their own ``(Q, K, m)``
    windows in one dispatch: ``(Q, K)`` distances, ``+inf`` where a lane
    abandoned.

    ``ub`` is a scalar, ``(Q, 1)`` or ``(Q, K)``; negative entries are
    dead-lane sentinels (how finished queries ride along). ``cb`` is
    ``(Q, K, m)``; the other arguments and the checks as
    ``ea_pruned_dtw_batch``.
    """
    check_batch_args(queries, candidates, window, cb=cb, multi=True)
    check_batch_values(queries, ub, cb, multi=True)
    return _multi_batch(queries, candidates, ub, window, band_width, cb,
                        block_k=block_k, row_block=row_block,
                        with_info=with_info)


def _multi_batch(queries, candidates, ub, window, band_width=None, cb=None,
                 rows_per_step=1, block_k=8, row_block=128, with_info=False):
    """``ea_pruned_dtw_multi_batch`` without its checks: the round loops'
    entry."""
    del rows_per_step
    return _with_info(ops.dtw_ea_multi(
        _f32(queries), _f32(candidates), ub, window,
        cb=None if cb is None else _f32(cb), band_width=band_width,
        block_k=block_k, row_block=row_block, with_info=with_info,
    ), with_info)


def ea_pruned_dtw_persistent(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    lb: torch.Tensor,
    starts: torch.Tensor,
    ub_init,
    window: int,
    band_width: int | None = None,
    envelopes: tuple[torch.Tensor, torch.Tensor] | None = None,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
):
    """Persistent best-first EAPrunedDTW over a window slab: the whole
    sweep in one dispatch (kernel E on CUDA).

    Args:
      queries: ``(Q, m)`` z-normalized queries.
      candidates: ``(Q, K, m)`` windows in ascending-``lb`` order per query.
      lb: ``(Q, K)`` sorted lower bounds; ``+inf`` marks lanes that never
        run. Pass zeros (with ``+inf`` for quarantined windows) for the
        no-cascade variant.
      starts: ``(Q, K)`` global window start per lane.
      ub_init: ``(Q,)`` incumbent seeds (``BIG`` cold).
      envelopes: optional ``(u, low)`` pair of ``(Q, m)`` query envelopes:
        UCR ``cb`` tightening, built per lane inside the sweep.
      window, band_width, rows_per_step, row_block: as in
        ``ea_pruned_dtw_multi_batch``.
      block_k: lanes per block of the ``blocks`` work metric. The lanes
        need no padding to it: a ragged final block counts as one block, as
        ``repro``'s padded one does (``search.pipeline.run_persistent`` pads
        them, for ``repro``'s slab accounting).

    Returns ``(best_dist, best_start, blocks)``, ``(Q,)`` each. ``blocks``
    on CUDA may differ from ``repro``'s (``kernels.ops.dtw_ea_persistent``).
    """
    del rows_per_step
    if queries.dim() != 2:
        raise ValueError("persistent sweep requires (Q, m) univariate queries")
    u = low = None
    if envelopes is not None:
        u, low = (_f32(e) for e in envelopes)
    return ops.dtw_ea_persistent(
        _f32(queries), _f32(candidates), _f32(lb),
        starts.to(torch.int32).contiguous(),
        _f32(torch.as_tensor(ub_init, device=queries.device)), window,
        u=u, low=low, use_cb=envelopes is not None, band_width=band_width,
        block_k=block_k, row_block=row_block,
    )


def ea_pruned_dtw_persistent_fused(
    queries: torch.Tensor,
    ref: torch.Tensor,
    lb: torch.Tensor,
    starts: torch.Tensor,
    ub_init,
    window: int,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    envelopes: tuple[torch.Tensor, torch.Tensor] | None = None,
    band_width: int | None = None,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    ref_budget: int | None = None,
):
    """Fused-gather persistent sweep: the whole search with O(N + K)
    operands (kernel C on CUDA). ``ea_pruned_dtw_persistent`` without the
    window slab: lanes are ``(start, lb)`` descriptors plus the full
    ``(N_win,)`` stats tables ``mu``/``sigma`` (``sigma`` raw, clamped at
    this boundary after the per-lane gather), and each lane's window is
    sliced from ``ref`` inside the sweep. ``ref_budget`` is a Pallas knob
    with no effect. A lane whose start lies outside ``[0, N - m]`` raises
    ``SearchInputError``.
    """
    del rows_per_step
    if queries.dim() != 2:
        raise ValueError("persistent sweep requires (Q, m) univariate queries")
    length = int(queries.shape[1])
    starts = starts.to(torch.int32).contiguous()
    # Clamped for the table gather only: the sweep checks the lane itself.
    idx = starts.long().clamp(0, mu.shape[0] - 1)
    u = low = None
    if envelopes is not None:
        u, low = (_f32(e) for e in envelopes)
    return ops.dtw_ea_persistent_fused(
        _f32(queries), _f32(ref), _f32(lb), starts, _f32(mu[idx]),
        _f32(clamp_sigma(sigma[idx])),
        _f32(torch.as_tensor(ub_init, device=queries.device)), window,
        length, u=u, low=low, use_cb=envelopes is not None,
        band_width=band_width, block_k=block_k, row_block=row_block,
        ref_budget=ref_budget,
    )


def block_sweep(cand, lb, starts, ub0, block_k, block_fn,
                chunk: int = SWEEP_CHUNK):
    """Best-first sweep of one query over ``block_k``-lane blocks with a
    carried scalar incumbent (``repro``'s ``core/batch.py::block_sweep``,
    the persistent driver of the ``full``/``pruned`` baselines).

    A block runs iff its head ``lb`` lies below the incumbent; every lane of
    a running block with a finite ``lb`` runs (no lane gate, as in
    ``repro``); the fold is strict improvement with the first lane on ties;
    the sweep ends at the first gated block. The lanes are evaluated
    ``chunk`` at a time at the incumbent the sweep held when the chunk
    began, and the gate and fold are replayed block by block
    (``kernels/dtw_band.py::_sweep``): that gives ``repro``'s sequential
    result wherever a lane that finishes has the same distance under any
    ``ub`` it finishes under and a lane that abandons would abandon under
    any smaller one, which holds for ``dtw`` (it takes no ``ub``) and
    ``pruned_dtw`` (``tests/test_torch_baselines.py``).

    Args:
      cand: ``(K_pad, m[, dims])`` windows in ascending-``lb`` order.
      lb: ``(K_pad,)`` sorted lower bounds (``+inf``: padding and
        quarantined lanes, whose distances are masked).
      starts: ``(K_pad,)`` global start per lane.
      ub0: scalar initial incumbent.
      block_k: lanes per block.
      block_fn: ``(cand_chunk, lb_chunk, ub_lanes) -> (k,)`` distances of a
        chunk of lanes, ``ub_lanes`` the ``(k,)`` bound each lane runs
        under (the query's incumbent, or ``DEAD_LANE_UB`` once the sweep has
        ended).
      chunk: lanes evaluated together; no effect on the result.

    Returns ``(ub, best, blocks)``: 0-d float32, int32 (-1 while the seed is
    unbeaten) and int32 tensors.
    """
    ub_init = torch.as_tensor(ub0, dtype=torch.float32,
                              device=lb.device).reshape(1)

    def evaluate(lo, hi, ub_lanes):
        return block_fn(cand[lo:hi], lb[lo:hi], ub_lanes[0])[None]

    ub, best, blocks = _sweep(lb[None], starts[None], ub_init, block_k,
                              evaluate, chunk, lane_gate=False)
    return ub[0], best[0], blocks[0]
