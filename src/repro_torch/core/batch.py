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
    (kernel D);
  * ``ea_pruned_dtw_persistent_fused`` — sweep, fused (kernel C);
  * ``ea_pruned_dtw_persistent`` — sweep, slab (kernel E).

Dispatch is by the device of the tensors: each ``kernels.ops`` wrapper
launches its CUDA kernel for CUDA tensors and runs its plain version for
CPU tensors. ``repro``'s ``backend`` knob has no counterpart. Value checks
that would cost a host sync per round (``ub`` NaN, ``cb >= 0``) are not
made here; the frontends check the queries and seeds once.
"""
from __future__ import annotations

import torch

from repro_torch.core import guards
from repro_torch.core.common import clamp_sigma
from repro_torch.kernels import ops

_COUNTERS = ("with_info stats rounds are not ported yet (ROADMAP.md Queue 1 "
             "item 6, 'Slab arms, counters, baselines')")


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
) -> torch.Tensor:
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
      with_info: the ``EAInfo`` stats rounds are not ported yet (ROADMAP.md
        Queue 1 item 6); ``True`` raises ``NotImplementedError``.
    """
    del rows_per_step
    if with_info:
        raise NotImplementedError(_COUNTERS)
    if queries.dim() != 2:
        raise guards.SearchInputError(
            "fused multi batch requires (Q, m) univariate queries"
        )
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
    return ops.dtw_ea_multi_fused(
        queries.to(torch.float32).contiguous(), ref.to(torch.float32).contiguous(),
        starts.to(torch.int32).contiguous(), mu_l, sg_l, ub_l, window, length,
        u=u, low=low, use_cb=envelopes is not None, band_width=band_width,
        block_k=block_k, row_block=row_block, ref_budget=ref_budget,
    )


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def check_batch_args(query, candidates, window, cb=None, multi=False):
    """Shape checks of the slab primitives (``repro``'s
    ``core/guards.py::check_batch_args``, static part); raises
    ``SearchInputError``. ``multi`` selects the ``(Q, m)`` x ``(Q, K, m)``
    contract, else ``(m,)`` x ``(K, m)``."""
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
    elif qnd != 1:
        raise NotImplementedError(
            "multivariate queries are not ported yet (ROADMAP.md Queue 1 "
            "item 6, 'Slab arms, counters, baselines')"
        )
    elif cnd != 2:
        raise guards.SearchInputError(
            f"candidates must be (K, m), got shape {tuple(candidates.shape)}"
        )
    m = query.shape[-1]
    if candidates.shape[-1] != m:
        raise guards.SearchInputError(
            f"candidate length {candidates.shape[-1]} != query length {m}"
        )
    guards.ensure_knobs(window=window)
    if cb is not None and cb.shape[-1] != m:
        raise guards.SearchInputError(
            f"cb last-axis length {cb.shape[-1]} != query length {m}"
        )


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
) -> torch.Tensor:
    """Banded EAPrunedDTW of one query against K windows: ``(K,)``
    distances, ``+inf`` where a lane abandoned.

    Args:
      query: ``(m,)`` z-normalized query (multivariate queries are not
        ported yet, ROADMAP.md Queue 1 item 6).
      candidates: ``(K, m)`` normalized windows.
      ub: scalar upper bound shared by every lane, or ``(K,)`` per lane.
      window: Sakoe-Chiba window.
      band_width: columns per row (``None`` = ``default_band_width``).
      cb: optional ``(K, m)`` cumulative LB_Keogh suffixes (UCR
        tightening).
      rows_per_step, block_k, row_block: ``repro``'s tuning knobs; no
        effect on results.
      with_info: not ported yet (ROADMAP.md Queue 1 item 6); ``True``
        raises ``NotImplementedError``.
    """
    del rows_per_step
    if with_info:
        raise NotImplementedError(_COUNTERS)
    check_batch_args(query, candidates, window, cb=cb)
    return ops.dtw_ea(
        _f32(query), _f32(candidates), ub, window,
        cb=None if cb is None else _f32(cb), band_width=band_width,
        block_k=block_k, row_block=row_block,
    )


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
) -> torch.Tensor:
    """Banded EAPrunedDTW of Q queries against their own ``(Q, K, m)``
    windows in one dispatch: ``(Q, K)`` distances, ``+inf`` where a lane
    abandoned.

    ``ub`` is a scalar, ``(Q, 1)`` or ``(Q, K)``; negative entries are
    dead-lane sentinels (how finished queries ride along). ``cb`` is
    ``(Q, K, m)``; the other arguments as ``ea_pruned_dtw_batch``.
    """
    del rows_per_step
    if with_info:
        raise NotImplementedError(_COUNTERS)
    check_batch_args(queries, candidates, window, cb=cb, multi=True)
    return ops.dtw_ea_multi(
        _f32(queries), _f32(candidates), ub, window,
        cb=None if cb is None else _f32(cb), band_width=band_width,
        block_k=block_k, row_block=row_block,
    )


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
