"""Multi-query subsequence search (port of ``repro/search/multi.py``).

Q queries share one reference: one ``window_stats`` pass, one cascade
launch for all Q queries, then either one ``(Q × batch)``-lane round per
dispatch with a per-query incumbent vector (``rounds="host"``) or the whole
best-first sweep in one launch (``rounds="persistent"``), each with the
windows sliced in the kernel (``gather="fused"``) or gathered into a slab
(``gather="slab"``); see ``search.pipeline``. The distributed
variant is not ported yet (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import guards
from repro_torch.core.common import resolve_device
from repro_torch.search.pipeline import (
    MULTI_VARIANTS,
    _offline_search_impl,
    make_plan,
)

__all__ = ["MULTI_VARIANTS", "MultiSearchResult", "multi_query_search"]


class MultiSearchResult(NamedTuple):
    best_start: torch.Tensor   # (Q,) window start of each neighbour (-1: none)
    best_dist: torch.Tensor    # (Q,) its DTW distance (== ub_init if unbeaten)
    rounds: torch.Tensor       # (Q,) batch rounds each query stayed active
    lanes: torch.Tensor        # (Q,) candidate lanes each query submitted
    lb_pruned: torch.Tensor    # (Q,) candidates never evaluated (LB ordering)
    rows: torch.Tensor         # (Q,) DTW rows issued (-1: fast rounds)
    cells: torch.Tensor        # (Q,) admissible DTW cells (-1: fast rounds)
    quarantined: torch.Tensor  # windows excluded by the non-finite quarantine


def as_float32(x, device: torch.device) -> torch.Tensor:
    """``x`` (tensor or array-like) as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def multi_query_search(
    ref,
    queries,
    length: int,
    window: int,
    variant: str = "eapruned",
    batch: int = 64,
    band_width: int | None = None,
    chunk: int = 4096,
    with_info: bool = False,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    ub_init=None,
    warm_start: int = 0,
    rounds: str = "host",
    quarantine: bool = True,
    gather: str = "fused",
    slab_budget: int | None = None,
    device=None,
) -> MultiSearchResult:
    """Nearest z-normalized window of ``ref`` for each of Q queries.

    Args as ``repro.search.multi.multi_query_search`` (without ``backend``),
    plus ``device``: the search runs on CUDA unless ``device="cpu"`` is
    passed; with no device and no CUDA it raises. ``ref``/``queries`` may
    be arrays or tensors and are computed in float32.

    Returns: ``MultiSearchResult`` of per-query ``(Q,)`` tensors on the
    device.
    """
    dev = resolve_device(device)
    guards.ensure_series(ref, "ref", ndim=1, min_len=length)
    guards.ensure_series(queries, "queries", ndim=2, min_len=length)
    guards.ensure_finite(queries, "queries")
    if ub_init is not None:
        ub_init = as_float32(ub_init, dev)
        if bool(torch.isnan(ub_init).any()):
            raise guards.NonFiniteInputError(
                "ub_init contains NaN (use +inf / BIG for a cold start)"
            )
    plan = make_plan(
        length=length, window=window, variant=variant, batch=batch,
        band_width=band_width, chunk=chunk, rows_per_step=rows_per_step,
        block_k=block_k, row_block=row_block, rounds=rounds,
        quarantine=quarantine, warm_start=warm_start, gather=gather,
        slab_budget=slab_budget, with_info=with_info,
        allowed_variants=MULTI_VARIANTS,
    )
    state, stats, n_quar = _offline_search_impl(
        as_float32(ref, dev), as_float32(queries, dev), ub_init, plan
    )
    return MultiSearchResult(
        best_start=state.best,
        best_dist=state.ub,
        rounds=stats.rounds,
        lanes=stats.lanes,
        lb_pruned=stats.lb_pruned,
        rows=stats.rows,
        cells=stats.cells,
        quarantined=n_quar,
    )
