"""Single-query subsequence search (port of ``repro/search/subsequence.py``).

The paper's four suites: ``full`` (UCR), ``pruned`` (UCR-USP),
``eapruned`` (UCR-MON) and ``eapruned_nolb``. The EA variants run as the
Q=1 case of the multi-query core (``pipeline._offline_search_impl``), the
two baselines on the pipeline's single-query core
(``pipeline._baseline_search_impl``), as in ``repro``. A multivariate
``(l, dims)`` query raises ``NotImplementedError``: ``repro``'s search
fails on one too (ROADMAP.md Queue 3).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import guards
from repro_torch.core.common import resolve_device
from repro_torch.search.multi import as_float32
from repro_torch.search.pipeline import (
    MULTI_VARIANTS,
    ROUND_DRIVERS,
    VARIANTS,
    _baseline_search_impl,
    _offline_search_impl,
    make_plan,
)

__all__ = ["ROUND_DRIVERS", "VARIANTS", "SearchResult", "subsequence_search"]


class SearchResult(NamedTuple):
    best_start: torch.Tensor   # window start of the nearest neighbour
    best_dist: torch.Tensor    # its DTW distance (z-normalized)
    rounds: torch.Tensor       # batch rounds executed
    lanes: torch.Tensor        # candidate lanes evaluated
    lb_pruned: torch.Tensor    # candidates never evaluated (LB ordering)
    rows: torch.Tensor         # DTW rows issued (-1: fast rounds)
    cells: torch.Tensor        # admissible DTW cells (-1: fast rounds)
    quarantined: torch.Tensor  # windows excluded by the non-finite quarantine


def subsequence_search(
    ref,
    query,
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
    rounds: str = "host",
    quarantine: bool = True,
    gather: str = "fused",
    slab_budget: int | None = None,
    device=None,
) -> SearchResult:
    """Locate the closest z-normalized window of ``ref`` to ``query``.

    Args as ``repro.search.subsequence.subsequence_search`` (without
    ``backend``), plus ``device`` (CUDA unless ``"cpu"`` is passed; with
    no device and no CUDA it raises). ``with_info`` (host rounds only)
    collects the rows and cells the search issues, in int64; without it
    they are -1. Returns ``SearchResult`` of 0-d tensors on the device.
    """
    with spans.span(spans.SEARCH):
        dev = resolve_device(device)
        guards.ensure_series(ref, "ref", ndim=1, min_len=length)
        if len(getattr(query, "shape", np.shape(query))) != 1:
            raise NotImplementedError(
                "multivariate (l, dims) queries have no search path: repro's "
                "subsequence_search fails on one with a TypeError (sub got "
                "incompatible shapes for broadcasting), so there is no "
                "reference to port (ROADMAP.md Queue 3); core.dtw takes "
                "(n, dims) series"
            )
        guards.ensure_series(query, "query", ndim=1, min_len=length)
        guards.ensure_finite(query, "query")
        plan = make_plan(
            length=length, window=window, variant=variant, batch=batch,
            band_width=band_width, chunk=chunk, rows_per_step=rows_per_step,
            block_k=block_k, row_block=row_block, rounds=rounds,
            quarantine=quarantine, gather=gather, slab_budget=slab_budget,
            with_info=with_info,
        )
        if variant in MULTI_VARIANTS:
            state, stats, n_quar = _offline_search_impl(
                as_float32(ref, dev), as_float32(query, dev)[None, :], None,
                plan, with_info=with_info,
            )
        else:
            state, stats, n_quar = _baseline_search_impl(
                as_float32(ref, dev), as_float32(query, dev), plan,
                with_info=with_info,
            )
        return SearchResult(
            best_start=state.best[0],
            best_dist=state.ub[0],
            rounds=stats.rounds[0],
            lanes=stats.lanes[0],
            lb_pruned=stats.lb_pruned[0],
            rows=stats.rows[0],
            cells=stats.cells[0],
            quarantined=n_quar,
        )
