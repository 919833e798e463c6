"""Banded EAPrunedDTW, batched over lanes — the port's DP oracle.

Port of ``repro/core/ea_pruned_dtw.py::ea_pruned_dtw_banded`` (Herrmann &
Webb's Algorithm 3, banded). ``repro`` runs one lane in a
``lax.while_loop`` and vmaps it; here all lanes step through the rows
together as tensors, each lane masked once it has abandoned, and the loop
ends when every lane has.

Each lane keeps its own band offset (its ``next_start``), exactly as the
``repro`` function does; the round kernel and its plain version
(``kernels/dtw_band.py``) use the lane-uniform window-following offset
instead. Both compute every admissible cell, so they agree to the
O(1)-ulp rounding of the prefix-scan reformulation (DESIGN.md §2.1).

Correctness contract (the paper's): the result equals exact DTW whenever
exact DTW <= ub, and is ``+inf`` whenever exact DTW > ub.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.common import BIG, default_band_width, row_scan, to_inf


class EAInfo(NamedTuple):
    """Pruning-effectiveness counters (paper §5 reports cell ratios)."""

    rows: torch.Tensor   # rows issued before abandon/completion
    cells: torch.Tensor  # admissible cells across issued rows (band area)


def ea_pruned_dtw_banded(
    s: torch.Tensor,
    t: torch.Tensor,
    ub,
    window: int,
    band_width: int | None = None,
    with_info: bool = False,
    cb: torch.Tensor | None = None,
    rows_per_step: int = 1,
):
    """Banded EAPrunedDTW of line series ``s`` against column series ``t``.

    Args:
      s: ``(n,)`` shared by every lane, or ``(B, n)`` one per lane.
      t: ``(m,)`` or ``(B, m)``; ``n == m`` (subsequence-search shape).
      ub: scalar or ``(B,)`` per-lane upper bounds; a negative entry kills
        its lane on row 0.
      window: Sakoe-Chiba window.
      band_width: columns per row; ``None`` = ``default_band_width``.
      with_info: also return per-lane ``EAInfo`` counters.
      cb: optional ``(m,)`` or ``(B, m)`` cumulative LB_Keogh suffix sums
        (UCR threshold tightening ``ub - cb[i + w + 1]``).
      rows_per_step: accepted for parity with ``repro``; it changes no
        result (the rows are stepped one at a time here).

    Returns ``(B,)`` distances (``+inf`` where abandoned), or a scalar when
    neither ``s`` nor ``t`` is batched; with ``with_info`` a
    ``(distances, EAInfo)`` pair.
    """
    del rows_per_step
    unbatched = s.dim() == 1 and t.dim() == 1
    dtype = torch.promote_types(torch.promote_types(s.dtype, t.dtype),
                                torch.float32)
    dev = t.device
    s2 = s.to(dtype).reshape(-1, s.shape[-1])
    t2 = t.to(dtype).reshape(-1, t.shape[-1])
    nb = max(s2.shape[0], t2.shape[0])
    s2 = s2.expand(nb, -1)
    t2 = t2.expand(nb, -1)
    n, m = s2.shape[1], t2.shape[1]
    if n != m:
        raise ValueError("banded EAPrunedDTW requires equal lengths")
    window = min(int(window), m - 1)
    full = min(2 * window + 1, m)
    bw = default_band_width(window, m) if band_width is None else int(band_width)
    if bw < full:
        raise ValueError(f"band_width {bw} < 2*window+1 = {full}")
    ub_l = torch.as_tensor(ub, dtype=dtype, device=dev).reshape(-1).expand(nb)
    cb2 = None if cb is None else cb.to(dtype).reshape(-1, m).expand(nb, -1)

    rel = torch.arange(bw, device=dev)
    t_pad = torch.cat([t2, torch.zeros(nb, bw, dtype=dtype, device=dev)], 1)
    big = torch.full((nb, bw + 1), BIG, dtype=dtype, device=dev)
    lane = torch.arange(nb, device=dev)

    band = torch.full((nb, bw), BIG, dtype=dtype, device=dev)
    band[:, 0] = 0.0  # virtual corner at column -1
    lo_st = torch.full((nb,), -1, dtype=torch.long, device=dev)
    next_start = torch.zeros(nb, dtype=torch.long, device=dev)
    ok_last = torch.zeros(nb, dtype=torch.bool, device=dev)
    abandoned = torch.zeros(nb, dtype=torch.bool, device=dev)
    rows = torch.zeros(nb, dtype=torch.int32, device=dev)
    cells = torch.zeros(nb, dtype=torch.int32, device=dev)

    for i in range(n):
        active = ~abandoned
        if not bool(active.any()):
            break
        ns = torch.clamp_min(next_start, i - window)
        lo = ns
        hi = min(m - 1, i + window)
        cols = lo[:, None] + rel[None, :]
        exists = cols <= hi

        # Realign the previous band: aligned[r] = prev[lo - 1 + r].
        # An active lane advances by at most bw - 1 columns a row; the clamp
        # only bounds the frozen offsets of lanes that have abandoned.
        shift = torch.clamp(lo - lo_st, 0, bw)
        padded = torch.cat([big[:, :1], band, big], dim=1)
        r1 = torch.arange(bw + 1, device=dev)
        aligned = padded.gather(1, shift[:, None] + r1[None, :])
        aligned = torch.where(r1[None, :] <= bw - shift[:, None], aligned,
                              big[:, : bw + 1])

        tc = t_pad.gather(1, cols)
        c = (s2[:, i : i + 1] - tc) ** 2
        d = c + torch.minimum(aligned[:, 1:], aligned[:, :-1])
        d = torch.where(exists, d, big[:, :bw])
        curr = torch.clamp_max(row_scan(d, c), BIG)
        curr = torch.where(exists, curr, big[:, :bw])

        if cb2 is not None and i + window + 1 <= m - 1:
            thr = ub_l - cb2[:, i + window + 1]
        else:
            thr = ub_l
        le = (curr <= thr[:, None]) & exists
        any_le = le.any(dim=1)
        upd = active & any_le
        ns_new = lo + le.to(torch.int8).argmax(dim=1)
        band = torch.where(upd[:, None], curr, band)
        lo_st = torch.where(upd, lo, lo_st)
        next_start = torch.where(upd, ns_new, torch.where(active, ns, next_start))
        ok_last = torch.where(active, (le & (cols == m - 1)).any(dim=1), ok_last)
        abandoned = abandoned | (active & ~any_le)
        rows = rows + active.to(torch.int32)
        cells = cells + torch.where(active, exists.sum(1, dtype=torch.int32), 0)

    good = ~abandoned & ok_last
    idx = torch.clamp((m - 1) - lo_st, 0, bw - 1)
    last_val = band[lane, idx]
    out = torch.where(good, to_inf(last_val),
                      torch.full_like(last_val, float("inf")))
    if unbatched:
        out, rows, cells = out[0], rows[0], cells[0]
    if with_info:
        return out, EAInfo(rows=rows, cells=cells)
    return out
