"""EAPrunedDTW (Herrmann & Webb's Algorithm 3), port of
``repro/core/ea_pruned_dtw.py``. Both forms make the paper's pruning
decisions at row granularity:

``ea_pruned_dtw`` — one pair, full-width rows: each row is one vector step
    (the closed-form min-plus scan of ``common.row_scan``), the band pointer
    ``next_start`` comes from a masked ``argmax``, and the loop ends on the
    border collision (early abandon). ``repro`` runs it as a
    ``lax.while_loop`` outside any Pallas kernel; here it is a Python loop of
    PyTorch ops on the device of its inputs that reads one host scalar a row
    (whether any cell stayed under the threshold). Univariate or ``(n,
    dims)`` series, ``n != m`` without a window, ``cb`` and ``EAInfo``.

``ea_pruned_dtw_banded`` — the port's DP oracle for the batched rounds:
    ``repro`` runs one lane in a ``lax.while_loop`` and vmaps it; here all
    lanes step through the rows together as tensors, each lane masked once
    it has abandoned, and the loop ends when every lane has. Each lane keeps
    its own band offset (its ``next_start``), exactly as the ``repro``
    function does; the round kernel and its plain version
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
from repro_torch.core.dtw import cost_row


class EAInfo(NamedTuple):
    """Pruning-effectiveness counters (paper §5 reports cell ratios)."""

    rows: torch.Tensor   # rows issued before abandon/completion
    cells: torch.Tensor  # admissible cells across issued rows (band area)


def _row_threshold(ub: torch.Tensor, cb: torch.Tensor | None, i: int,
                   window: int | None, m: int) -> torch.Tensor:
    """UCR-suite upper-bound tightening: any path cell in row ``i`` sits in
    columns <= i + w, so the remaining columns add at least
    ``cb[i + w + 1]`` (the cumulative LB_Keogh suffix); the row threshold
    is ``ub - cb[i + w + 1]``, and ``ub`` past the last column."""
    if cb is None:
        return ub
    w = 0 if window is None else window
    if i + w + 1 <= m - 1:
        return ub - cb[i + w + 1]
    return ub


def ea_pruned_dtw(
    s,
    t,
    ub,
    window: int | None = None,
    with_info: bool = False,
    cb=None,
):
    """EAPrunedDTW of one pair, full-width rows (see the module docstring).

    Args:
      s: ``(n,)`` or ``(n, dims)`` "line" series (rows); a tensor or an
        array.
      t: ``(m,)`` or ``(m, dims)`` series (columns).
      ub: scalar upper bound; the computation abandons once the distance
        provably exceeds it.
      window: optional Sakoe-Chiba window (requires ``n == m``; a window of
        at least ``m`` is none).
      with_info: also return ``EAInfo`` counters (0-d int64 tensors).
      cb: optional ``(m,)`` cumulative LB_Keogh suffix sums, tightening the
        abandon threshold per row.

    Runs on the device of ``t`` in the common floating dtype of ``s`` and
    ``t`` (float32 at least). Returns a 0-d distance (``+inf`` when
    abandoned), or ``(distance, EAInfo)``.
    """
    s = torch.as_tensor(s)
    t = torch.as_tensor(t)
    n, m = s.shape[0], t.shape[0]
    if window is not None and n != m:
        raise ValueError("windowed EAPrunedDTW requires equal lengths")
    if window is not None and window >= m:
        window = None
    dtype = torch.promote_types(torch.promote_types(s.dtype, t.dtype),
                                torch.float32)
    dev = t.device
    s, t = s.to(device=dev, dtype=dtype), t.to(dtype)
    ub = torch.as_tensor(ub, dtype=dtype, device=dev)
    if cb is not None:
        cb = torch.as_tensor(cb, device=dev)
    cols = torch.arange(m, device=dev)
    big = torch.full((m,), BIG, dtype=dtype, device=dev)
    border = big[:1]

    prev = torch.full((m + 1,), BIG, dtype=dtype, device=dev)
    prev[0] = 0.0
    next_start = torch.zeros((), dtype=torch.long, device=dev)
    ok_last = torch.zeros((), dtype=torch.bool, device=dev)
    abandoned = False
    rows = 0
    cells = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(n):
        # Window clipping acts like permanent discard points on the left.
        if window is None:
            ns = next_start
            exists = cols >= ns
        else:
            ns = torch.clamp_min(next_start, i - window)
            exists = (cols >= ns) & ((cols - i).abs() <= window)
        c = cost_row(s[i][None], t[None])[0]  # repro's _cost_row
        d = c + torch.minimum(prev[1:], prev[:-1])
        d = torch.where(exists, d, big)
        curr = torch.clamp_max(row_scan(d, c), BIG)
        curr = torch.where(exists, curr, big)
        le = (curr <= _row_threshold(ub, cb, i, window, m)) & exists
        rows += 1
        cells = cells + exists.sum()
        if not bool(le.any()):  # the border collision: abandon
            abandoned = True
            break
        # next_start' = first column <= thr (the discard-point prefix rule).
        next_start = le.to(torch.int8).argmax()
        prev = torch.cat([border, curr])
        ok_last = le[m - 1]
    # The paper's final check: the last row's last column must have been
    # <= ub (pruning_point > l_co), otherwise the result is proven > ub.
    if abandoned or not bool(ok_last):
        result = torch.full((), float("inf"), dtype=dtype, device=dev)
    else:
        result = to_inf(prev[m])
    if with_info:
        return result, EAInfo(
            rows=torch.tensor(rows, dtype=torch.int64, device=dev),
            cells=cells)
    return result


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
