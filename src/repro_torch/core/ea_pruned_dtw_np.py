"""Literal NumPy transcription of the paper's algorithms (cell-level oracles).

A copy of ``repro/core/ea_pruned_dtw_np.py`` (numpy only), so the port
needs nothing from ``repro``. These are loop-per-cell transcriptions of
Algorithm 1 (O(n) space DTW), Algorithm 2 (pruning from the left) and
Algorithm 3 (EAPrunedDTW) from Herrmann & Webb 2020, and of the UCR-USP
PrunedDTW baseline: the ground-truth oracles the vectorized forms are
tested against.

Conventions follow the paper: 1-based series indexing inside the DP, `co` is
the shorter series, `li` the longer, `cost` is the squared difference.
All functions also expose per-row band traces (``next_start`` /
``pruning_point`` per row) so tests can assert the vectorized versions make
*identical* pruning decisions, not merely identical results.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

INF = math.inf


def _split(s: np.ndarray, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (co, li) = (shorter, longer); ties keep ``s`` as the line series
    (rows), matching the paper's figures."""
    if len(s) >= len(t):
        return np.asarray(t, dtype=np.float64), np.asarray(s, dtype=np.float64)
    return np.asarray(s, dtype=np.float64), np.asarray(t, dtype=np.float64)


def dtw_naive(s: np.ndarray, t: np.ndarray, window: int | None = None) -> float:
    """O(n*m) full-matrix DTW (Figure 1 equations). Reference of references."""
    s = np.asarray(s, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    n, m = len(s), len(t)
    if window is not None and n != m:
        raise ValueError("windowed DTW requires equal lengths here")
    M = np.full((n + 1, m + 1), INF)
    M[0, 0] = 0.0
    for i in range(1, n + 1):
        lo, hi = 1, m
        if window is not None:
            lo, hi = max(1, i - window), min(m, i + window)
        for j in range(lo, hi + 1):
            c = (s[i - 1] - t[j - 1]) ** 2
            M[i, j] = c + min(M[i - 1, j], M[i, j - 1], M[i - 1, j - 1])
    return float(M[n, m])


def dtw_rows(s: np.ndarray, t: np.ndarray) -> float:
    """Algorithm 1: O(n) space DTW, literal transcription."""
    co, li = _split(s, t)
    lco, lli = len(co), len(li)
    prev = np.full(lco + 1, INF)
    curr = np.full(lco + 1, INF)
    curr[0] = 0.0
    for i in range(1, lli + 1):
        prev, curr = curr, prev
        curr[0] = INF
        for j in range(1, lco + 1):
            c = (li[i - 1] - co[j - 1]) ** 2
            curr[j] = c + min(curr[j - 1], prev[j], prev[j - 1])
    return float(curr[lco])


def pruned_left(s: np.ndarray, t: np.ndarray, ub: float) -> float:
    """Algorithm 2: pruning from the left, literal transcription."""
    co, li = _split(s, t)
    lco, lli = len(co), len(li)
    prev = np.full(lco + 1, INF)
    curr = np.full(lco + 1, INF)
    curr[0] = 0.0
    next_start = 1
    for i in range(1, lli + 1):
        prev, curr = curr, prev
        j = next_start
        curr[j - 1] = INF
        # stage 1: successive discard points (no left dependency)
        while j == next_start and j <= lco:
            c = (li[i - 1] - co[j - 1]) ** 2
            curr[j] = c + min(prev[j], prev[j - 1])
            if curr[j] > ub:
                next_start += 1
            j += 1
        # Paper line 15 reads ``if j > l_co then return inf``; taken literally
        # it also abandons when the one sub-ub cell sits exactly in the last
        # column (j == next_start + 1 == l_co + 1), which over-prunes. We keep
        # the intended semantics: abandon iff the whole row was discard points.
        if j == next_start:  # implies next_start > lco
            return INF
        # stage 2: normal DTW computation
        while j <= lco:
            c = (li[i - 1] - co[j - 1]) ** 2
            curr[j] = c + min(curr[j - 1], prev[j], prev[j - 1])
            j += 1
    return float(curr[lco])


@dataclass
class EATrace:
    """Row-level band decisions, for equivalence testing."""

    next_start: list[int] = field(default_factory=list)
    pruning_point: list[int] = field(default_factory=list)
    abandoned_at_row: int = -1  # -1 = completed all rows
    rows_computed: int = 0
    cells_computed: int = 0


def ea_pruned_dtw(
    s: np.ndarray,
    t: np.ndarray,
    ub: float,
    window: int | None = None,
    trace: EATrace | None = None,
    cb: np.ndarray | None = None,
) -> float:
    """Algorithm 3: EAPrunedDTW, literal transcription (+ optional window).

    The paper presents the algorithm without a warping window "for clarity's
    sake"; the experiments require one. The windowed extension (equal lengths
    only) clips each row's column range to ``[i-window, i+window]`` exactly as
    the UCR suites do, interacting with the band pointers as in the MonashTS
    reference implementation.
    """
    co, li = _split(s, t)
    lco, lli = len(co), len(li)
    if window is not None:
        if lco != lli:
            raise ValueError("windowed EAPrunedDTW requires equal lengths")
        if window >= lco:
            window = None
    # ub = +inf needs no special casing: no cell ever exceeds it, so the
    # algorithm degrades gracefully to the plain row-by-row DTW.

    prev = np.full(lco + 1, INF)
    curr = np.full(lco + 1, INF)
    curr[0] = 0.0
    next_start = 1
    prev_pruning_point = 1
    pruning_point = 0

    def cost(i: int, j: int) -> float:
        return (li[i - 1] - co[j - 1]) ** 2

    ub_base = ub
    for i in range(1, lli + 1):
        prev, curr = curr, prev
        # UCR-suite upper-bound tightening: remaining columns beyond i+w
        # contribute at least cb[i+w+1] (0-based), so tighten the threshold.
        if cb is not None:
            w = 0 if window is None else window
            nxt = i + w  # 0-based index of column (i + w + 1) in paper terms
            ub = ub_base - (cb[nxt] if nxt <= lco - 1 else 0.0)
        # window clipping of this row's admissible columns
        if window is None:
            wlo, whi = 1, lco
        else:
            wlo, whi = max(1, i - window), min(lco, i + window)
        if next_start < wlo:
            next_start = wlo  # the window border acts like discard points
        j = next_start
        curr[j - 1] = INF
        cells = 0

        # stage 1: while within the discard-point prefix (deps: top, diag)
        while j == next_start and j < prev_pruning_point:
            c = cost(i, j)
            curr[j] = c + min(prev[j], prev[j - 1])
            cells += 1
            if curr[j] <= ub:
                pruning_point = j + 1
            else:
                next_start += 1
            j += 1
        # stage 2: normal 3-way computation below previous pruning point
        while j < prev_pruning_point:
            c = cost(i, j)
            curr[j] = c + min(curr[j - 1], prev[j], prev[j - 1])
            cells += 1
            if curr[j] <= ub:
                pruning_point = j + 1
            j += 1
        # stage 3: at the previous pruning point column
        if j <= whi:
            c = cost(i, j)
            if j == next_start:
                curr[j] = c + prev[j - 1]
                cells += 1
                if curr[j] <= ub:
                    pruning_point = j + 1
                else:
                    if trace is not None:
                        trace.abandoned_at_row = i
                        trace.rows_computed = i
                        trace.cells_computed += cells
                    return INF  # border collision -> early abandon
            else:
                curr[j] = c + min(curr[j - 1], prev[j - 1])
                cells += 1
                if curr[j] <= ub:
                    pruning_point = j + 1
            j += 1
        else:
            if j == next_start:
                if trace is not None:
                    trace.abandoned_at_row = i
                    trace.rows_computed = i
                    trace.cells_computed += cells
                return INF  # whole row was discard points -> early abandon
        # stage 4: past the previous pruning point (dep: left only)
        while j == pruning_point and j <= whi:
            c = cost(i, j)
            curr[j] = c + curr[j - 1]
            cells += 1
            if curr[j] <= ub:
                pruning_point = j + 1
            j += 1

        prev_pruning_point = pruning_point
        if trace is not None:
            trace.next_start.append(next_start)
            trace.pruning_point.append(pruning_point)
            trace.rows_computed = i
            trace.cells_computed += cells

    if prev_pruning_point > lco:
        return float(curr[lco])
    return INF


def pruned_dtw_usp(
    s: np.ndarray, t: np.ndarray, ub: float, window: int | None = None
) -> float:
    """PrunedDTW as used in the UCR-USP suite (Silva et al. 2018) — baseline.

    Prunes from the left like Algorithm 2 and early abandons on the *row
    minimum* exceeding ``ub`` (the strategy EAPrunedDTW's border collision
    replaces). Cell values match exact DTW whenever the result is <= ub.
    """
    co, li = _split(s, t)
    lco, lli = len(co), len(li)
    if window is not None:
        if lco != lli:
            raise ValueError("windowed PrunedDTW requires equal lengths")
        if window >= lco:
            window = None
    prev = np.full(lco + 1, INF)
    curr = np.full(lco + 1, INF)
    curr[0] = 0.0
    next_start = 1
    for i in range(1, lli + 1):
        prev, curr = curr, prev
        if window is None:
            wlo, whi = 1, lco
        else:
            wlo, whi = max(1, i - window), min(lco, i + window)
        next_start = max(next_start, wlo)
        j = next_start
        curr[j - 1] = INF
        row_min = INF
        advancing = True
        while j <= whi:
            c = (li[i - 1] - co[j - 1]) ** 2
            curr[j] = c + min(curr[j - 1], prev[j], prev[j - 1])
            if curr[j] > ub:
                if advancing:
                    next_start += 1
            else:
                advancing = False
                row_min = min(row_min, curr[j])
            j += 1
        if row_min > ub:
            return INF
    if curr[lco] > ub:
        return INF
    return float(curr[lco])
