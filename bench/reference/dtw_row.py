"""The plain EAPrunedDTW row, frozen: the benchmark's yardstick of DTW work.

A copy of ``repro_torch/kernels/dtw_band.py::dtw_ea_plain`` with the
helpers it reaches (``core/common.py::row_scan`` and ``BIG``,
``core/lower_bounds.py::cascade_keogh_cumulative``), taken so that the cells
the benchmark counts never follow a change to the program. One change: the
arithmetic runs in the dtype of ``windows`` (the source fixes float32), so
the reference can run the same row in float64 and the control in bfloat16.
In float32 it gives the source's bits and counts
(``bench/tests/test_bench_reference.py``).
"""
from __future__ import annotations

import torch

BIG = 1.0e30  # pruned-cell sentinel (finite stand-in for +inf)


def row_scan(d: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``curr[j] = min(d[j], c[j] + curr[j-1]) = P[j] + cummin(d - P)[j]``
    with ``P`` the inclusive prefix sum of ``c``."""
    p = torch.cumsum(c, dim=-1)
    return p + torch.cummin(d - p, dim=-1).values


def keogh_terms(c: torch.Tensor, u: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """Per-sample LB_Keogh terms of candidates ``c`` against ``(u, low)``."""
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    over = torch.where(c > u, c - u, zero)
    under = torch.where(c < low, low - c, zero)
    return over * over + under * under


def cascade_keogh_cumulative(
    c: torch.Tensor, u: torch.Tensor, low: torch.Tensor
) -> torch.Tensor:
    """UCR ``cb`` array: ``cb[j] = sum_{i >= j} term(i)``."""
    terms = keogh_terms(c, u, low)
    return torch.flip(torch.cumsum(torch.flip(terms, (-1,)), dim=-1), (-1,))


def dtw_ea_row(
    queries: torch.Tensor,
    windows: torch.Tensor,
    ub: torch.Tensor,
    window: int,
    band_width: int,
    cb: torch.Tensor | None = None,
    count: bool = False,
):
    """``(Q, K)`` distances, ``+inf`` where a lane abandoned.

    ``queries`` ``(Q, n)``, ``windows`` ``(Q, K, m)`` normalized windows,
    ``ub`` ``(Q, K)`` per-lane bounds (negative: the lane dies on row 0),
    ``band_width`` at least ``2 * window + 1`` (or ``m``), ``cb`` an
    optional ``(Q, K, m)`` cb slab. With ``count`` it also returns per-lane
    ``(rows, cells)``: rows issued (the abandoning row included) and
    admissible cells across them.
    """
    nq, n = queries.shape
    k, m = windows.shape[1], windows.shape[2]
    w, bw = int(window), int(band_width)
    dev, dt = windows.device, windows.dtype
    lanes = nq * k
    win = windows.reshape(lanes, m)
    if cb is not None:
        cb = cb.reshape(lanes, m)
    qrow = queries.to(dt).repeat_interleave(k, dim=0)          # (L, n)
    ubl = ub.to(dt).reshape(lanes)

    out = torch.full((lanes,), float("inf"), dtype=dt, device=dev)
    rows = torch.zeros(lanes, dtype=torch.int32, device=dev)
    cells = torch.zeros(lanes, dtype=torch.int32, device=dev)
    live = torch.arange(lanes, device=dev)   # lanes still running
    prev = torch.full((lanes, bw), BIG, dtype=dt, device=dev)
    ns = torch.zeros(lanes, dtype=torch.long, device=dev)
    rel = torch.arange(bw, device=dev)
    lo_max = m - bw
    for i in range(n):
        if live.numel() == 0:
            break
        lo = min(max(i - w, 0), lo_max)
        shift = lo - min(max(i - 1 - w, 0), lo_max)
        cols = lo + rel
        c = (qrow[live, i : i + 1] - win[live, lo : lo + bw]) ** 2
        exists = (cols >= ns[:, None]) & (cols >= i - w) & (cols <= min(m - 1, i + w))
        big_col = torch.full((live.numel(), 1), BIG, dtype=dt, device=dev)
        if shift:
            top = torch.cat([prev[:, 1:], big_col], dim=1)
            left = prev
        else:
            top = prev
            border = big_col if i else torch.zeros_like(big_col)
            left = torch.cat([border, prev[:, :-1]], dim=1)
        d = torch.where(exists, c + torch.minimum(top, left), BIG)
        curr = torch.clamp_max(row_scan(d, c), BIG)
        curr = torch.where(exists, curr, BIG)
        thr = ubl[live]
        if cb is not None and i + w + 1 <= m - 1:
            thr = thr - cb[live, i + w + 1]
        le = (curr <= thr[:, None]) & exists
        any_le = le.any(dim=1)
        if count:
            rows[live] += 1
            cells[live] += exists.sum(dim=1, dtype=torch.int32)
        if i == n - 1:
            ok = any_le & (le & (cols == m - 1)).any(dim=1)
            lo_fin = min(max(n - 1 - w, 0), lo_max)
            out[live[ok]] = curr[ok, (m - 1) - lo_fin]
            break
        ns = torch.where(le, cols, m).min(dim=1).values
        if bool(any_le.all()):
            prev = curr
        else:  # drop the lanes that abandoned on this row
            live, prev, ns = live[any_le], curr[any_le], ns[any_le]
    out = out.reshape(nq, k)
    if count:
        return out, rows.reshape(nq, k), cells.reshape(nq, k)
    return out
