"""Exact DTW by the closed-form row recurrence (port of ``repro/core/dtw.py``).

The unpruned DTW the paper's technique accelerates, and the distance of the
``full`` baseline (the UCR suite). One step a row, the whole ``(lanes, m)``
row at once: the sequential left-neighbour chain
``curr[j] = min(d[j], c[j] + curr[j-1])`` is solved in closed form by
``row_scan`` (prefix sum plus prefix minimum), with ``repro``'s ``BIG``
border and window mask. Univariate ``(n,)`` and multivariate ``(n, dims)``
series with the squared-Euclidean cost, and a Sakoe-Chiba window for equal
lengths.

``repro`` computes this with ``lax.scan``, outside any Pallas kernel, so it
runs here as PyTorch ops on whichever device holds the tensors: about a
dozen launches a row on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import BIG, row_scan, to_inf


def cost_row(x_i: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean cost of one point a lane, ``x_i`` ``(B[, dims])``,
    against every point of its series ``t`` ``(B, m[, dims])``: ``(B, m)``."""
    diff = x_i[:, None] - t
    if diff.dim() == 2:
        return diff * diff
    return torch.sum(diff * diff, dim=-1)


def as_lanes(queries: torch.Tensor, candidates: torch.Tensor):
    """Pairwise lanes ``(B, n[, dims])`` and ``(B, m[, dims])`` in their
    common dtype (float32 at least, as ``repro``'s ``result_type``)."""
    dtype = torch.promote_types(
        torch.promote_types(queries.dtype, candidates.dtype), torch.float32)
    s, t = queries.to(dtype), candidates.to(dtype)
    if s.shape[0] != t.shape[0] or s.dim() != t.dim():
        raise ValueError(f"queries {tuple(s.shape)} and candidates "
                         f"{tuple(t.shape)} are not pairwise lanes")
    return s, t


def resolve_window(window: int | None, n: int, m: int) -> int | None:
    """``repro``'s window rule: equal lengths required, and a window of at
    least ``m`` is no window."""
    if window is not None and n != m:
        raise ValueError("windowed DTW requires equal lengths")
    if window is not None and window >= m:
        return None
    return window


def dtw_batch(queries: torch.Tensor, candidates: torch.Tensor,
              window: int | None = None) -> torch.Tensor:
    """Pairwise-batched exact DTW: ``queries`` ``(B, n[, dims])`` against
    ``candidates`` ``(B, m[, dims])``, ``(B,)`` distances (``+inf`` where
    the window admits no path)."""
    s, t = as_lanes(queries, candidates)
    nb, n, m = s.shape[0], s.shape[1], t.shape[1]
    window = resolve_window(window, n, m)
    dev, dtype = t.device, t.dtype
    cols = torch.arange(m, device=dev)
    border = torch.full((nb, 1), BIG, dtype=dtype, device=dev)
    prev = torch.full((nb, m + 1), BIG, dtype=dtype, device=dev)
    prev[:, 0] = 0.0  # the (0, 0) corner border cell
    for i in range(n):
        c = cost_row(s[:, i], t)
        # d[j] = c[j] + min(prev[j], prev[j-1]); prev's column 0 is the border.
        d = c + torch.minimum(prev[:, 1:], prev[:, :-1])
        if window is not None:
            in_win = (cols - i).abs() <= window
            d = torch.where(in_win, d, BIG)
        curr = row_scan(d, c)
        if window is not None:
            curr = torch.where(in_win, curr, BIG)
        curr = torch.clamp_max(curr, BIG)  # keep sentinel arithmetic bounded
        prev = torch.cat([border, curr], dim=1)
    return to_inf(prev[:, m])


def dtw(s: torch.Tensor, t: torch.Tensor,
        window: int | None = None) -> torch.Tensor:
    """Exact DTW distance between ``s`` ``(n[, dims])`` (the scanned rows)
    and ``t`` ``(m[, dims])``: a 0-d tensor, ``+inf`` if the window admits
    no path."""
    return dtw_batch(s[None], t[None], window=window)[0]


def dtw_matrix(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The full ``(n + 1, m + 1)`` DTW matrix without a window (paper Fig.
    2a), border row and column included, ``+inf`` for the border's BIG."""
    dtype = torch.float64 if s.dtype == torch.float64 else torch.float32
    s, t = s.to(dtype)[None], t.to(dtype)[None]
    m = t.shape[1]
    border = torch.full((1, 1), BIG, dtype=dtype, device=t.device)
    prev = torch.full((1, m + 1), BIG, dtype=dtype, device=t.device)
    prev[:, 0] = 0.0
    rows = [prev]
    for i in range(s.shape[1]):
        c = cost_row(s[:, i], t)
        d = c + torch.minimum(prev[:, 1:], prev[:, :-1])
        prev = torch.cat([border, row_scan(d, c)], dim=1)
        rows.append(prev)
    return to_inf(torch.cat(rows, dim=0))
