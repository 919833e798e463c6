"""Kernel A: one fused EAPrunedDTW round over Q x K lanes.

The CUDA kernel is ``csrc/dtw_ea_fused.cu`` (it replaces
``repro/kernels/dtw_band.py::_dtw_ea_fused_kernel``; its source says what
bounds it on the card and what its design does about that). This module
holds its plain PyTorch version: a lane-batched banded DP with the same
program as the kernel — the lane-uniform window-following band offset
``lo(i) = clip(i - w, 0, m - bw)`` with its 0/1 shift, the closed-form row
``P + cummin(d - P)``, per-lane ``next_start`` and ``ub - cb[i + w + 1]``
abandoning, ``ok_last`` on the last row, and NaN for a lane whose start lies
outside ``[0, N - m]``. The wrapper
``kernels.ops.dtw_ea_multi_fused`` runs it for CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import BIG, row_scan
from repro_torch.core.lower_bounds import cascade_keogh_cumulative


def dtw_ea_fused_plain(
    queries: torch.Tensor,
    ref: torch.Tensor,
    starts: torch.Tensor,
    mu: torch.Tensor,
    sg: torch.Tensor,
    ub: torch.Tensor,
    window: int,
    length: int,
    band_width: int,
    u: torch.Tensor | None = None,
    low: torch.Tensor | None = None,
    use_cb: bool = False,
    count: bool = False,
):
    """``(Q, K)`` distances, ``+inf`` where a lane abandoned.

    Arguments as ``kernels.ops.dtw_ea_multi_fused`` after its resolution:
    ``sg`` is clamped, ``band_width`` is the resolved band. With ``count``
    it also returns per-lane ``(rows, cells)``: rows issued (the abandoning
    row included) and admissible cells across them (``EAInfo`` semantics),
    which is the work this round's data needs.
    """
    nq, n = queries.shape
    k = starts.shape[1]
    m, w, bw = int(length), int(window), int(band_width)
    dev, dt = ref.device, torch.float32
    lanes = nq * k
    s = starts.long()
    bad = ((s < 0) | (s > ref.shape[0] - m)).reshape(lanes)
    idx = s.clamp(0, ref.shape[0] - m)[..., None] + torch.arange(m, device=dev)
    win = (ref[idx] - mu[..., None]) / sg[..., None]          # (Q, K, m)
    cb = None
    if use_cb:
        cb = cascade_keogh_cumulative(win, u[:, None, :], low[:, None, :])
        cb = cb.reshape(lanes, m)
    win = win.reshape(lanes, m)
    qrow = queries.repeat_interleave(k, dim=0)                 # (L, n)
    ubl = torch.where(bad, -1.0, ub.reshape(lanes))  # runs no row

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
        if use_cb and i + w + 1 <= m - 1:
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
    out = torch.where(bad, float("nan"), out).reshape(nq, k)
    if count:
        return out, rows.reshape(nq, k), cells.reshape(nq, k)
    return out
