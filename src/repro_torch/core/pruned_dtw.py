"""PrunedDTW, the UCR-USP baseline (port of ``repro/core/pruned_dtw.py``).

The algorithm EAPrunedDTW improves on (Silva & Batista 2016, UCR-USP 2018).
It prunes from the left as EAPrunedDTW does (``next_start``, the first
cell of the row at or under ``ub``) but abandons only when the *row
minimum* exceeds ``ub``, and it evaluates every in-window cell right of
``next_start``. Lanes step through the rows together, each with its own
state: ``repro`` vmaps one ``lax.while_loop`` per lane, here a lane that
abandoned freezes and the loop ends once every lane has. The ``EAInfo``
counters come from the masks (a lane counts the rows it entered, the
abandoning row included, and the cells that existed in them), not from the
loop count.

As ``core/dtw.py``, PyTorch ops on whichever device holds the tensors;
``repro`` runs it outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.common import BIG, row_scan, to_inf
from repro_torch.core.dtw import as_lanes, cost_row, resolve_window
from repro_torch.core.ea_pruned_dtw import EAInfo

# Rows between two checks whether every lane has abandoned (each check is
# a host sync; rows run after a lane froze change nothing of it).
DEAD_CHECK_ROWS = 32


def pruned_dtw_batch(
    queries: torch.Tensor,
    candidates: torch.Tensor,
    ub,
    window: int | None = None,
    with_info: bool = False,
):
    """Pairwise-batched PrunedDTW: ``queries`` ``(B, n[, dims])`` against
    ``candidates`` ``(B, m[, dims])`` under ``ub``, a scalar or ``(B,)``.

    Returns ``(B,)`` distances, ``+inf`` where a lane abandoned or its
    distance exceeds its ``ub``; with ``with_info`` a ``(distances,
    EAInfo)`` pair of ``(B,)`` int32 counters.
    """
    s, t = as_lanes(queries, candidates)
    nb, n, m = s.shape[0], s.shape[1], t.shape[1]
    window = resolve_window(window, n, m)
    dev, dtype = t.device, t.dtype
    ub_l = torch.as_tensor(ub, dtype=dtype, device=dev).reshape(-1).expand(nb)
    cols = torch.arange(m, device=dev)
    border = torch.full((nb, 1), BIG, dtype=dtype, device=dev)
    prev = torch.full((nb, m + 1), BIG, dtype=dtype, device=dev)
    prev[:, 0] = 0.0
    next_start = torch.zeros(nb, dtype=torch.long, device=dev)
    abandoned = torch.zeros(nb, dtype=torch.bool, device=dev)
    rows = torch.zeros(nb, dtype=torch.int32, device=dev)
    cells = torch.zeros(nb, dtype=torch.int32, device=dev)
    for i in range(n):
        if i and i % DEAD_CHECK_ROWS == 0 and bool(abandoned.all()):
            break
        active = ~abandoned
        if window is None:
            ns = next_start
            exists = cols >= ns[:, None]
        else:
            ns = torch.clamp_min(next_start, i - window)
            exists = (cols >= ns[:, None]) & ((cols - i).abs() <= window)
        c = cost_row(s[:, i], t)
        d = torch.where(exists, c + torch.minimum(prev[:, 1:], prev[:, :-1]),
                        BIG)
        curr = torch.clamp_max(row_scan(d, c), BIG)
        curr = torch.where(exists, curr, BIG)
        le = (curr <= ub_l[:, None]) & exists
        # The PrunedDTW rule: abandon iff the row minimum exceeds ub.
        stop = curr.min(dim=1).values > ub_l
        upd = active & ~stop
        prev = torch.where(upd[:, None], torch.cat([border, curr], dim=1),
                           prev)
        ns_new = le.to(torch.int8).argmax(dim=1)
        next_start = torch.where(upd, ns_new,
                                 torch.where(active, ns, next_start))
        abandoned = abandoned | (active & stop)
        rows += active.to(torch.int32)
        cells += torch.where(active, exists.sum(dim=1, dtype=torch.int32), 0)
    val = to_inf(prev[:, m])
    out = torch.where(abandoned | (val > ub_l), float("inf"), val)
    if with_info:
        return out, EAInfo(rows=rows, cells=cells)
    return out


def pruned_dtw(
    s: torch.Tensor,
    t: torch.Tensor,
    ub,
    window: int | None = None,
    with_info: bool = False,
):
    """PrunedDTW of ``s`` ``(n[, dims])`` against ``t`` ``(m[, dims])``:
    a 0-d distance (``+inf`` past ``ub``), with ``with_info`` a
    ``(distance, EAInfo)`` pair of 0-d counters."""
    out = pruned_dtw_batch(s[None], t[None], ub, window=window,
                           with_info=with_info)
    if with_info:
        d, info = out
        return d[0], EAInfo(rows=info.rows[0], cells=info.cells[0])
    return out[0]
