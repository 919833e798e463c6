"""Plain PyTorch versions of the port's DTW kernels A, C, D and E.

The CUDA kernels are ``csrc/dtw_ea_fused.cu`` (A), ``csrc/dtw_ea_slab.cu``
(D) and ``csrc/dtw_ea_persistent.cu`` (C and E); they replace
``repro/kernels/dtw_band.py::_dtw_ea_fused_kernel``, ``_dtw_ea_kernel`` and
``_dtw_ea_persistent_kernel`` (both forms), and all four run the one DP of
``csrc/dtw_band.cuh``. Here that DP is :func:`dtw_ea_plain`, a lane-batched
banded DP over a ``(Q, K, m)`` window slab with the same program as the
kernels: the lane-uniform window-following band offset
``lo(i) = clip(i - w, 0, m - bw)`` with its 0/1 shift, the closed-form row
``P + cummin(d - P)``, per-lane ``next_start`` and ``ub - cb[i + w + 1]``
abandoning, and ``ok_last`` on the last row. It is kernel D's plain version;
kernel A's gathers and normalizes its windows and calls it, and the two
persistent sweeps call it on chunks of their best-first lanes. The wrappers
in ``kernels.ops`` run these for CPU tensors, and ``chip_smoke.py`` holds
each kernel against its plain version on the card.

No import of ``core.batch`` here: that module imports ``kernels.ops``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.common import BIG, DEAD_LANE_UB, row_scan
from repro_torch.core.lower_bounds import cascade_keogh_cumulative

# Best-first lanes a persistent plain sweep evaluates together (per query).
SWEEP_CHUNK = 1024


def dtw_ea_plain(
    queries: torch.Tensor,
    windows: torch.Tensor,
    ub: torch.Tensor,
    window: int,
    band_width: int,
    cb: torch.Tensor | None = None,
    count: bool = False,
):
    """``(Q, K)`` distances of a slab round, ``+inf`` where a lane abandoned.

    Arguments as ``kernels.ops.dtw_ea_multi`` after its resolution:
    ``queries`` ``(Q, n)``, ``windows`` ``(Q, K, m)`` normalized windows,
    ``ub`` ``(Q, K)`` per-lane bounds (negative: the lane dies on row 0),
    ``band_width`` the resolved band, ``cb`` an optional ``(Q, K, m)`` cb
    slab. With ``count`` it also returns per-lane ``(rows, cells)``: rows
    issued (the abandoning row included) and admissible cells across them
    (``EAInfo`` semantics), which is the work this round's data needs.
    """
    nq, n = queries.shape
    k, m = windows.shape[1], windows.shape[2]
    w, bw = int(window), int(band_width)
    dev, dt = windows.device, torch.float32
    lanes = nq * k
    win = windows.reshape(lanes, m)
    if cb is not None:
        cb = cb.reshape(lanes, m)
    qrow = queries.repeat_interleave(k, dim=0)                 # (L, n)
    ubl = ub.reshape(lanes)

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


def gather_norm_lanes(
    ref: torch.Tensor,
    starts: torch.Tensor,
    mu: torch.Tensor,
    sg: torch.Tensor,
    length: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lane windows ``(..., m)`` normalized as the fused kernels do,
    ``(x - mu) / sg`` with ``sg`` clamped already, and the mask of lanes
    whose start lies outside ``[0, N - m]`` (their windows are those of the
    clamped start, and must not be used)."""
    m = int(length)
    s = starts.long()
    bad = (s < 0) | (s > ref.shape[0] - m)
    idx = s.clamp(0, ref.shape[0] - m)
    win = ref.unfold(0, m, 1)[idx]
    return (win - mu[..., None]) / sg[..., None], bad


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
    """Kernel A's plain version: ``(Q, K)`` distances, ``+inf`` where a lane
    abandoned, NaN where its start lies outside ``[0, N - m]``.

    Arguments as ``kernels.ops.dtw_ea_multi_fused`` after its resolution:
    ``sg`` is clamped, ``band_width`` is the resolved band. ``count`` as in
    :func:`dtw_ea_plain`.
    """
    win, bad = gather_norm_lanes(ref, starts, mu, sg, length)
    cb = None
    if use_cb:
        cb = cascade_keogh_cumulative(win, u[:, None, :], low[:, None, :])
    ub = torch.where(bad, DEAD_LANE_UB, ub)  # runs no row
    res = dtw_ea_plain(queries, win, ub, window, band_width, cb=cb,
                       count=count)
    out = res[0] if count else res
    out = torch.where(bad, float("nan"), out)
    return (out, *res[1:]) if count else out


def _sweep(lb, starts, ub_init, block_k, evaluate, chunk):
    """The sequential best-first block sweep of ``repro``'s
    ``core/batch.py::block_sweep`` for Q queries at once.

    A block runs iff its head ``lb`` is below the carried incumbent; a lane
    of a running block with ``lb >= ub`` is dead; the fold is strict
    improvement with the first lane on ties; the sweep of a query ends at its
    first gated block. Lanes are evaluated ``chunk`` at a time, each chunk at
    the incumbent its sweep held when the chunk began (``evaluate(lo, hi,
    ub_lanes)`` gives the ``(Q, hi - lo)`` distances), and the gate and fold
    are then replayed block by block on the host, in numpy (a block is a few
    lanes; device launches would cost more than the work). That gives the
    sequential sweep's ``(best_dist, best_start, blocks)``: the incumbent
    only falls, so a lane that abandons under the chunk's ``ub`` abandons
    under its block's too, and a lane that finishes has the same distance
    under any ``ub`` it finishes under (``csrc/dtw_band.cuh``;
    ``tests/test_torch_persistent.py`` checks it), so a distance at or above
    its block's ``ub`` cannot fold.
    """
    nq, k = lb.shape
    dev = lb.device
    inf = np.float32(np.inf)
    ub = ub_init.to(torch.float32).cpu().numpy().copy()
    best = np.full(nq, -1, dtype=np.int32)
    blocks = np.zeros(nq, dtype=np.int32)
    on = np.ones(nq, dtype=bool)  # still sweeping
    n_blocks = -(-k // block_k)
    per = max(int(chunk) // block_k, 1)  # blocks per chunk
    q_ix = np.arange(nq)
    for b0 in range(0, n_blocks, per):
        lo, hi = b0 * block_k, min(k, (b0 + per) * block_k)
        lbc = lb[:, lo:hi]
        lbn = lbc.cpu().numpy()
        on &= lbn[:, 0] < ub
        if not on.any():
            break
        ub_t = torch.tensor(ub, device=dev)
        live = torch.tensor(on, device=dev)[:, None] & (lbc < ub_t[:, None])
        d = evaluate(lo, hi, torch.where(live, ub_t[:, None], DEAD_LANE_UB))
        d = torch.where(live & torch.isfinite(lbc), d, float("inf"))
        dn = d.cpu().numpy()
        sn = starts[:, lo:hi].cpu().numpy()
        for b in range(b0, min(b0 + per, n_blocks)):
            s, e = b * block_k - lo, min(k, (b + 1) * block_k) - lo
            on &= lbn[:, s] < ub
            if not on.any():
                break
            dd = np.where(on[:, None] & (lbn[:, s:e] < ub[:, None]),
                          dn[:, s:e], inf)
            j = dd.argmin(axis=1)
            dmin = dd[q_ix, j]
            imp = dmin < ub
            ub = np.where(imp, dmin, ub)
            best = np.where(imp, sn[q_ix, s + j].astype(np.int32), best)
            blocks += on
    return (torch.tensor(ub, device=dev), torch.tensor(best, device=dev),
            torch.tensor(blocks, device=dev))


def dtw_ea_persistent_plain(
    queries: torch.Tensor,
    windows: torch.Tensor,
    lb: torch.Tensor,
    starts: torch.Tensor,
    ub_init: torch.Tensor,
    window: int,
    band_width: int,
    block_k: int,
    u: torch.Tensor | None = None,
    low: torch.Tensor | None = None,
    use_cb: bool = False,
    chunk: int = SWEEP_CHUNK,
):
    """Kernel E's plain version: the best-first sweep over a ``(Q, K, m)``
    slab of windows in ascending-``lb`` order. Returns ``(best_dist,
    best_start, blocks)``, ``(Q,)`` each, as ``repro``'s sequential sweep
    gives them (see :func:`_sweep`); with ``use_cb`` each lane's cb suffix is
    built from its window and the query envelope ``(u, low)``."""

    def evaluate(lo, hi, ub_lanes):
        win = windows[:, lo:hi]
        cb = None
        if use_cb:
            cb = cascade_keogh_cumulative(win, u[:, None, :], low[:, None, :])
        return dtw_ea_plain(queries, win, ub_lanes, window, band_width, cb=cb)

    return _sweep(lb, starts, ub_init, block_k, evaluate, chunk)


def dtw_ea_persistent_fused_plain(
    queries: torch.Tensor,
    ref: torch.Tensor,
    lb: torch.Tensor,
    starts: torch.Tensor,
    mu: torch.Tensor,
    sg: torch.Tensor,
    ub_init: torch.Tensor,
    window: int,
    length: int,
    band_width: int,
    block_k: int,
    u: torch.Tensor | None = None,
    low: torch.Tensor | None = None,
    use_cb: bool = False,
    chunk: int = SWEEP_CHUNK,
):
    """Kernel C's plain version: :func:`dtw_ea_persistent_plain` with each
    chunk's windows sliced from ``ref`` and normalized as kernel A does
    (``sg`` clamped already). Returns ``(best_dist, best_start, blocks,
    bad)``: ``bad`` ``(Q,)`` counts each query's lanes whose start lies
    outside ``[0, N - m]``; those lanes never run and never win."""
    s = starts.long()
    bad = ((s < 0) | (s > ref.shape[0] - int(length))).sum(dim=1)

    def evaluate(lo, hi, ub_lanes):
        win, out = gather_norm_lanes(ref, starts[:, lo:hi], mu[:, lo:hi],
                                     sg[:, lo:hi], length)
        cb = None
        if use_cb:
            cb = cascade_keogh_cumulative(win, u[:, None, :], low[:, None, :])
        ub_lanes = torch.where(out, DEAD_LANE_UB, ub_lanes)
        return dtw_ea_plain(queries, win, ub_lanes, window, band_width, cb=cb)

    return (*_sweep(lb, starts, ub_init, block_k, evaluate, chunk),
            bad.to(torch.int32))
