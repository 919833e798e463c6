"""The plain reference: exact subsequence DTW search, in plain PyTorch.

It imports nothing of the program. From the raw series and queries it works
out again what the program derives (window means and deviations, the
z-normalized queries and their envelopes, the lower bounds), in its own
precision (float64 by default), and answers three questions about a search
result:

- ``dtw``: the DTW distance of given windows, with no abandoning;
- ``certify``: the least DTW distance over the whole series and the first
  window that has it. Every window whose lower bound lies at or below a
  threshold is run with early abandoning against that threshold (any window
  whose bound lies above it cannot beat it), so the threshold must be the
  distance of some window: the program's answer as this reference scores it;
- ``count``: the rows and cells of those windows, each query against its
  own answer (``dtw_row.dtw_ea_row``'s ``EAInfo`` semantics), on a sample
  of them drawn from a seed: the least work of any exact best-first
  EAPrunedDTW search, which the kernels' rooflines divide by.

The bounds are the paper's cascade, ``max(LB_Kim_FL, LB_Keogh)`` with the
query's envelope, and the row abandons on the ``cb`` suffix of LB_Keogh,
as in the UCR suite.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference.dtw_row import (
    BIG,
    cascade_keogh_cumulative,
    dtw_ea_row,
    keogh_terms,
)

EPS = 1e-8          # sigma floor of a flat window or query
SLACK = 1e-9        # relative room over a threshold, for rounding of the bounds


class Queries(NamedTuple):
    z: torch.Tensor     # (Q, l) z-normalized queries
    u: torch.Tensor     # (Q, l) upper envelope
    low: torch.Tensor   # (Q, l) lower envelope


class Certified(NamedTuple):
    dist: float         # the least DTW distance over the series
    start: int          # the first window that has it
    live: int           # windows whose bound lies at or below the threshold
    ran: int            # windows run (``live``, or a sample of them)
    rows: int           # rows those windows issued (``count`` only)
    cells: int          # admissible cells across those rows (``count`` only)


def envelope(q: torch.Tensor, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Keogh envelope ``U[i] = max(q[i-w : i+w+1])``, ``L[i] = min(...)``."""
    w = int(window)
    x = q.reshape(-1, 1, q.shape[-1])
    k = 2 * w + 1
    hi = F.max_pool1d(F.pad(x, (w, w), value=float("-inf")), k, stride=1)
    lo = -F.max_pool1d(F.pad(-x, (w, w), value=float("-inf")), k, stride=1)
    return hi.reshape(q.shape), lo.reshape(q.shape)


class Reference:
    """Exact search over one series in ``dtype`` (window statistics in
    ``stats_dtype``, by default the same). ``budget`` bounds the bytes a
    batch of lanes may take on the device."""

    def __init__(self, series, length: int, window: int, device,
                 dtype=torch.float64, stats_dtype=None,
                 budget: int = 8 << 30):
        self.length, self.window = int(length), int(window)
        self.dtype = dtype
        self.sdt = stats_dtype or dtype
        self.device = torch.device(device)
        self.budget = int(budget)
        self.bw = min(self.length, 2 * self.window + 1)
        x = torch.as_tensor(np.asarray(series), device=self.device)
        self.x = x.to(self.sdt)
        l = self.length
        zero = torch.zeros(1, dtype=self.sdt, device=self.device)
        p = torch.cat([zero, torch.cumsum(self.x, 0)])
        q = torch.cat([zero, torch.cumsum(self.x * self.x, 0)])
        mu = (p[l:] - p[:-l]) / l
        var = torch.clamp_min((q[l:] - q[:-l]) / l - mu * mu, 0.0)
        self.mu = mu
        self.sd = torch.clamp_min(torch.sqrt(var), EPS)
        self.n_win = int(mu.shape[0])

    # -- inputs ---------------------------------------------------------------
    def queries(self, raw) -> Queries:
        """Z-normalize raw ``(Q, l)`` queries and build their envelopes."""
        q = torch.as_tensor(np.asarray(raw), device=self.device).to(self.sdt)
        q = q[:, : self.length]
        mu = q.mean(dim=-1, keepdim=True)
        sd = torch.clamp_min(q.std(dim=-1, keepdim=True, correction=0), EPS)
        z = ((q - mu) / sd).to(self.dtype)
        u, low = envelope(z, self.window)
        return Queries(z, u, low)

    def windows(self, starts: torch.Tensor) -> torch.Tensor:
        """``(..., l)`` z-normalized windows at ``starts``."""
        s = starts.to(device=self.device, dtype=torch.long)
        win = self.x.unfold(0, self.length, 1)[s]
        win = (win - self.mu[s][..., None]) / self.sd[s][..., None]
        return win.to(self.dtype)

    def _lanes_per_batch(self, per_lane_floats: int) -> int:
        size = torch.tensor([], dtype=self.dtype).element_size()
        return max(1, self.budget // (per_lane_floats * size))

    # -- bounds -----------------------------------------------------------------
    def lower_bounds(self, qs: Queries) -> torch.Tensor:
        """``(Q, n_win)`` ``max(LB_Kim_FL, LB_Keogh)`` of every window."""
        nq, l = qs.z.shape
        out = torch.empty((nq, self.n_win), dtype=self.dtype,
                          device=self.device)
        step = self._lanes_per_batch(4 * l)
        for lo in range(0, self.n_win, step):
            hi = min(self.n_win, lo + step)
            c = self.windows(torch.arange(lo, hi, device=self.device))
            for q in range(nq):
                keogh = keogh_terms(c, qs.u[q], qs.low[q]).sum(dim=-1)
                kim = ((c[:, 0] - qs.z[q, 0]) ** 2
                       + (c[:, -1] - qs.z[q, -1]) ** 2)
                out[q, lo:hi] = torch.maximum(keogh, kim)
        return out

    # -- distances --------------------------------------------------------------
    def dtw(self, z: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        """DTW of query rows ``z`` ``(Q, l)`` to the windows at ``starts``
        ``(Q, K)``, with no abandoning: ``(Q, K)``."""
        starts = starts.to(device=self.device, dtype=torch.long)
        win = self.windows(starts)
        ub = torch.full(starts.shape, BIG, dtype=self.dtype,
                        device=self.device)
        return dtw_ea_row(z, win, ub, self.window, self.bw)

    def certify(self, qs: Queries, q: int, lb: torch.Tensor,
                thr: float) -> Certified:
        """The least DTW of query ``q`` over the series, given ``thr``, the
        distance of one of its windows, and ``lb`` ``(n_win,)``, its lower
        bounds."""
        limit = float(thr) * (1 + SLACK)
        live = torch.nonzero(lb <= limit).flatten()
        best_d, best_s = float("inf"), -1
        z, u, low = qs.z[q:q + 1], qs.u[q:q + 1], qs.low[q:q + 1]
        step = self._lanes_per_batch(3 * self.length + 12 * self.bw)
        for lo in range(0, int(live.numel()), step):
            idx = live[lo:lo + step]
            win = self.windows(idx)[None]                      # (1, K, l)
            cb = cascade_keogh_cumulative(win, u[:, None, :], low[:, None, :])
            ub = torch.full((1, idx.numel()), limit, dtype=self.dtype,
                            device=self.device)
            d = dtw_ea_row(z, win, ub, self.window, self.bw, cb=cb)[0]
            d = d.to(torch.float64)
            m = float(d.min())
            if m < best_d:
                best_d = m
                best_s = int(idx[int(torch.nonzero(d == d.min())[0, 0])])
            del win, cb, ub, d
        n = int(live.numel())
        return Certified(best_d, best_s, n, n, 0, 0)

    def count(self, qs: Queries, lbs: torch.Tensor, thrs, sample: int,
              seed: int = 0) -> list[Certified]:
        """Rows and cells of every query of ``qs`` on up to ``sample`` of its
        live windows (bound at or below its threshold in ``thrs``), drawn
        from ``seed``, each run against that threshold with the ``cb``
        bound. One pass of the row covers all the queries' ``(Q, sample)``
        lanes (a query with fewer pads with dead lanes), so a count over
        many queries is not bound by launches. ``dist`` is not computed."""
        nq, l = qs.z.shape
        g = torch.Generator().manual_seed(int(seed) % (2**63))
        picks, lives = [], []
        for q in range(nq):
            live = torch.nonzero(lbs[q] <= float(thrs[q]) * (1 + SLACK)).flatten()
            lives.append(int(live.numel()))
            if live.numel() > sample:
                pick = torch.randperm(int(live.numel()), generator=g)[:sample]
                live = live[torch.sort(pick.to(live.device)).values]
            picks.append(live)
        k = max(1, max(int(p.numel()) for p in picks))
        starts = torch.zeros((nq, k), dtype=torch.long, device=self.device)
        ub = torch.full((nq, k), -1.0, dtype=self.dtype, device=self.device)
        for q, p in enumerate(picks):
            starts[q, : p.numel()] = p
            ub[q, : p.numel()] = float(thrs[q]) * (1 + SLACK)
        step = max(1, self._lanes_per_batch(3 * l + 12 * self.bw) // nq)
        rows = torch.zeros(nq, dtype=torch.int64, device=self.device)
        cells = torch.zeros(nq, dtype=torch.int64, device=self.device)
        for lo in range(0, k, step):
            win = self.windows(starts[:, lo:lo + step])
            cb = cascade_keogh_cumulative(win, qs.u[:, None, :],
                                          qs.low[:, None, :])
            _, r, c = dtw_ea_row(qs.z, win, ub[:, lo:lo + step], self.window,
                                 self.bw, cb=cb, count=True)
            dead = ub[:, lo:lo + step] < 0
            rows += torch.where(dead, 0, r).sum(dim=1, dtype=torch.int64)
            cells += torch.where(dead, 0, c).sum(dim=1, dtype=torch.int64)
            del win, cb
        return [Certified(float("nan"), -1, lives[q], int(picks[q].numel()),
                          int(rows[q]), int(cells[q])) for q in range(nq)]

    def search(self, raw_queries) -> tuple[list[int], list[float]]:
        """The exact answer of each query: the window of least lower bound
        scored, then certified against. This is the reference put in the
        program's place (the control runs it in a lower precision)."""
        qs = self.queries(raw_queries)
        lbs = self.lower_bounds(qs)
        starts, dists = [], []
        for q in range(qs.z.shape[0]):
            s0 = int(torch.argmin(lbs[q]))
            d0 = float(self.dtw(qs.z[q:q + 1],
                                torch.tensor([[s0]], device=self.device))[0, 0])
            c = self.certify(qs, q, lbs[q], d0)
            if c.dist < d0:
                starts.append(c.start)
                dists.append(c.dist)
            else:
                starts.append(s0)
                dists.append(d0)
        return starts, dists
