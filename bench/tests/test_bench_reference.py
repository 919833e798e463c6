"""The frozen copies in ``bench/reference`` against their sources, and the
plain reference against the port, at small sizes on the CPU."""
import numpy as np
import pytest
import torch

import chip_smoke
from bench.reference import bounds, dtw_row, series
from bench.reference.search import Reference
from repro_torch.data import synthetic
from repro_torch.kernels.dtw_band import dtw_ea_plain
from repro_torch.search.multi import multi_query_search


@pytest.mark.parametrize("name", series.DATASETS)
def test_series_copies_agree_with_their_sources(name):
    for seed in (0, 5, 2**31 + 11):
        np.testing.assert_array_equal(series.make_dataset(name, 3000, seed),
                                      synthetic.make_dataset(name, 3000, seed))
    np.testing.assert_array_equal(series.make_queries(name, 3, 64, seed=9),
                                  synthetic.make_queries(name, 3, 64, seed=9))


def test_arrival_sizes_copy_agrees_with_its_source():
    for n, most, seed in ((100_000, 50_000, 16), (12_345, 300, 3)):
        assert (series.arrival_sizes(n, most, seed)
                == chip_smoke.arrival_sizes(n, most, seed))


def test_bound_arithmetic_copy_agrees_with_its_source():
    for name in ("PEAK_BYTES", "PEAK_FP32", "FLOPS_PER_CELL",
                 "FLOPS_PER_LB_TERM"):
        assert getattr(bounds, name) == getattr(chip_smoke, name)
    for cells, nbytes in ((2.552e11, 26_000_000_000), (10, 10**12), (0, 0)):
        assert bounds.dtw_bound_ms(cells, nbytes) == chip_smoke.dtw_bound_ms(
            cells, nbytes)
        b = bounds.dtw_bound_ms(cells, nbytes)
        assert bounds.bound_by(cells, b) == chip_smoke.bound_by(cells, b)
    # kernel B's bound as phase_times reckons it, at the main path's shape
    nq, n_ref, l = 8, 1_000_000, 1024
    n_win = n_ref - l + 1
    ops = chip_smoke.FLOPS_PER_LB_TERM * nq * n_win * l
    nbytes = 4 * (n_ref + 2 * n_win + 2 * nq * l + 2 * nq + nq * n_win) + n_win
    want = max(ops / chip_smoke.PEAK_FP32, nbytes / chip_smoke.PEAK_BYTES) * 1e3
    assert bounds.lb_bound_ms(n_ref, n_win, n_win, nq, l) == want


@pytest.mark.parametrize("m,w,bw,use_cb", [(48, 4, 32, True), (48, 4, 32, False),
                                           (40, 20, 40, True), (70, 7, 64, True)])
def test_plain_row_copy_agrees_with_its_source(m, w, bw, use_cb):
    g = torch.Generator().manual_seed(m * 100 + w)
    q = torch.randn(3, m, generator=g)
    win = torch.randn(3, 20, m, generator=g)
    cb = None
    if use_cb:
        u, low = q + 0.5, q - 0.5
        cb = dtw_row.cascade_keogh_cumulative(win, u[:, None, :], low[:, None, :])
    full = dtw_row.dtw_ea_row(q, win, torch.full((3, 20), 1e30), w, bw)
    ub = torch.quantile(full, 0.4, dim=1, keepdim=True).expand(3, 20).clone()
    ub[0, :3] = -1.0
    got = dtw_row.dtw_ea_row(q, win, ub, w, bw, cb=cb, count=True)
    want = dtw_ea_plain(q, win, ub, w, bw, cb=cb, count=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _inputs(n=4000, l=64, nq=4, seed=3):
    ref = series.make_dataset("ECG", n, seed).astype(np.float32)
    qs = series.make_queries("ECG", nq, l, seed=seed).astype(np.float32)
    return ref, qs


def test_certify_finds_the_least_distance_over_every_window():
    ref, qs = _inputs(n=1500)
    l, w = 64, 6
    r = Reference(ref, l, w, "cpu", budget=8 << 20)
    pq = r.queries(qs)
    lbs = r.lower_bounds(pq)
    every = torch.arange(r.n_win)
    for q in range(pq.z.shape[0]):
        d = r.dtw(pq.z[q:q + 1], every[None])[0]
        assert torch.all(lbs[q] <= d * (1 + 1e-12))
        c = r.certify(pq, q, lbs[q], float(d[r.n_win // 2]))
        assert c.dist == float(d.min()) and c.start == int(torch.argmin(d))


@pytest.mark.parametrize("ratio", [0.1, 0.5])
def test_reference_agrees_with_the_port(ratio):
    ref, qs = _inputs()
    l = 64
    w = int(l * ratio)
    res = multi_query_search(ref, qs, l, w, batch=32, device="cpu")
    starts, dists = Reference(ref, l, w, "cpu", budget=8 << 20).search(qs)
    assert res.best_start.tolist() == starts
    # The port's window statistics are float32 prefix sums, the
    # reference's float64: small distances part by ~1e-4 relative.
    np.testing.assert_allclose(res.best_dist.double().numpy(), dists,
                               rtol=1e-3)


def test_count_is_the_plain_rows_count_over_the_live_windows():
    ref, qs = _inputs(n=1500)
    l, w = 64, 6
    r = Reference(ref, l, w, "cpu", dtype=torch.float32,
                  stats_dtype=torch.float64, budget=1 << 20)
    pq = r.queries(qs)
    lbs = r.lower_bounds(pq)
    thrs = [float(r.dtw(pq.z[q:q + 1], torch.tensor([[700 + q]]))[0, 0])
            for q in range(pq.z.shape[0])]
    counted = r.count(pq, lbs, thrs, sample=10**6)
    for q, c in enumerate(counted):
        live = torch.nonzero(lbs[q] <= thrs[q] * (1 + 1e-9)).flatten()
        win = r.windows(live)[None]
        cb = dtw_row.cascade_keogh_cumulative(win, pq.u[q:q + 1, None],
                                              pq.low[q:q + 1, None])
        ub = torch.full((1, live.numel()), thrs[q] * (1 + 1e-9))
        _, rows, cells = dtw_ea_plain(pq.z[q:q + 1], win, ub, w, r.bw, cb=cb,
                                      count=True)
        assert (c.live, c.ran) == (live.numel(), live.numel())
        assert (c.rows, c.cells) == (int(rows.sum()), int(cells.sum()))
    sampled = r.count(pq, lbs, thrs, sample=50, seed=3)
    assert all(c.ran == min(50, c.live) for c in sampled)
