"""The paper's baselines in the port against ``repro`` on the CPU: exact
DTW (``core/dtw.py``, the ``full`` suite, UCR), PrunedDTW
(``core/pruned_dtw.py``, the ``pruned`` suite, UCR-USP) and the search core
that runs them (``search/pipeline.py::_baseline_search_impl``).

``repro`` computes both distances with ``lax.scan`` / ``lax.while_loop``
outside any Pallas kernel; the port computes them with PyTorch ops on the
device of the tensors, so they have no kernel and no plain version of one.
Tolerances: distances ``rtol=1e-5`` where both sides get the same float32
series (XLA and torch add the row's prefix sum in other orders), and
``rtol=1e-4`` end to end, where each side computes its own window stats
(``tests/test_torch_search.py``); ``best_start``, rounds, lanes,
``lb_pruned``, quarantine counts and the counters exactly. The counters
are threshold decisions, and window stats that differ by 1e-5 move a lane
that lies that close to its ``ub`` by a row (query 0 below, by one row of
45,804, on each side's own stats), so the searches that count run on the
same float32 window stats (``repro``'s) on both sides; there no lane of
these seeds lies within rounding of a threshold
(``tests/test_torch_counters.py`` says what is done where one does).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.batch import block_sweep as r_block_sweep
from repro.core.dtw import dtw as r_dtw
from repro.core.dtw import dtw_batch as r_dtw_batch
from repro.core.dtw import dtw_matrix as r_dtw_matrix
from repro.core.ea_pruned_dtw_np import dtw_naive
from repro.core.pruned_dtw import pruned_dtw as r_pruned_dtw
from repro.search import pipeline as r_pipeline
from repro.search import subsequence_search as r_subsequence
from repro.search.znorm import window_stats as r_window_stats
from repro_torch.core.batch import block_sweep
from repro_torch.core.common import BIG
from repro_torch.core.dtw import dtw, dtw_batch, dtw_matrix
from repro_torch.core.pruned_dtw import pruned_dtw, pruned_dtw_batch
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.search import pipeline, subsequence_search

torch.set_num_threads(1)

M, W, B = 24, 3, 9


def _t(a):
    return torch.from_numpy(np.array(a))


def _series(seed, n=M, dims=None, b=B):
    """``b`` pairs of z-normalized-looking random walks, ``(b, n[, dims])``."""
    rng = np.random.default_rng(seed)
    shape = (b, n) if dims is None else (b, n, dims)
    x = np.cumsum(rng.normal(size=shape), axis=1)
    return ((x - x.mean(axis=1, keepdims=True))
            / x.std(axis=1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# core: dtw, dtw_batch, dtw_matrix, pruned_dtw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, W, M])
@pytest.mark.parametrize("dims", [None, 3])
def test_dtw_and_dtw_batch_match_repro(dims, window):
    """Univariate and ``(n, dims)`` series, without a window, with one, and
    with one of ``m`` (no window)."""
    s, t = _series(1, dims=dims), _series(2, dims=dims)
    want = np.asarray(r_dtw_batch(jnp.asarray(s), jnp.asarray(t),
                                  window=window))
    got = dtw_batch(_t(s), _t(t), window=window)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    one = dtw(_t(s[4]), _t(t[4]), window=window)
    assert one.dim() == 0
    np.testing.assert_allclose(
        float(one), float(r_dtw(jnp.asarray(s[4]), jnp.asarray(t[4]),
                                window=window)), rtol=1e-5)
    if dims is None:  # the naive float64 oracle
        np.testing.assert_allclose(float(one), dtw_naive(s[4], t[4], window),
                                   rtol=1e-5)


@pytest.mark.parametrize("dims", [None, 2])
def test_dtw_unequal_lengths_and_matrix_match_repro(dims):
    """``n != m`` without a window, the full ``(n + 1, m + 1)`` matrix
    (``+inf`` border), and the window's equal-length rule."""
    s, t = _series(3, n=M + 5, dims=dims), _series(4, dims=dims)
    want = np.asarray(r_dtw_batch(jnp.asarray(s), jnp.asarray(t)))
    np.testing.assert_allclose(dtw_batch(_t(s), _t(t)).numpy(), want,
                               rtol=1e-5)
    mat = dtw_matrix(_t(s[0]), _t(t[0])).numpy()
    ref = np.asarray(r_dtw_matrix(jnp.asarray(s[0]), jnp.asarray(t[0])))
    assert mat.shape == ref.shape == (M + 6, M + 1)
    assert np.array_equal(np.isinf(mat), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(mat[fin], ref[fin], rtol=1e-5)
    assert mat[-1, -1] == pytest.approx(float(want[0]), rel=1e-6)
    with pytest.raises(ValueError, match="equal lengths"):
        dtw(_t(s[0]), _t(t[0]), window=W)


def _pruned_both(s, t, ub, window):
    """``repro``'s ``pruned_dtw`` vmapped over lanes with a scalar ub, and
    the port's batch, both ``with_info``."""
    rd, rinfo = jax.vmap(lambda a, b: r_pruned_dtw(
        a, b, jnp.float32(ub), window=window, with_info=True))(
        jnp.asarray(s), jnp.asarray(t))
    d, info = pruned_dtw_batch(_t(s), _t(t), ub, window=window,
                               with_info=True)
    return (np.asarray(rd), np.asarray(rinfo.rows), np.asarray(rinfo.cells),
            d.numpy(), info.rows.numpy(), info.cells.numpy())


@pytest.mark.parametrize("window", [None, W])
@pytest.mark.parametrize("dims", [None, 2])
def test_pruned_dtw_matches_repro(dims, window):
    """PrunedDTW's distances and counters at a bound no lane reaches, one
    that half the lanes finish under, and a negative one (every lane
    abandons on row 0)."""
    s, t = _series(5, dims=dims), _series(6, dims=dims)
    exact = dtw_batch(_t(s), _t(t), window=window).numpy()
    for ub in (BIG, float(np.median(exact)), -1.0):
        rd, rrows, rcells, d, rows, cells = _pruned_both(s, t, ub, window)
        assert np.array_equal(np.isfinite(d), np.isfinite(rd))
        fin = np.isfinite(rd)
        np.testing.assert_allclose(d[fin], rd[fin], rtol=1e-5)
        np.testing.assert_allclose(d[fin], exact[fin], rtol=1e-6)
        np.testing.assert_array_equal(rows, rrows)
        np.testing.assert_array_equal(cells, rcells)
        if ub < 0:
            assert rows.tolist() == [1] * B
        if ub == BIG:
            assert fin.all() and rows.tolist() == [M] * B
    one, info = pruned_dtw(_t(s[2]), _t(t[2]), BIG, window=window,
                           with_info=True)
    assert one.dim() == 0 and int(info.rows) == M
    assert float(one) == pytest.approx(float(exact[2]), rel=1e-6)


# ---------------------------------------------------------------------------
# block_sweep: the chunked sweep's argument, for dtw and pruned_dtw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [None, 2])
def test_finished_lane_bits_do_not_depend_on_ub(dims):
    """What ``block_sweep`` rests on, for ``pruned_dtw`` (``dtw`` takes no
    ``ub``): a lane that finishes gives the same bits under ``ub = BIG``,
    under its own distance and under bounds between; one ulp below its
    distance every lane is ``+inf``; and a lane that abandons under a bound
    abandons under any smaller one."""
    s, t = _series(7, dims=dims), _series(8, dims=dims)
    free = pruned_dtw_batch(_t(s), _t(t), BIG, window=W)
    assert torch.isfinite(free).all()
    for ub in (free, free * (1 + 1e-6), free * 1.5):
        assert torch.equal(pruned_dtw_batch(_t(s), _t(t), ub, window=W),
                           free)
    below = pruned_dtw_batch(_t(s), _t(t),
                             torch.nextafter(free, torch.zeros(())), window=W)
    assert torch.isinf(below).all()
    finished = []
    for ub in sorted(free.tolist(), reverse=True):
        d, info = pruned_dtw_batch(_t(s), _t(t), ub, window=W, with_info=True)
        finished.append(torch.isfinite(d))
        assert torch.equal(d[finished[-1]], free[finished[-1]])
    for bigger, smaller in zip(finished, finished[1:]):
        assert not (smaller & ~bigger).any()


@pytest.mark.parametrize("chunk", [4, 24, 4096])
@pytest.mark.parametrize("variant", ["full", "pruned"])
def test_block_sweep_chunks_equal_repro(variant, chunk):
    """``block_sweep`` evaluates ``chunk`` lanes at the chunk's incumbent
    and replays gate and fold by block; at any chunk it gives ``repro``'s
    sequential ``block_sweep``: the same best lane and ``blocks``, and its
    ``ub`` within the distances' tolerance. 61 lanes in blocks of 4, the
    last block padded with ``+inf`` bounds, and a quarantined lane
    (``+inf``) inside the order."""
    k, block_k = 61, 4
    rng = np.random.default_rng(9)
    query = _series(10, b=1)[0]
    cand = _series(11, b=64)
    exact = dtw_batch(_t(np.broadcast_to(query, cand.shape)), _t(cand),
                      window=W).numpy()
    lb = np.sort(exact * rng.uniform(0.3, 1.0, 64)).astype(np.float32)
    lb[k:] = np.inf
    lb[17] = np.inf
    starts = np.arange(100, 164).astype(np.int32)

    def mine(c, lbb, ub_lanes):
        q = _t(query).expand(c.shape[0], -1)
        if variant == "full":
            return dtw_batch(q, c, window=W)
        return pruned_dtw_batch(q, c, ub_lanes, window=W)

    def theirs(c, lbb, ub):
        if variant == "full":
            return jax.vmap(lambda x: r_dtw(jnp.asarray(query), x,
                                            window=W))(c)
        return jax.vmap(lambda x: r_pruned_dtw(jnp.asarray(query), x, ub,
                                               window=W))(c)

    want = r_block_sweep(jnp.asarray(cand), jnp.asarray(lb),
                         jnp.asarray(starts), jnp.float32(BIG), block_k,
                         theirs)
    got = block_sweep(_t(cand), _t(lb), _t(starts), BIG, block_k, mine,
                      chunk=chunk)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    assert 0 < int(got[2]) <= 16


# ---------------------------------------------------------------------------
# the baseline search core end to end
# ---------------------------------------------------------------------------

N, SLEN, SWIN, BATCH = 2000, 48, 5, 32  # 1953 windows: a ragged last round
FIELDS = ("best_start", "rounds", "lanes", "lb_pruned", "rows", "cells",
          "quarantined")


@pytest.fixture
def same_stats(monkeypatch):
    """The port's searches on ``repro``'s float32 window stats."""
    def stats(x, length):
        mu, sigma = r_window_stats(jnp.asarray(x.numpy()), length)
        return (torch.from_numpy(np.array(mu, np.float32)),
                torch.from_numpy(np.array(sigma, np.float32)))

    monkeypatch.setattr(pipeline, "window_stats", stats)


def _data(seed=4):
    ref = make_dataset("ECG", N, seed=seed).astype(np.float32)
    ref[700:710] = np.nan  # 57 quarantined windows
    return ref, make_queries("ECG", 2, SLEN, seed=5).astype(np.float32)


@pytest.mark.parametrize("rounds,with_info", [
    ("host", False), ("host", True), ("persistent", False)])
@pytest.mark.parametrize("variant", ["full", "pruned"])
def test_baseline_search_matches_repro(request, variant, rounds, with_info):
    """``subsequence_search`` with ``variant="full"`` / ``"pruned"`` under
    both drivers (the sweep is counter-free in both packages): ``repro``'s
    fields exactly, ``best_dist`` at 1e-4; the counters, -1 without
    ``with_info``, on the same window stats."""
    if with_info:
        request.getfixturevalue("same_stats")
    ref, queries = _data()
    for q in queries:
        want = r_subsequence(jnp.asarray(ref), jnp.asarray(q), SLEN, SWIN,
                             variant=variant, batch=BATCH, backend="jax",
                             rounds=rounds, with_info=with_info)
        got = subsequence_search(ref, q, SLEN, SWIN, variant=variant,
                                 batch=BATCH, rounds=rounds,
                                 with_info=with_info, device="cpu")
        for f in FIELDS:
            assert int(getattr(got, f)) == int(getattr(want, f)), f
        assert float(got.best_dist) == pytest.approx(float(want.best_dist),
                                                     rel=1e-4)
        assert (int(got.rows) > 0) == with_info
    assert int(got.quarantined) == 9 + SLEN


@pytest.mark.parametrize("rounds", ["host", "persistent"])
@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
def test_baseline_core_runs_ea_variants_as_repro(same_stats, variant, rounds):
    """The baseline core with an EA variant (kernel D a round, kernel E
    for the sweep; lanes on a non-finite bound submitted dead), against
    ``repro``'s ``_baseline_search_impl`` fed the same window stats: its
    fields exactly, counters included on the host rounds."""
    ref, queries = _data()
    kw = dict(length=SLEN, window=SWIN, variant=variant, batch=BATCH,
              rounds=rounds)
    info = rounds == "host"
    r_state, r_stats, r_quar = r_pipeline._baseline_search_impl(
        jnp.asarray(ref), jnp.asarray(queries[0]), r_pipeline.make_plan(**kw),
        info)
    state, stats, quar = pipeline._baseline_search_impl(
        _t(ref), _t(queries[0]), pipeline.make_plan(**kw), with_info=info)
    assert state.best.tolist() == np.asarray(r_state.best).tolist()
    assert int(quar) == int(r_quar)
    for f in stats._fields:
        assert getattr(stats, f).tolist() == \
            np.asarray(getattr(r_stats, f)).tolist(), f
    np.testing.assert_allclose(state.ub.numpy(), np.asarray(r_state.ub),
                               rtol=1e-4)


def test_four_variants_find_the_exact_nn_in_counter_order():
    """The four suites find the brute-force nearest window
    (``tests/test_search.py``), and the counters order as the paper's
    suites prune: ``eapruned <= pruned <= full`` in rows and in cells."""
    rng = np.random.default_rng(3)
    n, length, w = 900, 96, 9
    ref = np.cumsum(rng.normal(size=n)).astype(np.float32)
    q = np.cumsum(rng.normal(size=length)).astype(np.float32)

    def zn(x):
        return (x - x.mean()) / max(x.std(), 1e-8)

    dists = [dtw_naive(zn(q), zn(ref[s:s + length]), window=w)
             for s in range(n - length + 1)]
    best = int(np.argmin(dists))
    rows, cells = {}, {}
    for variant in pipeline.VARIANTS:
        res = subsequence_search(ref, q, length, w, variant=variant,
                                 batch=64, with_info=True, device="cpu")
        assert int(res.best_start) == best, variant
        assert float(res.best_dist) == pytest.approx(dists[best], rel=1e-4)
        rows[variant], cells[variant] = int(res.rows), int(res.cells)
    assert rows["eapruned"] <= rows["pruned"] <= rows["full"]
    assert cells["eapruned"] <= cells["pruned"] <= cells["full"]


@pytest.mark.parametrize("variant", pipeline.VARIANTS)
def test_multivariate_query_raises(variant):
    """A ``(l, dims)`` query has no search path in the port, because
    ``repro``'s search fails on one (ROADMAP.md Queue 3): the port raises
    ``NotImplementedError`` naming that, before any work."""
    ref, queries = _data()
    query = np.stack([queries[0], queries[1], queries[0]], axis=1)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        subsequence_search(ref, query, SLEN, SWIN, variant=variant,
                           device="cpu")
    if variant == "full":
        with pytest.raises(TypeError, match="incompatible shapes"):
            r_subsequence(jnp.asarray(ref[:600]), jnp.asarray(query), SLEN,
                          SWIN, variant=variant, backend="jax")
