"""The ``EAInfo`` counters of the port (``with_info=True``) against ``repro``
on the CPU.

The counters are ``repro``'s pruning measure (paper §5): per lane, the DP
rows it entered, the abandoning row included, and the cells of those rows
that exist; a dead lane counts row 0. On CPU tensors the wrappers of
``kernels.ops`` count with their plain versions (``kernels/dtw_band.py``),
which ``chip_smoke.py`` holds the counter variants of kernels A and D
against on the card. Here they meet ``repro``'s Pallas kernels with
``emit_info`` in interpret mode, its ``backend="jax"`` batch primitives and
its searches, fed the same float32 inputs (the searches the same float32
window stats: both packages compute them from prefix sums that round
differently).

Tolerance: the counters are threshold decisions, so they must be equal,
except on a lane within rounding of one of its thresholds (``ub``, or
``ub - cb[i + w + 1]``, where ``cb`` can cancel most of a small ``ub``):
the two packages add the row's prefix sums and the cb suffix in other
orders. Such a lane is one whose counters, in the port, change when its
``ub`` moves by ``TOL_UB * max(|ub|, 1)``; each test finds those lanes,
holds ``repro``'s counters for them within the port's counters at the two
moved bounds (the counters only grow with ``ub``), and holds every other
lane, and every query without such a lane, equal. Such lanes must be few
(``_assert_few``): the seeds here give at most one per case at the ops and
batch levels, and 4 to 13 of some 500 lanes per search, most of them in
query 0, whose distance is 0.15, so that the moved bound spans 7e-4 of it.
The one lane whose counters differ between the packages there abandons on
row 39 in ``repro`` and on row 40 in the port: its cell lies within
1.5e-5 of ``ub - cb`` (both packages flip it between ``ub`` x 0.9999 and
x 1.0001).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.batch import ea_pruned_dtw_batch as r_batch
from repro.core.batch import ea_pruned_dtw_multi_batch as r_multi_batch
from repro.core.batch import ea_pruned_dtw_multi_batch_fused as r_fused_batch
from repro.core.common import clamp_sigma as r_clamp_sigma
from repro.core.lower_bounds import cascade_keogh_cumulative as r_cb
from repro.core.lower_bounds import envelope as r_envelope
from repro.kernels import ops as r_ops
from repro.search import multi_query_search as r_multi
from repro.search import subsequence_search as r_subsequence
from repro.search.znorm import gather_norm_windows as r_gather
from repro.search.znorm import window_stats as r_window_stats
from repro.search.znorm import znorm as r_znorm
from repro_torch.core.batch import (
    ea_pruned_dtw_batch,
    ea_pruned_dtw_multi_batch,
    ea_pruned_dtw_multi_batch_fused,
)
from repro_torch.core.common import BIG
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.kernels import ops
from repro_torch.search import multi_query_search, pipeline, subsequence_search

torch.set_num_threads(1)

N_REF, LENGTH, WINDOW, Q, K = 500, 40, 4, 2, 13
TOL_UB = 1e-4  # absolute at ub <= 1, relative above


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed=2, n=LENGTH):
    """Two queries of ``n`` samples against K windows of LENGTH each: flat
    windows among them, per-lane stats, the float32 slab and, when
    ``n == LENGTH``, the envelopes and the cb slab (``repro``'s)."""
    rng = np.random.default_rng(seed)
    ref = np.cumsum(rng.normal(size=N_REF)).astype(np.float32) * 0.1
    ref[200:260] = ref[200]
    queries = np.cumsum(rng.normal(size=(Q, n)), axis=1).astype(np.float32)
    qn = np.asarray(r_znorm(jnp.asarray(queries)), np.float32)
    mu, sigma = (np.asarray(a, np.float32)
                 for a in r_window_stats(jnp.asarray(ref), LENGTH))
    starts = np.stack([
        np.array([0, 7, 190, 205, 215, 230, 300, 333, 350, 400, 410, 420,
                  N_REF - LENGTH]),
        rng.integers(0, N_REF - LENGTH + 1, K),
    ]).astype(np.int32)
    slab = np.asarray(jax.vmap(
        lambda s: r_gather(jnp.asarray(ref), s, LENGTH, jnp.asarray(mu),
                           jnp.asarray(sigma))
    )(jnp.asarray(starts)), np.float32)
    sg = np.asarray(r_clamp_sigma(jnp.asarray(sigma)), np.float32)
    c = dict(ref=ref, qn=qn, mu=mu, sigma=sigma, starts=starts, slab=slab,
             mu_l=mu[starts], sg_l=sg[starts], u=None, low=None, cb=None)
    if n == LENGTH:
        c["u"], c["low"] = (np.asarray(a, np.float32)
                            for a in r_envelope(jnp.asarray(qn), WINDOW))
        c["cb"] = np.asarray(jax.vmap(r_cb)(
            jnp.asarray(slab), jnp.asarray(c["u"]), jnp.asarray(c["low"])),
            np.float32)
    return c


def _ub(c, mode):
    """Per-lane bounds: ``BIG`` with two dead lanes a query, or a tight
    bound that four lanes a query finish under."""
    ub = np.full((Q, K), BIG, np.float32)
    if mode == "dead":
        ub[:, [2, 9]] = -1.0
    else:
        exact = ops.dtw_ea_multi(_t(c["qn"]), _t(c["slab"]), BIG,
                                 WINDOW).numpy()
        for q in range(Q):
            srt = np.sort(exact[q])
            ub[q] = 0.5 * (srt[3] + srt[4])
    return ub


def _moved(ub):
    """``ub`` moved down and up by the tolerance."""
    delta = TOL_UB * np.maximum(np.abs(ub), 1.0)
    return (ub - delta).astype(np.float32), (ub + delta).astype(np.float32)


def _assert_lanes(theirs, mine, count, ub):
    """Per-lane ``(rows, cells)``: equal on every lane whose port counters
    hold still when ``ub`` moves by the tolerance; on the others ``repro``'s
    lie between the port's at the moved bounds. ``count(ub)`` gives the
    port's ``(rows, cells)``. Returns the number of lanes near a
    threshold."""
    lo, hi = (count(b) for b in _moved(ub))
    steady = (lo[0] == hi[0]) & (lo[1] == hi[1])
    for a, b, l, h in zip(theirs, mine, lo, hi):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(a[steady], b[steady])
        assert ((l <= a) & (a <= h)).all() and ((l <= b) & (b <= h)).all()
    near = int((~steady).sum())
    _assert_few(near, steady.size)
    return near


def _assert_few(near: int, lanes: int) -> None:
    """The lanes near a threshold are a few of all: at most one, or 5%."""
    assert near <= max(1, lanes // 20), (
        f"{near} of {lanes} lanes within rounding of a threshold")


# ---------------------------------------------------------------------------
# ops level: the counter variants' plain versions against emit_info
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_cb", [False, True])
@pytest.mark.parametrize("mode", ["dead", "tight"])
def test_fused_round_counters_match_pallas_interpret(use_cb, mode):
    """Kernel A's counters (plain version) against ``_dtw_ea_fused_kernel``
    with ``emit_info``: K = 13 lanes against block_k = 4 (a ragged Pallas
    block), flat windows, dead lanes and a tight ub."""
    c = _case()
    ub = _ub(c, mode)
    env = dict(u=c["u"], low=c["low"], use_cb=use_cb)

    def mine(ub_):
        return ops.dtw_ea_multi_fused(
            _t(c["qn"]), _t(c["ref"]), _t(c["starts"]), _t(c["mu_l"]),
            _t(c["sg_l"]), _t(ub_), WINDOW, LENGTH, u=_t(env["u"]),
            low=_t(env["low"]), use_cb=use_cb, with_info=True,
        )

    want = r_ops.dtw_ea_multi_fused(
        jnp.asarray(c["qn"]), jnp.asarray(c["ref"]), jnp.asarray(c["starts"]),
        jnp.asarray(c["mu_l"]), jnp.asarray(c["sg_l"]), jnp.asarray(ub),
        WINDOW, LENGTH, u=jnp.asarray(env["u"]), low=jnp.asarray(env["low"]),
        use_cb=use_cb, block_k=4, row_block=16, interpret=True,
        with_info=True,
    )
    got = mine(ub)
    assert got[1].dtype == torch.int32 and got[1].shape == (Q, K)
    fin = np.isfinite(np.asarray(want[0]))
    assert np.array_equal(np.isfinite(got[0].numpy()), fin)
    np.testing.assert_allclose(got[0].numpy()[fin], np.asarray(want[0])[fin],
                               rtol=1e-5)
    _assert_lanes(want[1:], [t.numpy() for t in got[1:]],
                  lambda b: [t.numpy() for t in mine(b)[1:]], ub)
    if mode == "dead":  # row 0 and its cells, columns 0 .. w
        assert got[1][:, [2, 9]].tolist() == [[1, 1]] * Q
        assert got[2][:, [2, 9]].tolist() == [[WINDOW + 1] * 2] * Q
    assert ops.dtw_ea_multi_fused.launches == 0


@pytest.mark.parametrize("cb_on", [False, True])
@pytest.mark.parametrize("mode", ["dead", "tight"])
def test_slab_round_counters_match_pallas_interpret(cb_on, mode):
    """Kernel D's counters (plain version) against ``_dtw_ea_kernel`` with
    ``emit_info``, with and without the cb slab."""
    c = _case(seed=4)
    ub = _ub(c, mode)
    cb = c["cb"] if cb_on else None

    def mine(ub_):
        return ops.dtw_ea_multi(_t(c["qn"]), _t(c["slab"]), _t(ub_), WINDOW,
                                cb=None if cb is None else _t(cb),
                                with_info=True)

    want = r_ops.dtw_ea_multi(
        jnp.asarray(c["qn"]), jnp.asarray(c["slab"]), jnp.asarray(ub), WINDOW,
        cb=None if cb is None else jnp.asarray(cb), block_k=4, row_block=16,
        interpret=True, with_info=True,
    )
    got = mine(ub)
    fin = np.isfinite(np.asarray(want[0]))
    assert np.array_equal(np.isfinite(got[0].numpy()), fin)
    _assert_lanes(want[1:], [t.numpy() for t in got[1:]],
                  lambda b: [t.numpy() for t in mine(b)[1:]], ub)
    assert ops.dtw_ea_multi.launches == 0


def test_slab_counters_full_band_and_single_query():
    """``n != m`` (the band is the full row) on the slab round, and the
    Q = 1 form ``dtw_ea`` with a ``(K,)`` ub."""
    c = _case(seed=6, n=LENGTH + 7)
    ub = np.full((Q, K), BIG, np.float32)
    ub[0, 5] = -1.0
    want = r_ops.dtw_ea_multi(
        jnp.asarray(c["qn"]), jnp.asarray(c["slab"]), jnp.asarray(ub), WINDOW,
        block_k=4, row_block=16, interpret=True, with_info=True,
    )
    got = ops.dtw_ea_multi(_t(c["qn"]), _t(c["slab"]), _t(ub), WINDOW,
                           with_info=True)
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # n > m + w: row m + w + 1 has no cell in the window, and a lane under
    # ub = BIG abandons there.
    assert got[1][0, 5] == 1 and got[1][1, 5] == LENGTH + WINDOW + 1

    c = _case(seed=8)
    ub1 = _ub(c, "tight")[1]
    want1 = r_ops.dtw_ea(
        jnp.asarray(c["qn"][1]), jnp.asarray(c["slab"][1]), jnp.asarray(ub1),
        WINDOW, cb=jnp.asarray(c["cb"][1]), interpret=True, with_info=True,
    )

    def mine(ub_):
        return ops.dtw_ea(_t(c["qn"][1]), _t(c["slab"][1]), _t(ub_), WINDOW,
                          cb=_t(c["cb"][1]), with_info=True)

    got1 = mine(ub1)
    assert got1[1].shape == (K,)
    _assert_lanes(want1[1:], [t.numpy() for t in got1[1:]],
                  lambda b: [t.numpy() for t in mine(b)[1:]], ub1)


def test_out_of_range_lane_counts_row_zero():
    """A lane whose start lies outside ``[0, N - m]`` is flagged NaN and
    counts as a dead lane: row 0 and its cells."""
    c = _case()
    starts = c["starts"].copy()
    starts[1, 4] = N_REF - LENGTH + 1
    d, rows, cells = ops.dtw_ea_multi_fused(
        _t(c["qn"]), _t(c["ref"]), _t(starts), _t(c["mu_l"]), _t(c["sg_l"]),
        torch.full((Q, K), BIG), WINDOW, LENGTH, with_info=True,
    )
    assert torch.isnan(d[1, 4]) and int(torch.isnan(d).sum()) == 1
    assert (int(rows[1, 4]), int(cells[1, 4])) == (1, WINDOW + 1)
    assert (rows[~torch.isnan(d)] == LENGTH).all()


# ---------------------------------------------------------------------------
# batch level: the three rounds against repro's backend="jax"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_cb", [False, True])
def test_batch_round_counters_match_repro_jax(use_cb):
    """``ea_pruned_dtw_multi_batch_fused``, ``ea_pruned_dtw_multi_batch``
    and ``ea_pruned_dtw_batch`` with ``with_info=True`` return ``(d,
    EAInfo)`` with ``repro``'s ``backend="jax"`` counters."""
    c = _case(seed=3)
    ub = _ub(c, "tight")
    ub[0, 3] = -1.0
    env_r = (jnp.asarray(c["u"]), jnp.asarray(c["low"])) if use_cb else None
    env_t = (_t(c["u"]), _t(c["low"])) if use_cb else None
    cb = c["cb"] if use_cb else None
    calls = {
        "fused": (
            lambda b: ea_pruned_dtw_multi_batch_fused(
                _t(c["qn"]), _t(c["ref"]), _t(c["starts"]), _t(b), WINDOW,
                _t(c["mu"]), _t(c["sigma"]), envelopes=env_t, with_info=True),
            lambda b: r_fused_batch(
                jnp.asarray(c["qn"]), jnp.asarray(c["ref"]),
                jnp.asarray(c["starts"]), jnp.asarray(b), WINDOW,
                jnp.asarray(c["mu"]), jnp.asarray(c["sigma"]),
                envelopes=env_r, backend="jax", with_info=True),
        ),
        "slab": (
            lambda b: ea_pruned_dtw_multi_batch(
                _t(c["qn"]), _t(c["slab"]), _t(b), WINDOW,
                cb=None if cb is None else _t(cb), with_info=True),
            lambda b: r_multi_batch(
                jnp.asarray(c["qn"]), jnp.asarray(c["slab"]), jnp.asarray(b),
                WINDOW, cb=None if cb is None else jnp.asarray(cb),
                backend="jax", with_info=True),
        ),
        "single": (
            lambda b: ea_pruned_dtw_batch(
                _t(c["qn"][0]), _t(c["slab"][0]), _t(b), WINDOW,
                cb=None if cb is None else _t(cb[0]), with_info=True),
            lambda b: r_batch(
                jnp.asarray(c["qn"][0]), jnp.asarray(c["slab"][0]),
                jnp.asarray(b), WINDOW,
                cb=None if cb is None else jnp.asarray(cb[0]),
                backend="jax", with_info=True),
        ),
    }
    for name, (mine, theirs) in calls.items():
        lanes_ub = ub[0] if name == "single" else ub
        d, info = mine(lanes_ub)
        rd, rinfo = theirs(lanes_ub)
        assert type(info).__name__ == "EAInfo", name
        assert info.rows.shape == d.shape == tuple(np.shape(rd)), name
        _assert_lanes(rinfo, [t.numpy() for t in info],
                      lambda b: [t.numpy() for t in mine(b)[1]], lanes_ub)


# ---------------------------------------------------------------------------
# search level: per-query totals of multi_query_search / subsequence_search
# ---------------------------------------------------------------------------

N, SLEN, SWIN, SQ, BATCH = 2000, 48, 5, 3, 32  # 1953 windows: ragged


@pytest.fixture
def shared_stats(monkeypatch):
    """Both packages on the same float32 window stats (``repro``'s), and a
    record, for every round the port runs, of its per-query counters at
    ``ub`` moved down and up by the tolerance and of its lanes near a
    threshold."""
    def stats(x, length):
        mu, sigma = r_window_stats(jnp.asarray(x.numpy()), length)
        return (torch.from_numpy(np.array(mu, np.float32)),
                torch.from_numpy(np.array(sigma, np.float32)))

    rounds = []
    real = pipeline._dtw_round

    def spy(plan, prep, pq, starts, ub_lanes, *, use_cb, with_info=False):
        out = real(plan, prep, pq, starts, ub_lanes, use_cb=use_cb,
                   with_info=with_info)
        lo, hi = (real(plan, prep, pq, starts, torch.from_numpy(b),
                       use_cb=use_cb, with_info=True)[1]
                  for b in _moved(ub_lanes.numpy()))
        near = (lo.rows != hi.rows) | (lo.cells != hi.cells)
        rounds.append((lo, hi, near))
        return out

    monkeypatch.setattr(pipeline, "window_stats", stats)
    monkeypatch.setattr(pipeline, "_dtw_round", spy)
    return rounds


def _assert_queries(want, got, rounds):
    """Per query: ``best_start``, rounds, lanes and quarantine exactly; rows
    and cells (int64 in the port) equal for every query none of whose lanes
    lies near a threshold, and ``repro``'s within the port's totals at the
    moved bounds for the others."""
    for f in ("best_start", "rounds", "lanes", "lb_pruned"):
        assert np.asarray(getattr(got, f)).tolist() == \
            np.asarray(getattr(want, f)).tolist(), f
    assert int(got.quarantined) == int(want.quarantined)
    assert got.rows.dtype == torch.int64 and got.cells.dtype == torch.int64
    near = sum(r[2].sum(dim=1) for r in rounds)
    _assert_few(int(near.sum()), sum(r[2].numel() for r in rounds))
    for f in ("rows", "cells"):
        mine = getattr(got, f).reshape(-1).numpy()
        theirs = np.asarray(getattr(want, f)).reshape(-1)
        lo = sum(getattr(r[0], f).sum(dim=1, dtype=torch.int64)
                 for r in rounds).numpy()
        hi = sum(getattr(r[1], f).sum(dim=1, dtype=torch.int64)
                 for r in rounds).numpy()
        steady = near.reshape(-1).numpy() == 0
        np.testing.assert_array_equal(mine[steady], theirs[steady])
        assert ((lo <= theirs) & (theirs <= hi)).all(), f
        assert (mine > 0).all()


def _data(nan_burst=False):
    ref = make_dataset("ECG", N, seed=4).astype(np.float32)
    if nan_burst:
        ref[700:710] = np.nan
    return ref, make_queries("ECG", SQ, SLEN, seed=5).astype(np.float32)


CASES = {
    "ragged": dict(),
    "warm_start": dict(warm_start=8),
    "ub_init": dict(ub_init="seeds"),
    "nan_burst": dict(nan_burst=True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("gather", ["fused", "slab"])
def test_multi_query_counters_match_repro(shared_stats, gather, case):
    """``multi_query_search(with_info=True)`` on the host rounds: a ragged
    final round (1953 windows in rounds of 32), a query that finishes early
    and rides along with dead lanes, lanes gated by their own bound, the
    warm prepass, per-query seeds (one unbeatable) and a NaN burst."""
    kw = dict(CASES[case])
    ref, queries = _data(kw.pop("nan_burst", False))
    if kw.get("ub_init") == "seeds":
        free = multi_query_search(ref, queries, SLEN, SWIN, batch=BATCH,
                                  device="cpu")
        d = free.best_dist.numpy()
        kw["ub_init"] = np.array([d[0] * 0.5, d[1] * 1.01, d[2] * 10.0],
                                 np.float32)
        shared_stats.clear()
    want = r_multi(jnp.asarray(ref), jnp.asarray(queries), SLEN, SWIN,
                   batch=BATCH, backend="jax", gather=gather, with_info=True,
                   **kw)
    got = multi_query_search(ref, queries, SLEN, SWIN, batch=BATCH,
                             gather=gather, with_info=True, device="cpu",
                             **kw)
    _assert_queries(want, got, shared_stats)
    if case == "nan_burst":
        assert int(got.quarantined) == 9 + SLEN


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
@pytest.mark.parametrize("gather", ["fused", "slab"])
def test_subsequence_counters_match_repro(shared_stats, gather, variant):
    """``subsequence_search(with_info=True)``, the Q = 1 case."""
    ref, queries = _data()
    want = r_subsequence(jnp.asarray(ref), jnp.asarray(queries[2]), SLEN,
                         SWIN, variant=variant, batch=BATCH, backend="jax",
                         gather=gather, with_info=True)
    got = subsequence_search(ref, queries[2], SLEN, SWIN, variant=variant,
                             batch=BATCH, gather=gather, with_info=True,
                             device="cpu")
    _assert_queries(want, got, shared_stats)


def test_counter_free_search_reports_minus_one():
    """Without ``with_info`` the counters are -1, as in ``repro``, and the
    winners are those of the counting search."""
    ref, queries = _data()
    free = multi_query_search(ref, queries, SLEN, SWIN, batch=BATCH,
                              device="cpu")
    info = multi_query_search(ref, queries, SLEN, SWIN, batch=BATCH,
                              device="cpu", with_info=True)
    assert free.rows.tolist() == free.cells.tolist() == [-1] * SQ
    assert torch.equal(free.best_start, info.best_start)
    assert torch.equal(free.best_dist, info.best_dist)
