"""The rest of the port's core API against ``repro.core`` on the CPU.

``ea_pruned_dtw`` (the paper's algorithm on one pair, full-width rows) on
``tests/test_dtw_core.py``'s cases: the paper's worked example, random
``n != m``, windowed and banded, the ``cb`` contract and multivariate
series, with the ``EAInfo`` counters equal to ``repro``'s. These run in
float64 on both sides (``tests/conftest.py`` turns on x64 and the inputs
are float64 numpy), so the tolerance is ``test_dtw_core.py``'s 1e-8.
Then ``lb_keogh_pair``, ``ea_search_round`` (float32, a slab round: the
plain version of kernel D here), the port's copy of the numpy
transcriptions (the same values and traces as ``repro``'s) and
``repro_torch.core.__all__``.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as rcore
from repro.core import ea_pruned_dtw_np as rnp
import repro_torch.core as core
from repro_torch.core import ea_pruned_dtw_np as pnp
from repro_torch.core import (
    cascade_keogh_cumulative,
    ea_pruned_dtw,
    ea_search_round,
    envelope,
    lb_keogh_pair,
)

torch.set_num_threads(1)

S_PAPER = np.array([3, 1, 4, 4, 1, 1], dtype=float)
T_PAPER = np.array([1, 3, 2, 1, 2, 2], dtype=float)
EPS = 1e-9
ATOL = 1e-8


def _same(got, want) -> bool:
    got, want = float(got), float(want)
    return got == want or abs(got - want) < ATOL


def _both(s, t, ub, **kw):
    """The port's and ``repro``'s ``ea_pruned_dtw`` with counters."""
    mine = ea_pruned_dtw(torch.as_tensor(s), torch.as_tensor(t), ub,
                         with_info=True, **kw)
    rkw = dict(kw)
    if rkw.get("cb") is not None:
        rkw["cb"] = jnp.asarray(rkw["cb"])
    theirs = rcore.ea_pruned_dtw(jnp.asarray(s), jnp.asarray(t), ub,
                                 with_info=True, **rkw)
    return mine, theirs


def _assert_same_info(mine, theirs):
    assert _same(mine[0], theirs[0]), (float(mine[0]), float(theirs[0]))
    assert int(mine[1].rows) == int(theirs[1].rows)
    assert int(mine[1].cells) == int(theirs[1].cells)


@pytest.mark.parametrize("ub,want,rows", [(9.0, 9.0, 6), (6.0, math.inf, 5)])
def test_paper_example(ub, want, rows):
    """Fig. 4: ub = DTW = 9 completes and returns 9; ub = 6 abandons in
    row 5, as the paper's figure and ``repro`` do."""
    assert float(ea_pruned_dtw(S_PAPER, T_PAPER, ub)) == want
    mine, theirs = _both(S_PAPER, T_PAPER, ub)
    _assert_same_info(mine, theirs)
    assert int(mine[1].rows) == rows
    assert mine[0].dtype == torch.float64


@pytest.mark.parametrize("n,m", [(16, 16), (40, 33), (7, 25), (1, 9)])
def test_random_unequal_lengths(n, m):
    rng = np.random.default_rng(n * 100 + m)
    for _ in range(10):
        s, t = rng.normal(size=n), rng.normal(size=m)
        li, co = (s, t) if n >= m else (t, s)
        d = pnp.dtw_naive(s, t)
        for ub, exp in [(d * 0.5, math.inf), (d * (1 + EPS), d),
                        (d * 1.5, d)]:
            mine, theirs = _both(li, co, ub)
            _assert_same_info(mine, theirs)
            assert _same(mine[0], exp)
            assert _same(mine[0], pnp.ea_pruned_dtw(li, co, ub))


@pytest.mark.parametrize("n,w", [(32, 4), (32, 16), (48, 0), (64, 63)])
def test_windowed(n, w):
    """A window (``w >= m`` is none) against the numpy transcription, the
    banded form and ``repro``."""
    rng = np.random.default_rng(n * 7 + w)
    for _ in range(8):
        s, t = rng.normal(size=n), rng.normal(size=n)
        d = pnp.dtw_naive(s, t, window=w)
        cases = ([(d * 0.5, math.inf), (d * (1 + EPS), d)]
                 if math.isfinite(d) else [(1.0, math.inf)])
        for ub, exp in cases:
            mine, theirs = _both(s, t, ub, window=w)
            _assert_same_info(mine, theirs)
            band = core.ea_pruned_dtw_banded(
                torch.as_tensor(s), torch.as_tensor(t), ub, window=w)
            for got in (mine[0], band, pnp.ea_pruned_dtw(s, t, ub, window=w)):
                assert _same(got, exp), (float(got), exp, ub, w)


def test_window_needs_equal_lengths():
    with pytest.raises(ValueError, match="equal lengths"):
        ea_pruned_dtw(np.zeros(5), np.zeros(6), 1.0, window=2)
    # a window of at least m is no window, as in repro
    d = float(ea_pruned_dtw(S_PAPER, T_PAPER, 100.0, window=6))
    assert d == float(rcore.ea_pruned_dtw(S_PAPER, T_PAPER, 100.0, window=6))


def test_cb_contract():
    """The UCR ``cb`` tightening: exact below ub, abandoned above, and the
    counters equal to ``repro``'s."""
    rng = np.random.default_rng(3)
    n, w = 40, 5
    for _ in range(10):
        q, c = rng.normal(size=n), rng.normal(size=n)
        u, low = envelope(torch.as_tensor(q), w)
        cb = cascade_keogh_cumulative(torch.as_tensor(c), u, low).numpy()
        d = pnp.dtw_naive(q, c, window=w)
        for ub, exp in [(d * 0.5, math.inf), (d * (1 + EPS), d)]:
            mine, theirs = _both(q, c, ub, window=w, cb=cb)
            _assert_same_info(mine, theirs)
            assert _same(mine[0], exp)
            assert _same(pnp.ea_pruned_dtw(q, c, ub, window=w, cb=cb), exp)


def test_multivariate():
    rng = np.random.default_rng(5)
    n, dims = 20, 3
    s, t = rng.normal(size=(n, dims)), rng.normal(size=(n, dims))
    m = np.full((n + 1, n + 1), np.inf)
    m[0, 0] = 0
    for i in range(1, n + 1):
        for j in range(1, n + 1):
            c = float(((s[i - 1] - t[j - 1]) ** 2).sum())
            m[i, j] = c + min(m[i - 1, j], m[i, j - 1], m[i - 1, j - 1])
    for ub, exp in [(m[n, n] * (1 + EPS), m[n, n]), (m[n, n] * 0.7, math.inf)]:
        mine, theirs = _both(s, t, ub)
        _assert_same_info(mine, theirs)
        assert _same(mine[0], exp)
    mine, theirs = _both(s, t, m[n, n] * 2, window=4)
    _assert_same_info(mine, theirs)


def test_float32_inputs_stay_float32():
    s = np.random.default_rng(6).normal(size=24).astype(np.float32)
    t = np.random.default_rng(7).normal(size=24).astype(np.float32)
    got = ea_pruned_dtw(s, t, 1e6)
    assert got.dtype == torch.float32
    want = pnp.dtw_naive(s, t)
    assert abs(float(got) - want) <= 1e-5 * want


def test_lb_keogh_pair_matches_repro():
    rng = np.random.default_rng(8)
    for w in (0, 3, 11):
        q = rng.normal(size=(5, 48)).astype(np.float32)
        c = rng.normal(size=(5, 48)).astype(np.float32)
        for i in range(5):
            got = lb_keogh_pair(torch.as_tensor(q[i]), torch.as_tensor(c[i]), w)
            want = rcore.lb_keogh_pair(jnp.asarray(q[i]), jnp.asarray(c[i]), w)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
            assert float(got) <= pnp.dtw_naive(q[i], c[i], window=w) + 1e-5


@pytest.mark.parametrize("use_cb", [False, True])
def test_ea_search_round_matches_repro(use_cb):
    """One slab round plus the strict fold: the improved incumbent, a tie
    that keeps the incumbent, and an unbeatable incumbent."""
    rng = np.random.default_rng(9)
    k, m, w = 24, 48, 5
    q = rng.normal(size=m).astype(np.float32)
    q = (q - q.mean()) / q.std()
    cands = rng.normal(size=(k, m)).astype(np.float32)
    cands = (cands - cands.mean(1, keepdims=True)) / cands.std(1, keepdims=True)
    idx = np.arange(100, 100 + k, dtype=np.int32)
    cb = None
    if use_cb:
        u, low = envelope(torch.as_tensor(q), w)
        cb = cascade_keogh_cumulative(torch.as_tensor(cands), u, low)
    ds = np.array([pnp.dtw_naive(q, c, window=w) for c in cands])
    for ub in (float(np.median(ds)), 1e30, float(ds.min()) * 0.5):
        got_ub, got_best = ea_search_round(
            torch.as_tensor(q), torch.as_tensor(cands), ub, -1,
            torch.as_tensor(idx), w, cb=cb)
        want_ub, want_best = rcore.ea_search_round(
            jnp.asarray(q), jnp.asarray(cands), jnp.asarray(ub, jnp.float32),
            jnp.asarray(-1, jnp.int32), jnp.asarray(idx), w,
            cb=None if cb is None else jnp.asarray(cb.numpy()), backend="jax")
        assert int(got_best) == int(want_best)
        np.testing.assert_allclose(float(got_ub), float(want_ub), rtol=1e-5)
    # a tie with the incumbent keeps it (strict improvement only)
    best_ub, best = ea_search_round(
        torch.as_tensor(q), torch.as_tensor(cands), 1e30, -1,
        torch.as_tensor(idx), w)
    again = ea_search_round(torch.as_tensor(q), torch.as_tensor(cands),
                            best_ub, 7, torch.as_tensor(idx), w)
    assert int(again[1]) == 7 and float(again[0]) == float(best_ub)
    assert int(best) == 100 + int(np.argmin(ds))


def test_numpy_transcriptions_are_repro_copies():
    """The port's numpy oracles give ``repro``'s values and row traces."""
    rng = np.random.default_rng(10)
    for n, m, w in [(16, 16, None), (30, 22, None), (32, 32, 4), (20, 20, 0)]:
        for _ in range(4):
            s, t = rng.normal(size=n), rng.normal(size=m)
            d = rnp.dtw_naive(s, t, window=w)
            assert pnp.dtw_naive(s, t, window=w) == d
            assert pnp.dtw_rows(s, t) == rnp.dtw_rows(s, t)
            if not math.isfinite(d):
                continue
            kws = [{}]
            if n == m:  # cb tightening needs equal lengths
                u, low = envelope(torch.as_tensor(t), 0 if w is None else w)
                kws.append({"cb": cascade_keogh_cumulative(
                    torch.as_tensor(s), u, low).numpy()})
            for ub in (d * 0.6, d * (1 + EPS), d * 2):
                assert pnp.pruned_left(s, t, ub) == rnp.pruned_left(s, t, ub)
                assert (pnp.pruned_dtw_usp(s, t, ub, window=w)
                        == rnp.pruned_dtw_usp(s, t, ub, window=w))
                for kw in kws:
                    mine, theirs = pnp.EATrace(), rnp.EATrace()
                    got = pnp.ea_pruned_dtw(s, t, ub, window=w, trace=mine, **kw)
                    want = rnp.ea_pruned_dtw(s, t, ub, window=w, trace=theirs,
                                             **kw)
                    assert got == want
                    assert vars(mine) == vars(theirs)


@pytest.mark.parametrize("n,w", [(16, None), (32, 4), (20, 0), (24, 30),
                                 (40, 6)])
def test_ea_pruned_dtw_against_the_numpy_oracle(n, w):
    """The port's ``ea_pruned_dtw`` against its own copy of the literal
    transcription of Algorithm 3: the same distance (``inf`` where either
    abandons) over bounds below, at and above the DTW, and ``dtw_naive``
    under ``ub = inf``; without ``cb`` the same rows as the trace's
    ``rows_computed``. With ``cb`` the literal algorithm may detect the
    border collision a row before the full-row threshold does (``repro``'s
    ``ea_pruned_dtw`` counts as the port does), so only distances are
    compared there."""
    rng = np.random.default_rng(100 + n)
    for _ in range(12):
        s, t = rng.normal(size=n), rng.normal(size=n)
        d = pnp.dtw_naive(s, t, window=w)
        got = ea_pruned_dtw(s, t, math.inf, window=w)
        assert _same(got, d)
        u, low = envelope(torch.as_tensor(t), 0 if w is None else w)
        cb = cascade_keogh_cumulative(torch.as_tensor(s), u, low)
        for ub in (d * 0.5, d * 0.9, d * (1 + EPS), d * 2):
            trace = pnp.EATrace()
            want = pnp.ea_pruned_dtw(s, t, ub, window=w, trace=trace)
            got, info = ea_pruned_dtw(s, t, ub, window=w, with_info=True)
            assert _same(got, want), (float(got), want)
            assert int(info.rows) == trace.rows_computed
            want = pnp.ea_pruned_dtw(s, t, ub, window=w, cb=cb.numpy())
            assert _same(ea_pruned_dtw(s, t, ub, window=w, cb=cb), want)


def test_core_all_matches_repro():
    """``repro_torch.core`` exports ``repro.core``'s public API, less the
    backend selection the port has no use for (it dispatches by device)."""
    want = set(rcore.__all__) - {"BACKENDS", "resolve_backend"}
    assert set(core.__all__) == want
    for name in core.__all__:
        assert getattr(core, name) is not None
    assert core.BIG == rcore.BIG
