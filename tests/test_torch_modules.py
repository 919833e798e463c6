"""Module parity of the PyTorch port against ``repro`` on the CPU.

The same float32 inputs, made with numpy from a seed, go through each
``repro`` function and its counterpart in ``repro_torch``. Tolerances:
  * exact where both sides do the same exact operations (min/max, masks);
  * ``rtol=1e-6`` for elementwise float32 arithmetic (znorm, LB terms),
    which the two frameworks may round in another order within a sum;
  * ``rtol=1e-5`` for float32 prefix sums and DP distances, where XLA and
    torch add in different orders.
``tests/conftest.py`` turns on ``jax_enable_x64``, so ``repro`` is fed
float32 arrays explicitly.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import guards as r_guards
from repro.core.ea_pruned_dtw import ea_pruned_dtw_banded as r_banded
from repro.core.lower_bounds import (
    cascade_keogh_cumulative as r_cb,
    envelope as r_envelope,
    lb_keogh as r_lb_keogh,
    lb_kim_fl as r_lb_kim,
)
from repro.search.incumbents import IncumbentState as RState
from repro.search.incumbents import fold_min as r_fold_min
from repro_torch.core import guards
from repro_torch.core.common import (
    BIG,
    DEAD_LANE_UB,
    EPS,
    clamp_sigma,
    default_band_width,
    norm_window_slice,
    pad_lanes_to_blocks,
    row_scan,
)
from repro_torch.core.ea_pruned_dtw import ea_pruned_dtw_banded
from repro_torch.core.lower_bounds import (
    cascade_keogh_cumulative,
    envelope,
    lb_keogh,
    lb_kim_fl,
)
from repro_torch.search.incumbents import (
    IncumbentState,
    fold_min,
    initial_state,
    merge_states,
)
from repro_torch.search.pipeline import make_plan

# ``repro.search`` re-exports the function ``znorm`` under the module's name.
r_znorm = importlib.import_module("repro.search.znorm")
znorm = importlib.import_module("repro_torch.search.znorm")

torch.set_num_threads(1)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _series(n=1500, seed=0, flat=True):
    x = np.cumsum(_rng(seed).normal(size=n)).astype(np.float32)
    if flat:
        x[300:380] = x[300]
    return x


def test_constants_match():
    from repro.core import common as rc

    assert (BIG, DEAD_LANE_UB, EPS) == (rc.BIG, rc.DEAD_LANE_UB, rc.EPS)


@pytest.mark.parametrize("length", [16, 64])
def test_window_stats(length):
    # O(1) samples, as the search's series. Both sides difference float32
    # prefix sums (up to ~1.5e3 here, an ulp ~1e-4) and divide by the
    # length, so a window's variance carries ~1e-5 of absolute rounding on
    # either framework; compare variances at that scale (sigma itself, a
    # square root, magnifies it on the flat run where the variance is ~0).
    x = _rng(8).normal(size=1500).astype(np.float32)
    x[300:380] = x[300]
    mu_r, sg_r = r_znorm.window_stats(jnp.asarray(x), length)
    mu_t, sg_t = znorm.window_stats(_t(x), length)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sg_t.numpy() ** 2, np.asarray(sg_r) ** 2,
                               rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("length", [16, 64])
def test_window_stats_two_level_scan(length, monkeypatch):
    """The two-level prefix sum that ``window_stats`` runs on CUDA (rows of
    1024 samples, then the row totals; repeatable bit for bit there), run
    here on the CPU: same tolerances against ``repro`` as the sequential
    scan, and exact on the integer counts of the quarantine mask."""
    monkeypatch.setattr(znorm, "_cumsum", znorm._cumsum_two_level)
    test_window_stats(length)
    x = _series()
    x[[5, 700, 701, 1490]] = np.nan
    m_r = np.asarray(r_znorm.window_finite_mask(jnp.asarray(x), length))
    assert np.array_equal(znorm.window_finite_mask(_t(x), length).numpy(), m_r)


def test_window_finite_mask_and_sanitize():
    x = _series()
    x[[5, 700, 701, 1490]] = [np.nan, np.inf, -np.inf, np.nan]
    m_r = np.asarray(r_znorm.window_finite_mask(jnp.asarray(x), 32))
    m_t = znorm.window_finite_mask(_t(x), 32).numpy()
    assert np.array_equal(m_r, m_t)
    s_r = np.asarray(r_znorm.sanitize_series(jnp.asarray(x)))
    s_t = znorm.sanitize_series(_t(x)).numpy()
    assert np.array_equal(s_r, s_t)


def test_znorm_population_std():
    q = _rng(1).normal(size=(3, 40)).astype(np.float32) * 4 + 2
    q[2] = 7.0  # flat query: normalizes to zeros through clamp_sigma
    np.testing.assert_allclose(
        znorm.znorm(_t(q)).numpy(), np.asarray(r_znorm.znorm(jnp.asarray(q))),
        rtol=1e-6, atol=1e-6,
    )
    assert np.all(znorm.znorm(_t(q))[2].numpy() == 0.0)


@pytest.mark.parametrize("window", [0, 1, 5, 8])
def test_envelope_exact(window):
    q = _rng(2).normal(size=(3, 48)).astype(np.float32)
    u_r, l_r = r_envelope(jnp.asarray(q), window)
    u_t, l_t = envelope(_t(q), window)
    assert np.array_equal(u_t.numpy(), np.asarray(u_r))
    assert np.array_equal(l_t.numpy(), np.asarray(l_r))


def test_lower_bounds_match():
    rng = _rng(3)
    q = rng.normal(size=48).astype(np.float32)
    c = rng.normal(size=(7, 48)).astype(np.float32)
    u, low = (np.asarray(a) for a in r_envelope(jnp.asarray(q), 5))
    np.testing.assert_allclose(
        lb_keogh(_t(c), _t(u), _t(low)).numpy(),
        np.asarray(r_lb_keogh(jnp.asarray(c), jnp.asarray(u), jnp.asarray(low))),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        lb_kim_fl(_t(q), _t(c)).numpy(),
        np.asarray(r_lb_kim(jnp.asarray(q), jnp.asarray(c))), rtol=1e-6,
    )
    np.testing.assert_allclose(
        cascade_keogh_cumulative(_t(c), _t(u), _t(low)).numpy(),
        np.asarray(r_cb(jnp.asarray(c), jnp.asarray(u), jnp.asarray(low))),
        rtol=1e-6, atol=1e-6,
    )


def test_norm_window_slice_and_clamp():
    x = _series()
    mu, sg = znorm.window_stats(_t(x), 32)
    starts = torch.tensor([0, 290, 310, 1000, 1500 - 32])
    win = norm_window_slice(_t(x), starts, 32, mu, sg)
    for row, s in zip(win.numpy(), starts.tolist()):
        ref = (x[s : s + 32] - mu[s].item()) / max(sg[s].item(), EPS)
        np.testing.assert_allclose(row, ref, rtol=1e-6, atol=1e-6)
    assert np.all(win[2].numpy() == 0.0)  # a flat window
    assert clamp_sigma(torch.tensor([0.0, 1.0]))[0].item() == pytest.approx(EPS)


def test_pad_lanes_to_blocks():
    lb = torch.tensor([[1.0, 2.0, 3.0]])
    st = torch.tensor([[4, 5, 6]])
    lb_p, st_p, _ = pad_lanes_to_blocks(4, lb, st)
    assert lb_p.tolist() == [[1.0, 2.0, 3.0, float("inf")]]
    assert st_p.tolist() == [[4, 5, 6, 0]]


@pytest.mark.parametrize("window,m,want", [(5, 48, 32), (102, 1024, 224),
                                           (20, 30, 30), (0, 64, 32)])
def test_default_band_width_warp_aligned(window, m, want):
    assert default_band_width(window, m) == want


def test_row_scan_is_the_sequential_recurrence():
    rng = _rng(4)
    c = rng.random(20).astype(np.float32)
    d = (rng.random(20) * 3).astype(np.float32)
    curr = row_scan(_t(d), _t(c)).numpy()
    seq = np.empty(20, np.float32)
    for j in range(20):
        seq[j] = d[j] if j == 0 else min(d[j], c[j] + seq[j - 1])
    np.testing.assert_allclose(curr, seq, rtol=1e-5)


def _dp_lanes(seed, k=9, m=40):
    rng = _rng(seed)
    q = rng.normal(size=m).astype(np.float32)
    cand = rng.normal(size=(k, m)).astype(np.float32)
    return q, cand


@pytest.mark.parametrize("use_cb", [False, True])
@pytest.mark.parametrize("band_width", [None, 40])
def test_ea_pruned_dtw_banded_matches_repro(use_cb, band_width):
    """The port's per-lane-offset DP oracle, batched over lanes, against
    ``repro``'s vmapped banded DP; per-lane ub spans abandon and survive."""
    q, cand = _dp_lanes(5)
    w = 4
    full = np.asarray(jax.vmap(
        lambda c: r_banded(jnp.asarray(q), c, jnp.float32(np.inf), w)
    )(jnp.asarray(cand)))
    ub = np.where(np.arange(9) % 3 == 0, np.float32(-1.0),
                  np.float32(np.median(full))).astype(np.float32)
    ub[1] = np.inf
    cb = None
    if use_cb:
        u, low = r_envelope(jnp.asarray(q), w)
        cb = np.asarray(r_cb(jnp.asarray(cand), u, low))
    want = np.asarray(jax.vmap(
        lambda c, b, cbv: r_banded(jnp.asarray(q), c, b, w,
                                   band_width=band_width, cb=cbv),
        in_axes=(0, 0, 0 if use_cb else None),
    )(jnp.asarray(cand), jnp.asarray(ub), None if cb is None else jnp.asarray(cb)))
    got = ea_pruned_dtw_banded(
        _t(q), _t(cand), _t(ub), w, band_width=band_width,
        cb=None if cb is None else _t(cb),
    ).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=1e-5)


def test_ea_pruned_dtw_banded_info_and_scalar():
    q, cand = _dp_lanes(6, k=1)
    d, info = ea_pruned_dtw_banded(_t(q), _t(cand[0]), np.inf, 3, with_info=True)
    d_r, info_r = r_banded(jnp.asarray(q), jnp.asarray(cand[0]), jnp.inf, 3,
                           with_info=True)
    assert d.dim() == 0
    assert d.item() == pytest.approx(float(d_r), rel=1e-5)
    assert (int(info.rows), int(info.cells)) == (int(info_r.rows),
                                                 int(info_r.cells))


def test_fold_min_first_lane_strict_improvement():
    d = np.array([[3.0, 1.0, 1.0, np.inf], [np.inf] * 4, [2.0, 2.0, 5.0, 2.0]],
                 np.float32)
    starts = np.array([[10, 11, 12, 13], [20, 21, 22, 23], [30, 31, 32, 33]])
    ub0 = np.array([5.0, 5.0, 2.0], np.float32)  # query 2 ties: kept
    st = IncumbentState(ub=_t(ub0), best=torch.tensor([-1, -1, 7]))
    got, imp = fold_min(st, _t(starts), _t(d))
    want, imp_r = r_fold_min(
        RState(ub=jnp.asarray(ub0), best=jnp.asarray([-1, -1, 7])),
        jnp.asarray(starts), jnp.asarray(d))
    assert got.best.tolist() == np.asarray(want.best).tolist() == [11, -1, 7]
    assert got.ub.tolist() == np.asarray(want.ub).tolist()
    assert imp.tolist() == np.asarray(imp_r).tolist()


def test_initial_state_and_merge():
    s = initial_state(3, ub_init=2.5)
    assert s.ub.tolist() == [2.5] * 3 and s.best.tolist() == [-1] * 3
    assert initial_state(2).ub.tolist() == torch.tensor([BIG, BIG]).tolist()
    a = IncumbentState(ub=torch.tensor([1.0, 2.0]), best=torch.tensor([4, 5]))
    b = IncumbentState(ub=torch.tensor([1.0, 1.5]), best=torch.tensor([8, 9]))
    m = merge_states(a, b)
    assert m.best.tolist() == [4, 9] and m.ub.tolist() == [1.0, 1.5]


def test_guard_taxonomy():
    assert issubclass(guards.SearchInputError, ValueError)
    assert issubclass(guards.NonFiniteInputError, guards.SearchInputError)
    assert issubclass(guards.StreamStateError, RuntimeError)
    for name in ("SearchInputError", "NonFiniteInputError", "StreamStateError"):
        mine, theirs = getattr(guards, name), getattr(r_guards, name)
        assert [c.__name__ for c in mine.__mro__] == [
            c.__name__ for c in theirs.__mro__]
    e = guards.StreamStateError("bad", n_seen=5, chunk_index=2)
    assert str(e) == str(r_guards.StreamStateError("bad", n_seen=5, chunk_index=2))


@pytest.mark.parametrize("kw", [
    dict(length=1, window=0),
    dict(length=8, window=8),
    dict(length=8, window=2, batch=0),
    dict(length=8, window=2, variant="dtw"),
    dict(length=8, window=2, gather="gather"),
    dict(length=8, window=2, rounds="device"),
    dict(length=8, window=2, slab_budget=0),
    dict(length=8, window=2, rounds="persistent", with_info=True),
])
def test_make_plan_validation_matches_repro(kw):
    """Both packages reject the same knobs with the same exception class."""
    from repro.search.pipeline import make_plan as r_make_plan

    with pytest.raises(ValueError) as theirs:
        r_make_plan(**kw)
    with pytest.raises(ValueError) as mine:
        make_plan(**kw)
    assert type(mine.value).__name__ == type(theirs.value).__name__


@pytest.mark.parametrize("kw,item", [
    (dict(with_info=True), "item 6"),
    (dict(variant="full"), "item 6"),
    (dict(variant="pruned"), "item 6"),
])
def test_make_plan_unported_raise_with_roadmap_item(kw, item):
    """Once refused as unported (ROADMAP.md Queue 1 ``item``), these
    knobs now make the plan ``repro`` makes."""
    from repro.search.pipeline import make_plan as r_make_plan

    del item
    mine = make_plan(length=16, window=2, **kw)
    theirs = r_make_plan(length=16, window=2, **kw)
    for knob in ("variant", "use_lb", "use_cb", "rounds", "gather"):
        assert getattr(mine, knob) == getattr(theirs, knob)


def test_ensure_finite_and_series():
    with pytest.raises(guards.NonFiniteInputError):
        guards.ensure_finite(torch.tensor([1.0, float("nan")]), "q")
    with pytest.raises(guards.SearchInputError):
        guards.ensure_series(torch.zeros(3, dtype=torch.int64), "ref")
    with pytest.raises(guards.SearchInputError):
        guards.ensure_series(np.zeros((2, 3), np.float32), "ref", ndim=1)
    with pytest.raises(guards.SearchInputError):
        guards.ensure_series(np.zeros(3, np.float32), "ref", min_len=4)
