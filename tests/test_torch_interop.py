"""Rounds of the port fed ``repro``'s own stage-1 products through
``repro_torch.interop.from_numpy``.

Both packages then see the same ``mu``, ``sigma``, ``qn``, ``u``, ``low``,
best-first order and incumbents, so what is left between them is the order
of float32 sums inside the DP (the jax round runs a sequential cumsum per
lane offset, the port's plain round kernel a sequential cumsum over the
window-following band). The closed-form row ``P + cummin(d - P)`` carries
the rounding of ``P``, the band's running row cost (~10-100 here, where an
ulp is ~1e-6-1e-5), into a distance as an absolute error however small the
distance is: ``rtol=1e-5, atol=1e-4`` on distances, exact abandon masks and
``best_start``. This holds round-level parity apart from the prefix-sum
rounding of ``window_stats`` (see ``test_torch_search.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.search import pipeline as rp
from repro.search.incumbents import initial_state as r_initial_state
from repro_torch import interop
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.search import pipeline as tp
from repro_torch.search.incumbents import IncumbentState

torch.set_num_threads(1)

N, LENGTH, WINDOW, Q, BATCH = 2500, 40, 4, 2, 24


def _stage1(name, variant="eapruned"):
    ref = make_dataset(name, N, seed=2).astype(np.float32)
    ref[700:705] = np.nan
    queries = make_queries(name, Q, LENGTH, seed=3).astype(np.float32)
    plan_r = rp.make_plan(length=LENGTH, window=WINDOW, batch=BATCH,
                          variant=variant, backend="jax")
    plan_t = tp.make_plan(length=LENGTH, window=WINDOW, batch=BATCH,
                          variant=variant)
    prep = rp.prepare_ref(plan_r, jnp.asarray(ref))
    pq = rp.prepare_queries(plan_r, jnp.asarray(queries))
    order, lb_sorted = rp.cascade(plan_r, prep, pq.qn)
    prep_t = interop.from_numpy(
        tp.PreparedRef, "cpu", **{k: np.asarray(v) for k, v in prep._asdict().items()})
    pq_t = interop.from_numpy(
        tp.PreparedQueries, "cpu", **{k: np.asarray(v) for k, v in pq._asdict().items()})
    return plan_r, plan_t, prep, pq, order, lb_sorted, prep_t, pq_t


@pytest.mark.parametrize("use_cb", [False, True])
@pytest.mark.parametrize("name", ["ECG", "REFIT"])
def test_round_with_shared_stats(name, use_cb):
    plan_r, plan_t, prep, pq, order, lb_sorted, prep_t, pq_t = _stage1(name)
    starts = np.array(order)[:, 3 * BATCH : 4 * BATCH]
    lbs = np.array(lb_sorted)[:, 3 * BATCH : 4 * BATCH]
    ub = np.full((Q, BATCH), 1e30, np.float32)
    ub[:, ::5] = -1.0
    d_r, _ = rp._dtw_round_fused(plan_r, prep, pq, jnp.asarray(starts),
                                 jnp.asarray(ub), use_cb=use_cb,
                                 with_info=False)
    d_t = tp._dtw_round_fused(plan_t, prep_t, pq_t, torch.from_numpy(starts),
                              torch.from_numpy(ub), use_cb=use_cb)
    d_r = np.asarray(d_r)
    assert np.isfinite(lbs).all()
    fin = np.isfinite(d_r)
    assert np.array_equal(np.isfinite(d_t.numpy()), fin) and fin.sum() > 0
    np.testing.assert_allclose(d_t.numpy()[fin], d_r[fin], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
@pytest.mark.parametrize("name", ["ECG", "REFIT"])
def test_host_rounds_with_shared_stats(name, variant):
    """The whole host-round driver on the same order and incumbents: the
    quarantined NaN burst rides as dead lanes on both sides."""
    plan_r, plan_t, prep, pq, order, lb_sorted, prep_t, pq_t = _stage1(
        name, variant)
    seeds = np.array([1e30, 1e30], np.float32)
    st_r, stats_r = rp.run_host_rounds(
        plan_r, prep, pq, order, lb_sorted,
        r_initial_state(Q, jnp.float32, jnp.asarray(seeds), order.dtype))
    st0 = interop.from_numpy(IncumbentState, "cpu", ub=seeds,
                             best=np.full(Q, -1, np.int64))
    st_t, stats_t = tp.run_host_rounds(
        plan_t, prep_t, pq_t, torch.from_numpy(np.array(order)),
        torch.from_numpy(np.array(lb_sorted)), st0)
    assert st_t.best.tolist() == np.asarray(st_r.best).tolist()
    np.testing.assert_allclose(st_t.ub.numpy(), np.asarray(st_r.ub), rtol=1e-5,
                               atol=1e-4)
    assert stats_t.rounds.tolist() == np.asarray(stats_r.rounds).tolist()
    assert stats_t.lanes.tolist() == np.asarray(stats_r.lanes).tolist()
    assert int(prep_t.n_quar) == int(prep.n_quar) == 5 + LENGTH - 1


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
@pytest.mark.parametrize("name", ["ECG", "REFIT"])
def test_search_with_shared_stats(name, variant):
    """The search after stage 1, fed ``repro``'s stage-1 products: the
    port's own cascade (kernel B's plain version on the shared stats) and
    its host rounds against ``repro``'s cascade and rounds. This holds the
    REFIT search tightly, where ``test_torch_search.py`` must allow for
    each side's own window stats."""
    plan_r, plan_t, prep, pq, order, lb_sorted, prep_t, pq_t = _stage1(
        name, variant)
    st_r, stats_r = rp.run_host_rounds(
        plan_r, prep, pq, order, lb_sorted,
        r_initial_state(Q, jnp.float32, None, order.dtype))
    order_t, lb_t = tp.cascade(plan_t, prep_t, pq_t.qn)
    np.testing.assert_allclose(lb_t.numpy(), np.asarray(lb_sorted), rtol=1e-5,
                               atol=1e-5)
    st_t, stats_t = tp.run_host_rounds(
        plan_t, prep_t, pq_t, order_t, lb_t, tp.initial_state(Q))
    assert st_t.best.tolist() == np.asarray(st_r.best).tolist()
    np.testing.assert_allclose(st_t.ub.numpy(), np.asarray(st_r.ub), rtol=1e-5,
                               atol=1e-4)
    assert stats_t.rounds.tolist() == np.asarray(stats_r.rounds).tolist()
    assert stats_t.lanes.tolist() == np.asarray(stats_r.lanes).tolist()


def test_from_numpy_types_and_checks():
    st = interop.from_numpy(IncumbentState, "cpu",
                            ub=np.array([1.0, 2.0]), best=np.array([3, -1]))
    assert st.ub.dtype == torch.float32 and st.best.dtype == torch.int64
    p = interop.from_numpy(tp.PreparedRef, "cpu", ref=np.zeros(5), mu=np.zeros(2),
                           sigma=np.ones(2), valid=None, n_quar=np.int32(0))
    assert p.valid is None and p.ref.dtype == torch.float32
    with pytest.raises(TypeError, match="missing"):
        interop.from_numpy(IncumbentState, "cpu", ub=np.zeros(2))
    with pytest.raises(TypeError):
        interop.from_numpy(dict, "cpu")
