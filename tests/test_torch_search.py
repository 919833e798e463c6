"""The port's main path end to end against ``repro`` on the CPU.

``repro_torch.search.multi_query_search`` (``device="cpu"``, so both kernels
run their plain versions) against ``repro.search.multi_query_search`` with
``backend="jax"``, on the same float32 series from ``data/synthetic.py``.

Tolerances: ``best_start`` and quarantine counts must be equal exactly.
Distances ``rtol=1e-4``: each side computes its own float32 prefix-sum
window stats (XLA and torch add in different orders), and the DTW sum then
rounds differently too. REFIT is the exception: its samples reach ~30, so
its prefix sums of ``x * x`` reach ~2e6 where a float32 ulp is 0.25, and
the two frameworks' window sigmas differ by up to ~1e-2 relative at
N = 3000 (measured 8.7e-3); distances then move by ~1e-3, so REFIT takes
``rtol=5e-3``. Fed the same stats, a REFIT round and the REFIT search
after stage 1 agree to 1e-5 (``test_torch_interop.py``). A seed that is never beaten comes back
unchanged on both sides, exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.search import multi_query_search as r_multi
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.search import multi_query_search

torch.set_num_threads(1)

N, LENGTH, WINDOW, Q, BATCH = 3000, 48, 5, 3, 32  # 2953 windows: ragged


def _data(name="ECG", nan_burst=False):
    ref = make_dataset(name, N, seed=0).astype(np.float32)
    if nan_burst:
        ref[1200:1210] = np.nan
        ref[2500] = np.inf
    return ref, make_queries(name, Q, LENGTH, seed=1).astype(np.float32)


def _both(ref, queries, **kw):
    want = r_multi(jnp.asarray(ref), jnp.asarray(queries), LENGTH, WINDOW,
                   batch=BATCH, backend="jax", **kw)
    got = multi_query_search(ref, queries, LENGTH, WINDOW, batch=BATCH,
                             device="cpu", **kw)
    return want, got


RTOL = {"ECG": 1e-4, "REFIT": 5e-3}


def _assert_same(want, got, name="ECG"):
    assert got.best_start.tolist() == np.asarray(want.best_start).tolist()
    assert int(got.quarantined) == int(want.quarantined)
    np.testing.assert_allclose(got.best_dist.numpy(),
                               np.asarray(want.best_dist), rtol=RTOL[name])
    assert got.rows.tolist() == [-1] * Q and got.cells.tolist() == [-1] * Q


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
@pytest.mark.parametrize("name", ["ECG", "REFIT"])
def test_multi_query_matches_repro(name, variant):
    want, got = _both(*_data(name), variant=variant)
    _assert_same(want, got, name)
    assert got.best_start.device.type == "cpu"
    if variant == "eapruned_nolb":  # no cascade: every round, ragged last
        assert got.rounds.tolist() == [-(-(N - LENGTH + 1) // BATCH)] * Q
        assert got.lanes.tolist() == np.asarray(want.lanes).tolist()


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
def test_multi_query_nan_burst_quarantine(variant):
    want, got = _both(*_data(nan_burst=True), variant=variant)
    _assert_same(want, got)
    # 10 + 1 bad samples condemn every window overlapping them.
    assert int(got.quarantined) == (1209 - 1200 + LENGTH) + LENGTH


def test_multi_query_ub_init_seeds():
    """Per-query seeds: unbeatable (returns -1 and the seed), tight but
    beatable, and loose."""
    ref, queries = _data()
    free = multi_query_search(ref, queries, LENGTH, WINDOW, batch=BATCH,
                              device="cpu")
    d = free.best_dist.numpy()
    seeds = np.array([d[0] * 0.5, d[1] * 1.01, d[2] * 10.0], np.float32)
    want, got = _both(ref, queries, ub_init=seeds)
    _assert_same(want, got)
    assert got.best_start[0].item() == -1
    assert got.best_dist[0].item() == seeds[0]
    assert got.best_start[1:].tolist() == free.best_start[1:].tolist()


def test_multi_query_scalar_unbeatable_seed():
    ref, queries = _data("REFIT")
    want, got = _both(ref, queries, ub_init=np.float32(1e-6))
    _assert_same(want, got, "REFIT")
    assert got.best_start.tolist() == [-1] * Q
    assert got.best_dist.tolist() == [np.float32(1e-6).item()] * Q


@pytest.mark.parametrize("variant", ["eapruned", "eapruned_nolb"])
def test_multi_query_warm_start(variant):
    ref, queries = _data()
    want, got = _both(ref, queries, variant=variant, warm_start=4)
    _assert_same(want, got)
    cold = multi_query_search(ref, queries, LENGTH, WINDOW, batch=BATCH,
                              variant=variant, device="cpu")
    assert got.best_start.tolist() == cold.best_start.tolist()


def test_multi_query_input_guards():
    from repro_torch.core import guards

    ref, queries = _data()
    bad = queries.copy()
    bad[1, 3] = np.nan
    with pytest.raises(guards.NonFiniteInputError):
        multi_query_search(ref, bad, LENGTH, WINDOW, device="cpu")
    with pytest.raises(guards.NonFiniteInputError):
        multi_query_search(ref, queries, LENGTH, WINDOW, device="cpu",
                           ub_init=np.array([1.0, np.nan, 1.0], np.float32))
    with pytest.raises(guards.SearchInputError):
        multi_query_search(ref, queries[0], LENGTH, WINDOW, device="cpu")
    with pytest.raises(guards.SearchInputError):
        multi_query_search(ref, queries, LENGTH, WINDOW, variant="full",
                           device="cpu")
