"""The port's batch primitives, package exports and search config against
``repro`` on the CPU.

* Value checks: the public ``ea_pruned_dtw_batch`` /
  ``ea_pruned_dtw_multi_batch`` raise ``repro``'s exception class on a NaN
  ``ub``, a non-finite query and a negative ``cb`` (``repro`` checks
  concrete arrays only, so its jitted rounds never do; the port's round
  loops call the unchecked inner functions).
* The multivariate batch: an ``(m, dims)`` query against ``(K, m, dims)``
  candidates gives ``repro``'s jax backend's distances.
* Every name of ``repro``'s package ``__all__`` and every ``SearchConfig``
  field is in the port's, except the ``backend`` names.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core
import repro.kernels
import repro.search
import repro_torch.core
import repro_torch.kernels
import repro_torch.search
from repro.configs.dtw_search import SearchConfig as RSearchConfig
from repro.core import guards as r_guards
from repro.core.batch import ea_pruned_dtw_batch as r_batch
from repro.core.batch import ea_pruned_dtw_multi_batch as r_multi_batch
from repro_torch.configs.dtw_search import SearchConfig
from repro_torch.core import guards
from repro_torch.core import batch as batch_mod
from repro_torch.core.batch import (
    ea_pruned_dtw_batch,
    ea_pruned_dtw_multi_batch,
    ea_pruned_dtw_multi_batch_fused,
)
from repro_torch.search import multi_query_search

torch.set_num_threads(1)

M, K, W, DIMS = 32, 5, 3, 3
BACKEND_NAMES = {"backend", "BACKENDS", "resolve_backend"}


def _data(dims=None, q=None):
    rng = np.random.default_rng(21)
    tail = () if dims is None else (dims,)
    lead = () if q is None else (q,)
    query = rng.normal(size=lead + (M,) + tail).astype(np.float32)
    cand = rng.normal(size=lead + (K, M) + tail).astype(np.float32)
    return query, cand


def _cases():
    """The five value faults: (name, multi, query, candidates, ub, cb)."""
    q1, c1 = _data()
    qm, cm = _data(q=2)
    nan_q = q1.copy()
    nan_q[5] = np.nan
    inf_qm = qm.copy()
    inf_qm[1, 7] = np.inf
    ub_m = np.full((2, 1), 50.0, np.float32)
    ub_m[1, 0] = np.nan
    return {
        "nan_ub": (False, q1, c1, np.float32(np.nan), None),
        "nan_query": (False, nan_q, c1, np.float32(50.0), None),
        "negative_cb": (False, q1, c1, np.float32(50.0),
                        -np.ones((K, M), np.float32)),
        "multi_nan_ub": (True, qm, cm, ub_m, None),
        "multi_inf_query": (True, inf_qm, cm, np.float32(50.0), None),
    }


CASES = _cases()


def _raised(fn) -> type:
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value)


@pytest.mark.parametrize("name", sorted(CASES))
def test_value_faults_raise_repros_class(name):
    multi, q, c, ub, cb = CASES[name]
    r_fn, p_fn = ((r_multi_batch, ea_pruned_dtw_multi_batch) if multi
                  else (r_batch, ea_pruned_dtw_batch))
    r_cls = _raised(lambda: r_fn(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(ub), W,
        cb=None if cb is None else jnp.asarray(cb), backend="jax"))
    p_cls = _raised(lambda: p_fn(
        torch.from_numpy(q), torch.from_numpy(c), torch.as_tensor(ub), W,
        cb=None if cb is None else torch.from_numpy(cb)))
    assert r_cls in (r_guards.SearchInputError, r_guards.NonFiniteInputError)
    assert p_cls is getattr(guards, r_cls.__name__)


def test_fused_round_checks_values_too():
    """The fused primitive checks the query and ``ub`` as well (``repro``'s
    skips them; its checks run in the frontends)."""
    qm, _ = _data(q=2)
    ref = torch.from_numpy(
        np.cumsum(np.random.default_rng(3).normal(size=400)).astype(np.float32))
    starts = torch.zeros((2, K), dtype=torch.int32)
    mu = torch.zeros(400 - M + 1)
    sigma = torch.ones(400 - M + 1)
    bad = qm.copy()
    bad[0, 0] = np.nan
    with pytest.raises(guards.NonFiniteInputError):
        ea_pruned_dtw_multi_batch_fused(torch.from_numpy(bad), ref, starts,
                                        50.0, W, mu, sigma)
    with pytest.raises(guards.NonFiniteInputError, match="ub contains NaN"):
        ea_pruned_dtw_multi_batch_fused(torch.from_numpy(qm), ref, starts,
                                        float("nan"), W, mu, sigma)


def test_round_loops_make_no_value_check(monkeypatch):
    """A search's rounds go through the unchecked inner functions: a
    value check (a host read) in a round would fail here."""
    def refuse(*args, **kwargs):
        raise AssertionError("a round made a value check")

    monkeypatch.setattr(batch_mod, "check_batch_values", refuse)
    rng = np.random.default_rng(4)
    ref = np.cumsum(rng.normal(size=1_500)).astype(np.float32)
    qs = np.cumsum(rng.normal(size=(2, 64)), axis=1).astype(np.float32)
    for gather in ("fused", "slab"):
        res = multi_query_search(ref, qs, 64, 6, batch=32, gather=gather,
                                 device="cpu")
        assert res.best_start.shape == (2,)


@pytest.mark.parametrize("bound", ["cold", "between"])
def test_multivariate_batch_matches_repro(bound):
    """Cold, every lane finishes; under a bound halfway between the second
    and third cold distances (no lane within rounding of it), three lanes
    abandon (``+inf``) and the rest finish with the same distances."""
    q, c = _data(dims=DIMS)

    def theirs(ub):
        return np.asarray(r_batch(jnp.asarray(q), jnp.asarray(c),
                                  jnp.float32(ub), W, backend="jax"))

    ub = np.float32(np.inf)
    if bound == "between":
        d = np.sort(theirs(ub))
        ub = np.float32((d[1] + d[2]) / 2)
    want = theirs(ub)
    got = ea_pruned_dtw_batch(torch.from_numpy(q), torch.from_numpy(c),
                              torch.tensor(ub), W)
    assert got.shape == (K,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.astype(np.float32),
                               rtol=1e-5)
    if bound == "between":
        assert np.isinf(want).sum() == K - 2


@pytest.mark.parametrize("pair", ["search", "kernels", "core"])
def test_package_exports_cover_repros(pair):
    theirs, mine = {
        "search": (repro.search, repro_torch.search),
        "kernels": (repro.kernels, repro_torch.kernels),
        "core": (repro.core, repro_torch.core),
    }[pair]
    missing = set(theirs.__all__) - set(mine.__all__) - BACKEND_NAMES
    assert not missing, sorted(missing)
    for name in mine.__all__:
        assert getattr(mine, name) is not None


def test_search_config_fields_cover_repros():
    theirs = {f.name for f in dataclasses.fields(RSearchConfig)}
    mine = {f.name for f in dataclasses.fields(SearchConfig)}
    assert not (theirs - mine - BACKEND_NAMES), sorted(theirs - mine)
    cfg = SearchConfig(rows_per_step=2, row_block=64)
    plan = cfg.make_plan()
    assert (plan.rows_per_step, plan.row_block) == (2, 64)
