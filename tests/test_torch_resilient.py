"""The port's fault-tolerant range search against ``repro``'s on the CPU.

``repro_torch.search.resilient_search`` (``device="cpu"``: each range runs
the plain versions of kernels B and A) beside ``repro``'s with
``backend="jax"``, on the same float32 ECG-like series and queries, under
every ``tests/faults.py`` ``ShardFaultInjector`` recipe that
``tests/test_resilient.py`` uses. Each package's runner is its own
``HostRoundsExecutor.run_range`` (the default runner), wrapped by a fresh
injector, with a ``FakeClock`` and a recorder for the backoff sleeps.

The parity contract: ``best_start``, ``coverage``, ``uncovered``,
``attempts``, ``reassignments``, ``failed_shards``, ``hedges_launched``,
``hedges_won``, ``quarantined``, the latency, the ``shard_health``
snapshots (EWMAs included, on the fake clock), the recorded sleeps and the
injector's calls equal exactly; ``best_dist`` within ``rtol=1e-4`` (each
side computes its own float32 window stats over each range's slice).
Whole-coverage results are also held to the port's ``multi_query_search``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.search import IncumbentState as RIncumbentState
from repro.search import HostRoundsExecutor as RHostRoundsExecutor
from repro.search import make_plan as r_make_plan
from repro.search import resilient_search as r_resilient_search
from repro.search.pipeline import MULTI_VARIANTS as R_MULTI_VARIANTS
from repro.search.resilient import _merge_ranges as r_merge_ranges
from repro.search.resilient import partition_ranges as r_partition_ranges
from repro_torch.configs.dtw_search import SearchConfig
from repro_torch.core import guards
from repro_torch.data.synthetic import make_dataset, make_queries
from repro_torch.search import (
    CoverageError,
    HostRoundsExecutor,
    multi_query_search,
    resilient_search,
)
from repro_torch.search.pipeline import MULTI_VARIANTS, make_plan
from repro_torch.search.resilient import (
    _merge_ranges,
    executor_runner,
    partition_ranges,
)

from faults import FakeClock, ShardFaultInjector, fault_seed, plant_nonfinite

torch.set_num_threads(1)

N, L, W, Q, B = 2400, 64, 6, 3, 32  # 2337 windows: ranges of two lengths
RTOL = 1e-4
N_WIN = N - L + 1


def _data(dirty=False, n=N):
    seed = fault_seed()
    ref = make_dataset("ECG", n, seed=seed).astype(np.float32)
    if dirty:
        ref = plant_nonfinite(ref, [(700, 4, np.nan), (1800, 2, np.inf)])
        ref = ref.astype(np.float32)
    return ref, make_queries("ECG", Q, L, seed=seed + 1).astype(np.float32)


def _runners(ref, queries, batch=B):
    """Each package's default range runner (its ``HostRoundsExecutor``),
    exposed so the recipes can wrap it."""
    plan = make_plan(length=L, window=W, batch=batch,
                     allowed_variants=MULTI_VARIANTS)
    mine = executor_runner(HostRoundsExecutor(ref, queries, device="cpu"),
                           plan)
    rplan = r_make_plan(length=L, window=W, batch=batch, backend="jax",
                        allowed_variants=R_MULTI_VARIANTS)
    rex = RHostRoundsExecutor(jnp.asarray(ref), jnp.asarray(queries))
    nq = queries.shape[0]

    def theirs(shard, lo, hi, ub):
        state = RIncumbentState(ub=jnp.asarray(ub, jnp.float32),
                                best=jnp.full((nq,), -1, jnp.int64))
        rr = rex.run_range(rplan, state, int(lo), int(hi))
        return (np.asarray(rr.state.best, np.int64),
                np.asarray(rr.state.ub, np.float64), int(rr.quarantined))

    return mine, theirs


def _both(ref, queries, recipe=None, runners=None, **kw):
    """``resilient_search`` of each package, each with a fresh injector of
    ``recipe`` over its own runner (``recipe=None``: no injector; with no
    ``runners`` either, the default runner), a ``FakeClock`` and a sleep
    recorder. Returns ``[(result or exception, injector, sleeps), ...]``
    for the port, then ``repro``."""
    runners = runners or (_runners(ref, queries) if recipe is not None
                          else (None, None))
    out = []
    for fn, runner, extra in (
        (resilient_search, runners[0], {"device": "cpu"}),
        (r_resilient_search, runners[1], {"backend": "jax"}),
    ):
        clock = FakeClock()
        sleeps = []
        inj = runner
        if recipe is not None:
            inj = ShardFaultInjector(runner, clock=clock, **recipe)
        args = dict(dict(n_shards=4, batch=B, sleep=sleeps.append,
                         clock=clock), **kw)
        if inj is not None:
            args["runner"] = inj
        if runner is None:
            args.update(extra)
        elif fn is resilient_search:
            args["device"] = "cpu"
        try:
            res = fn(ref, queries, L, W, **args)
        except Exception as e:  # compared with the other side's below
            res = e
        out.append((res, inj, sleeps))
    return out


def _assert_parity(pair):
    (mine, inj_m, sleeps_m), (theirs, inj_t, sleeps_t) = pair
    assert np.array_equal(mine.best_start, theirs.best_start)
    np.testing.assert_allclose(mine.best_dist, theirs.best_dist, rtol=RTOL)
    for field in ("coverage", "uncovered", "quarantined", "attempts",
                  "reassignments", "failed_shards", "hedges_launched",
                  "hedges_won", "latency"):
        assert getattr(mine, field) == getattr(theirs, field), field
    assert ([tuple(h) for h in mine.shard_health]
            == [tuple(h) for h in theirs.shard_health])
    assert sleeps_m == sleeps_t
    if isinstance(inj_m, ShardFaultInjector):
        assert inj_m.calls == inj_t.calls


def _offline(ref, queries, **kw):
    return multi_query_search(ref, queries, L, W, batch=B, device="cpu",
                              **kw)


def _assert_offline(res, ref, queries):
    base = _offline(ref, queries)
    assert res.coverage == 1.0 and res.uncovered == ()
    assert np.array_equal(res.best_start, base.best_start.numpy())
    np.testing.assert_allclose(res.best_dist, base.best_dist.numpy(),
                               rtol=RTOL)
    assert res.quarantined == int(base.quarantined)


# -- clean path -----------------------------------------------------------

@pytest.mark.parametrize("n_win,n_shards",
                         [(100, 4), (7, 3), (3, 8), (0, 4), (1, 1), (N_WIN, 8)])
def test_partition_ranges_same_as_repro(n_win, n_shards):
    ranges = partition_ranges(n_win, n_shards)
    assert ranges == r_partition_ranges(n_win, n_shards)
    assert _merge_ranges(ranges[::-1]) == r_merge_ranges(ranges[::-1])
    assert _merge_ranges(ranges) == (((0, n_win),) if n_win else ())


@pytest.mark.parametrize("n_shards,n_ranges", [(4, None), (3, 7), (1, None)])
def test_clean_matches_offline_and_repro(n_shards, n_ranges):
    ref, queries = _data()
    pair = _both(ref, queries, n_shards=n_shards, n_ranges=n_ranges)
    _assert_parity(pair)
    res = pair[0][0]
    assert res.attempts == len(partition_ranges(N_WIN, n_ranges or n_shards))
    assert res.reassignments == 0 and res.failed_shards == ()
    _assert_offline(res, ref, queries)


def test_dirty_ref_quarantine_count_matches_offline():
    ref, queries = _data(dirty=True)
    pair = _both(ref, queries, n_shards=3)
    _assert_parity(pair)
    res = pair[0][0]
    assert res.quarantined == 2 * L + 4  # (4 + L - 1) + (2 + L - 1)
    _assert_offline(res, ref, queries)


def test_ub_init_seeds_every_range():
    """A seed below every window stays unbeaten (start -1, the seed's
    bits); a loose one changes nothing."""
    ref, queries = _data()
    tight = _both(ref, queries, ub_init=np.float32(1e-3))
    _assert_parity(tight)
    assert (tight[0][0].best_start == -1).all()
    assert (tight[0][0].best_dist == np.float32(1e-3)).all()
    loose = _both(ref, queries, ub_init=np.float32(1e6))
    _assert_parity(loose)
    _assert_offline(loose[0][0], ref, queries)


# -- faults ---------------------------------------------------------------

_RANGES = partition_ranges(N_WIN, 4)

# name: (recipe, resilient_search kwargs)
RECIPES = {
    "flaky_range": ({"flaky_ranges": {_RANGES[1][0]}}, {"backoff": 0.01}),
    "flaky_no_jitter": ({"flaky_ranges": {_RANGES[0][0], _RANGES[3][0]}},
                        {"backoff": 0.01, "jitter": False}),
    "dead_shard": ({"dead_shards": {1}},
                   {"max_retries": 1, "backoff": 0.0}),
    "fail_after": ({"dead_shards": {1, 2}, "fail_after": {0: 1}},
                   {"max_retries": 0, "backoff": 0.0}),
    "timeout_strike": ({"slow_shards": {0: 0.05}, "base_dt": 0.001},
                       {"timeout": 0.01, "max_retries": 0}),
    "timeout_shard": ({"timeout_shards": {2}},
                      {"max_retries": 1, "backoff": 0.01}),
    "dead_range": ({"dead_ranges": {_RANGES[2][0]}},
                   {"max_retries": 0, "backoff": 0.0}),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_fault_recipe_parity(name):
    recipe, kw = RECIPES[name]
    ref, queries = _data()
    pair = _both(ref, queries, recipe=recipe, **kw)
    _assert_parity(pair)
    res, inj, sleeps = pair[0]
    if name == "flaky_range":
        # one first-attempt backoff, jittered in [base, 3 base), then healed
        assert len(sleeps) == 1 and 0.01 <= sleeps[0] < 0.03
        assert res.attempts == 5 and res.failed_shards == ()
    elif name == "flaky_no_jitter":
        assert sleeps == [0.01, 0.01] and res.attempts == 6
    elif name == "dead_shard":
        assert res.failed_shards == (1,) and res.reassignments == 1
        assert len([c for c in inj.calls if c[3] and c[0] != 1]) == 4
    elif name == "fail_after":
        assert set(res.failed_shards) == {0, 1, 2}
        assert res.reassignments >= 3
    elif name == "timeout_strike":
        # the slow attempt's (correct) result was kept, the shard struck
        assert res.failed_shards == (0,)
    elif name == "timeout_shard":
        assert res.failed_shards == (2,) and len(sleeps) == 1
    if name == "dead_range":
        frac = 1 - (_RANGES[2][1] - _RANGES[2][0]) / N_WIN
        assert res.coverage == pytest.approx(frac)
        assert res.uncovered == (_RANGES[2],)
        assert set(res.failed_shards) == set(range(4))
    else:
        _assert_offline(res, ref, queries)


def test_dead_last_range_exact_over_covered_prefix():
    """The last range dead on every shard: exactly it is uncovered, and
    each winner is the offline search's over the covered prefix."""
    ref, queries = _data()
    ranges = partition_ranges(N_WIN, 6)
    lo, hi = ranges[-1]
    pair = _both(ref, queries, recipe={"dead_ranges": {lo}}, n_ranges=6,
                 max_retries=0, backoff=0.0)
    _assert_parity(pair)
    res = pair[0][0]
    assert res.coverage == (N_WIN - (hi - lo)) / N_WIN  # 1 - len / n_win
    assert res.uncovered == ((lo, hi),)
    prefix = _offline(ref[:lo + L - 1], queries)
    assert np.array_equal(res.best_start, prefix.best_start.numpy())
    np.testing.assert_allclose(res.best_dist, prefix.best_dist.numpy(),
                               rtol=RTOL)


def test_require_full_coverage_raises():
    ref, queries = _data()
    pair = _both(ref, queries, recipe={"dead_ranges": {0}}, max_retries=0,
                 backoff=0.0, require_full_coverage=True)
    (mine, _, _), (theirs, _, _) = pair
    assert isinstance(mine, CoverageError)
    assert isinstance(mine, RuntimeError)
    assert mine.uncovered == theirs.uncovered == ((0, _RANGES[0][1]),)
    assert "uncovered" in str(mine)


def test_partial_progress_from_failed_attempt_is_folded():
    """A crashed range that reports an achieved ``(start, dist)`` pair
    keeps that incumbent even though the range itself stays uncovered."""
    ref, queries = _data()
    lo, hi = _RANGES[1]
    inside = _offline(ref[lo:hi + L - 1], queries)
    p_best = inside.best_start.numpy() + lo
    p_ub = inside.best_dist.numpy().astype(np.float64)
    pair = _both(ref, queries,
                 recipe={"dead_ranges": {lo}, "partial": {lo: (p_best, p_ub)}},
                 max_retries=0, backoff=0.0)
    _assert_parity(pair)
    res = pair[0][0]
    assert res.coverage < 1.0
    # the answer of the whole search, despite the lost range
    base = _offline(ref, queries)
    assert np.array_equal(res.best_start, base.best_start.numpy())
    np.testing.assert_allclose(res.best_dist, base.best_dist.numpy(),
                               rtol=RTOL)


def test_guard_errors_are_not_retried():
    ref, queries = _data()
    calls = []

    def bad_runner(shard, lo, hi, ub):
        calls.append(shard)
        raise guards.SearchInputError("malformed")

    with pytest.raises(guards.SearchInputError):
        resilient_search(ref, queries, L, W, n_shards=4, runner=bad_runner,
                         max_retries=5, sleep=lambda _t: None, device="cpu")
    assert calls == [0]  # no retry on caller bugs
    for kw in (dict(n_shards=0), dict(max_retries=-1), dict(n_ranges=0),
               dict(hedge_max_inflight=0)):
        with pytest.raises(guards.SearchInputError):
            resilient_search(ref, queries, L, W, device="cpu", **kw)
    with pytest.raises(guards.NonFiniteInputError):
        bad = queries.copy()
        bad[0, 3] = np.nan
        resilient_search(ref, bad, L, W, device="cpu")


def test_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """With no device and no card the entry points raise rather than carry
    on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, queries = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resilient_search(ref, queries, L, W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HostRoundsExecutor(ref, queries)


def test_config_hands_over_the_resilience_knobs():
    """``SearchConfig.resilient_search`` runs with the config's knobs:
    the same result as the call spelled out."""
    ref, queries = _data()
    cfg = SearchConfig(ref_len=N, query_len=L, window_ratio=W / L, batch=B,
                       n_queries=Q, n_shards=3, shard_max_retries=1,
                       shard_backoff=0.02, retry_jitter=False)
    assert cfg.window == W
    sleeps_a, sleeps_b = [], []
    runner = _runners(ref, queries)[0]
    a = cfg.resilient_search(
        ref, queries, device="cpu", sleep=sleeps_a.append, clock=FakeClock(),
        runner=ShardFaultInjector(runner, flaky_ranges={0}))
    b = resilient_search(
        ref, queries, L, W, n_shards=3, batch=B, max_retries=1,
        backoff=0.02, jitter=False, device="cpu", sleep=sleeps_b.append,
        clock=FakeClock(), runner=ShardFaultInjector(runner,
                                                     flaky_ranges={0}))
    assert sleeps_a == sleeps_b == [0.02]
    _assert_parity(((a, None, sleeps_a), (b, None, sleeps_b)))
    assert np.array_equal(a.best_dist, b.best_dist)
