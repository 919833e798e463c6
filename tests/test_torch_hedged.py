"""The port's hedged dispatch, circuit breakers and executor seam against
``repro``'s on the CPU.

``tests/test_hedged.py``'s scenarios, each run on both packages over the
same float32 data (``test_torch_resilient``'s helpers: each package's own
``HostRoundsExecutor`` runner wrapped by a ``tests/faults.py``
``ShardFaultInjector`` on a ``FakeClock``), held to the parity contract
there: counts, coverage, health snapshots and sleeps exactly,
``best_dist`` within ``rtol=1e-4``. Within the port, a hedged run gives
the unhedged run's bits. Then the executor seam itself:
``HostRoundsExecutor`` / ``PersistentExecutor`` ``run_range`` against
``repro``'s (including the rule that a query whose seed nothing beats
keeps its incoming start), ``HedgedExecutor.run_range`` parity, and a
``StreamSearchEngine`` over a ``HedgedExecutor`` of ingest executors
giving the plain engine's bits.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.search import HedgedExecutor as RHedgedExecutor
from repro.search import IncumbentState as RIncumbentState
from repro.search import get_executor as r_get_executor
from repro.search import make_plan as r_make_plan
from repro.search import resilient_search as r_resilient_search
from repro.search.pipeline import MULTI_VARIANTS as R_MULTI_VARIANTS
from repro.serve import StreamSearchEngine as REngine
from repro_torch.configs.dtw_search import SearchConfig
from repro_torch.core import guards
from repro_torch.search import (
    HedgedExecutor,
    HostRoundsExecutor,
    IncumbentState,
    PersistentExecutor,
    ShardedExecutor,
    get_executor,
    resilient_search,
)
from repro_torch.search.pipeline import MULTI_VARIANTS, make_plan
from repro_torch.serve import StreamSearchEngine

from faults import FakeClock, SlowIngestExecutor
from test_torch_resilient import (
    RTOL,
    B,
    L,
    N_WIN,
    Q,
    W,
    _assert_offline,
    _assert_parity,
    _both,
    _data,
    _runners,
)

torch.set_num_threads(1)


# -- resilient_search: hedging --------------------------------------------

def _hedged_pair(dirty=False):
    """The straggler scenario (shard 1 takes 50 on the fake clock) without
    and with hedging, each on both packages."""
    ref, queries = _data(dirty=dirty)
    kw = dict(recipe={"slow_shards": {1: 50.0}, "base_dt": 1.0},
              n_shards=3, hedge_delay=5.0, timeout=10.0, max_retries=0,
              backoff=0.0)
    plain = _both(ref, queries, hedge=False, **kw)
    hedged = _both(ref, queries, hedge=True, **kw)
    return (ref, queries), plain, hedged


@pytest.mark.parametrize("dirty", [False, True])
def test_hedge_win_is_bit_identical_and_skips_timeout(dirty):
    (ref, queries), plain, hedged = _hedged_pair(dirty)
    _assert_parity(plain)
    _assert_parity(hedged)
    p, h, inj = plain[0][0], hedged[0][0], hedged[0][1]
    assert np.array_equal(h.best_start, p.best_start)
    assert np.array_equal(h.best_dist, p.best_dist)  # bitwise
    assert h.quarantined == p.quarantined
    assert h.hedges_launched == 1 and h.hedges_won == 1
    assert p.hedges_launched == 0 and p.failed_shards == (1,)
    assert h.failed_shards == ()
    # the straggler's range completed twice: primary and backup
    lo = [c[1] for c in inj.calls if c[0] == 1][0]
    assert len([c for c in inj.calls if c[1] == lo and c[3]]) == 2
    _assert_offline(h, ref, queries)


def test_hedge_determinism_same_seed():
    _, _, (a, _) = _hedged_pair()
    _, _, (b, _) = _hedged_pair()
    for field in ("best_start", "best_dist"):
        assert np.array_equal(getattr(a[0], field), getattr(b[0], field))
    assert a[0].attempts == b[0].attempts and a[0].latency == b[0].latency


# name: (recipe, resilient_search kwargs)
HEDGE_RECIPES = {
    # no explicit delay: threshold x EWMA fires once fast shards set a
    # baseline (shard 2 is the straggler, ranges 0 and 1 come first)
    "derived_delay": ({"slow_shards": {2: 50.0}, "base_dt": 1.0},
                      {"n_shards": 3, "hedge": True}),
    # the very first attempt has no baseline and never hedges
    "first_attempt": ({"slow_shards": {0: 50.0}, "base_dt": 1.0},
                      {"n_shards": 3, "hedge": True}),
    "ladder_depth_1": ({"slow_shards": {0: 50.0, 1: 50.0}, "base_dt": 1.0},
                       {"n_shards": 3, "hedge": True, "hedge_delay": 5.0,
                        "hedge_max_inflight": 1}),
    "ladder_depth_2": ({"slow_shards": {0: 50.0, 1: 50.0}, "base_dt": 1.0},
                       {"n_shards": 3, "hedge": True, "hedge_delay": 5.0,
                        "hedge_max_inflight": 2}),
    # breaker_threshold consecutive failures route later ranges off the
    # shard with no further attempt on it; a pause, not a verdict
    "breaker_routes_off": ({"dead_shards": {0}},
                           {"n_shards": 2, "n_ranges": 6, "max_retries": 5,
                            "breaker_threshold": 2,
                            "breaker_cooldown": 1000.0}),
    "backups_avoid_tripped": ({"dead_shards": {1}, "slow_shards": {2: 50.0}},
                              {"n_shards": 4, "hedge": True,
                               "hedge_delay": 5.0, "max_retries": 5,
                               "breaker_threshold": 2,
                               "breaker_cooldown": 1000.0}),
    "straggler_and_dead": ({"dead_shards": {3}, "slow_shards": {1: 50.0},
                            "base_dt": 1.0},
                           {"n_shards": 4, "hedge": True, "hedge_delay": 5.0,
                            "max_retries": 1}),
}


@pytest.mark.parametrize("name", sorted(HEDGE_RECIPES))
def test_hedge_and_breaker_recipe_parity(name):
    recipe, kw = HEDGE_RECIPES[name]
    ref, queries = _data()
    pair = _both(ref, queries, recipe=recipe, backoff=0.0, **kw)
    _assert_parity(pair)
    res, inj, _ = pair[0]
    if name == "derived_delay":
        assert res.hedges_launched >= 1 and res.hedges_won == 1
    elif name == "first_attempt":
        assert res.hedges_launched == 0
    elif name == "ladder_depth_1":
        assert res.hedges_launched == 2 and res.hedges_won == 0
    elif name == "ladder_depth_2":
        assert res.hedges_launched == 3 and res.hedges_won == 2
    elif name == "breaker_routes_off":
        assert len([c for c in inj.calls if c[0] == 0]) == 2
        assert res.failed_shards == () and res.reassignments == 3
        h0 = res.shard_health[0]
        assert (h0.state, h0.trips, h0.consecutive_failures) == ("open", 1, 2)
    elif name == "backups_avoid_tripped":
        assert res.hedges_won >= 1
        shard1 = [c for c in inj.calls if c[0] == 1]
        assert len(shard1) == 2 and not any(c[3] for c in shard1)
    elif name == "straggler_and_dead":
        assert res.failed_shards == (3,) and res.hedges_won >= 1
    _assert_offline(res, ref, queries)


def test_breaker_half_open_probe_recovers_shard():
    """Shard 0 fails twice, then heals: while its breaker cools its ranges
    go to shard 1; past the cooldown the next shard-0 range runs there as
    the half-open probe, succeeds, and the breaker closes."""
    ref, queries = _data()

    def flaky_runner(runner, clock, calls):
        fails = {"n": 2}

        def run(shard, lo, hi, ub):
            if shard == 0 and fails["n"] > 0:
                fails["n"] -= 1
                raise RuntimeError("shard 0 hiccup")
            out = runner(shard, lo, hi, ub)
            clock.advance(1.0)
            calls.append(shard)
            return out
        return run

    mine, theirs = _runners(ref, queries)
    got = []
    for runner, fn in ((mine, "port"), (theirs, "repro")):
        clock, calls = FakeClock(), []
        kw = dict(n_shards=2, n_ranges=6, max_retries=5,
                  breaker_threshold=2, breaker_cooldown=2.0, backoff=0.0,
                  sleep=lambda _t: None, clock=clock,
                  runner=flaky_runner(runner, clock, calls))
        if fn == "port":
            res = resilient_search(ref, queries, L, W, batch=B, device="cpu",
                                   **kw)
        else:
            res = r_resilient_search(ref, queries, L, W, batch=B, **kw)
        got.append((res, calls))
    (res, calls), (rres, rcalls) = got
    assert calls == rcalls and calls.count(0) == 1
    assert res.coverage == 1.0 and res.failed_shards == ()
    assert res.shard_health[0].state == "closed"
    assert res.shard_health[0].trips == 1
    assert ([tuple(h) for h in res.shard_health]
            == [tuple(h) for h in rres.shard_health])
    assert np.array_equal(res.best_start, rres.best_start)


# -- the executor seam ----------------------------------------------------

def _plans(rounds="host"):
    return (make_plan(length=L, window=W, batch=B, rounds=rounds,
                      allowed_variants=MULTI_VARIANTS),
            r_make_plan(length=L, window=W, batch=B, rounds=rounds,
                        backend="jax", allowed_variants=R_MULTI_VARIANTS))


def _seed_states(ub, best):
    return (IncumbentState(ub=torch.as_tensor(ub, dtype=torch.float32),
                           best=torch.as_tensor(best, dtype=torch.int64)),
            RIncumbentState(ub=jnp.asarray(ub, jnp.float32),
                            best=jnp.asarray(best, jnp.int64)))


@pytest.mark.parametrize("rounds", ["host", "persistent"])
@pytest.mark.parametrize("lo,hi", [(0, N_WIN), (500, 1300), (1900, N_WIN)])
def test_run_range_matches_repro(rounds, lo, hi):
    """``run_range`` over one range against ``repro``'s, from seeds that
    are beaten (inf), never beaten (1e-3: the query keeps its incoming
    start 77) and loose (1e6)."""
    ref, queries = _data()
    plan, rplan = _plans(rounds)
    mine = get_executor(plan, ref, queries, device="cpu")
    theirs = r_get_executor(rplan, jnp.asarray(ref), jnp.asarray(queries))
    assert type(mine).__name__ == type(theirs).__name__
    ub, best = [np.inf, 1e-3, 1e6], [-1, 77, 12]
    s, rs = _seed_states(ub, best)
    got = mine.run_range(plan, s, lo, hi)
    want = theirs.run_range(rplan, rs, lo, hi)
    assert np.array_equal(got.state.best.numpy(), np.asarray(want.state.best))
    assert got.state.best[1] == 77 and got.state.ub[1] == np.float32(1e-3)
    assert lo <= int(got.state.best[0]) < hi
    np.testing.assert_allclose(got.state.ub.numpy(), np.asarray(want.state.ub),
                               rtol=RTOL)
    assert int(got.quarantined) == int(want.quarantined)
    assert np.array_equal(got.stats.rounds.numpy(),
                          np.asarray(want.stats.rounds))


def test_get_executor_has_no_mesh_yet():
    """``get_executor`` binds the executor ``plan.rounds`` selects, and with
    a ``mesh`` the sharded one, whose first range raises while no process
    group exists (``tests/test_torch_sharded.py`` runs it on one)."""
    ref, queries = _data()
    plan, _ = _plans()
    assert isinstance(get_executor(plan, ref, queries, device="cpu"),
                      HostRoundsExecutor)
    assert isinstance(get_executor(_plans("persistent")[0], ref, queries,
                                   device="cpu"), PersistentExecutor)
    ex = get_executor(plan, ref, queries, mesh=object(), axis_names=("d",),
                      device="cpu")
    assert isinstance(ex, ShardedExecutor)
    state = IncumbentState(ub=torch.full((Q,), float("inf")),
                           best=torch.full((Q,), -1))
    with pytest.raises(guards.SearchInputError, match="init_process_group"):
        ex.run_range(plan, state, 0, 100)


class _SlowRangeExecutor:
    """``run_range`` proxy with a declared fake latency (a straggler)."""

    def __init__(self, executor, clock, dt, fail=False):
        self._executor = executor
        self.clock = clock
        self.dt = float(dt)
        self.fail = fail
        self.calls = 0

    def run_range(self, plan, state, lo, hi):
        self.calls += 1
        if self.fail:
            raise RuntimeError("executor down")
        out = self._executor.run_range(plan, state, lo, hi)
        self.clock.advance(self.dt)
        return out


@pytest.mark.parametrize("rounds", ["host", "persistent"])
def test_hedged_executor_run_range_parity(rounds):
    """Over a slow (50) and a fast (1) proxy of one executor: the plain
    executor's bits, the race won at 5 + 1 = 6, and ``repro``'s counts."""
    ref, queries = _data()
    plan, rplan = _plans(rounds)
    base = get_executor(plan, ref, queries, device="cpu")
    rbase = r_get_executor(rplan, jnp.asarray(ref), jnp.asarray(queries))
    s, rs = _seed_states([np.inf] * Q, [-1] * Q)
    out = []
    for ex, p, st, cls in ((base, plan, s, HedgedExecutor),
                           (rbase, rplan, rs, RHedgedExecutor)):
        clock = FakeClock()
        slow = _SlowRangeExecutor(ex, clock, 50.0)
        fast = _SlowRangeExecutor(ex, clock, 1.0)
        hedged = cls([slow, fast], hedge_delay=5.0, clock=clock)
        rr = hedged.run_range(p, st, 0, N_WIN)
        out.append((rr, hedged, slow.calls, fast.calls))
    (rr, hedged, n_slow, n_fast), (rrr, rhedged, *_r) = out
    plain = base.run_range(plan, s, 0, N_WIN)
    assert torch.equal(rr.state.ub, plain.state.ub)
    assert torch.equal(rr.state.best, plain.state.best)
    assert np.array_equal(rr.state.best.numpy(), np.asarray(rrr.state.best))
    np.testing.assert_allclose(rr.state.ub.numpy(), np.asarray(rrr.state.ub),
                               rtol=RTOL)
    assert int(rr.quarantined) == int(rrr.quarantined)
    assert (hedged.hedges_launched, hedged.hedges_won) == (1, 1)
    assert (rhedged.hedges_launched, rhedged.hedges_won) == (1, 1)
    assert hedged.last_effective_dt == rhedged.last_effective_dt == 6.0
    assert (n_slow, n_fast) == (1, 1) and _r == [1, 1]
    assert ([tuple(h) for h in hedged.health_snapshots()]
            == [tuple(h) for h in rhedged.health_snapshots()])


def test_hedged_executor_failures_and_routing():
    """A failing primary records its breaker and re-raises; once the
    breaker opens, routing puts the healthy executor first; a failing
    backup is absorbed. Step for step with ``repro``."""
    ref, queries = _data()
    plan, rplan = _plans()
    base = HostRoundsExecutor(ref, queries, device="cpu")
    rbase = r_get_executor(rplan, jnp.asarray(ref), jnp.asarray(queries))
    s, rs = _seed_states([np.inf] * Q, [-1] * Q)
    snaps = []
    for ex, p, st, cls in ((base, plan, s, HedgedExecutor),
                           (rbase, rplan, rs, RHedgedExecutor)):
        clock = FakeClock()
        down = _SlowRangeExecutor(ex, clock, 1.0, fail=True)
        up = _SlowRangeExecutor(ex, clock, 1.0)
        hedged = cls([down, up], hedge_delay=5.0, breaker_threshold=2,
                     breaker_cooldown=100.0, clock=clock)
        seen = []
        for _ in range(2):
            with pytest.raises(RuntimeError, match="executor down"):
                hedged.run_range(p, st, 0, 300)
            seen.append(hedged.health_snapshots())
        hedged.run_range(p, st, 0, 300)  # routed to the healthy one
        # a slow primary whose only backup fails: the primary stands
        slow = _SlowRangeExecutor(ex, clock, 50.0)
        bad = _SlowRangeExecutor(ex, clock, 1.0, fail=True)
        lone = cls([slow, bad], hedge_delay=5.0, clock=clock)
        lone.run_range(p, st, 0, 300)
        seen.append((down.calls, up.calls, hedged.health_snapshots(),
                     lone.hedges_launched, lone.hedges_won,
                     lone.health_snapshots(), lone.last_effective_dt))
        snaps.append(seen)
    assert snaps[0] == snaps[1]
    assert snaps[0][-1][:2] == (2, 1)
    assert snaps[0][-1][3:5] == (1, 0)


def test_hedged_executor_validates_knobs():
    with pytest.raises(guards.SearchInputError):
        HedgedExecutor([])
    with pytest.raises(guards.SearchInputError):
        HedgedExecutor([object()], hedge_max_inflight=0)


def test_config_hands_over_the_hedging_knobs():
    cfg = SearchConfig(hedge_delay=2.5, hedge_max_inflight=3,
                       breaker_threshold=4, breaker_cooldown=9.0)
    clock = FakeClock()
    hedged = cfg.make_hedged_executor([object(), object()], clock=clock)
    assert hedged.hedge_delay == 2.5 and hedged.hedge_max_inflight == 3
    br = hedged.health[1].breaker
    assert (br.threshold, br.cooldown, br._clock) == (4, 9.0, clock)


# -- streaming through the hedged seam ------------------------------------

SN, SCHUNK, ARRIVAL = 2000, 64, 80


def test_streaming_hedged_executor_bit_identical():
    """``StreamSearchEngine(executor=HedgedExecutor([...]))`` over two ingest
    executors, a straggler on ingests 2 and 9: the plain engine's bits,
    counters and quarantine, and ``repro``'s hedge counts and health."""
    ref, queries = _data(dirty=True, n=SN)
    captured = {}

    def factory(default, cls, key):
        clock = FakeClock()
        slow = SlowIngestExecutor(default, clock, base_dt=1.0, slow_dt=50.0,
                                  slow_at={2, 9})
        fast = SlowIngestExecutor(copy.copy(default), clock, base_dt=1.0)
        hedged = cls([slow, fast], hedge_delay=5.0, clock=clock)
        captured[key] = (hedged, fast)
        return hedged

    kw = dict(length=L, window=W, batch=B, stream_chunk=SCHUNK)
    plain = StreamSearchEngine(queries, device="cpu", **kw)
    mine = StreamSearchEngine(
        queries, device="cpu", **kw,
        executor=lambda d: factory(d, HedgedExecutor, "mine"))
    theirs = REngine(
        jnp.asarray(queries), backend="jax", **kw,
        executor=lambda d: factory(d, RHedgedExecutor, "theirs"))
    for pos in range(0, SN, ARRIVAL):
        piece = ref[pos:pos + ARRIVAL]
        plain.ingest(piece)
        mine.ingest(piece)
        theirs.ingest(jnp.asarray(piece))
    (hm, fast_m), (ht, fast_t) = captured["mine"], captured["theirs"]
    assert hm.hedges_won == ht.hedges_won == 2
    assert hm.hedges_launched == ht.hedges_launched == 2
    assert fast_m.calls == fast_t.calls == 2
    assert ([tuple(h) for h in hm.health_snapshots()]
            == [tuple(h) for h in ht.health_snapshots()])
    bp, dp = plain.best()
    bm, dm = mine.best()
    assert torch.equal(bm, bp) and torch.equal(dm, dp)  # bitwise
    assert (mine.rounds, mine.lanes) == (plain.rounds, plain.lanes)
    assert mine.quarantined_windows == plain.quarantined_windows > 0
    assert np.array_equal(bm.numpy(), np.asarray(theirs.best()[0]))
    np.testing.assert_allclose(dm.numpy(), np.asarray(theirs.best()[1]),
                               rtol=RTOL)
    assert (mine.rounds, mine.lanes) == (theirs.rounds, theirs.lanes)
