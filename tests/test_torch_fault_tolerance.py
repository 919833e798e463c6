"""The port's fault-tolerance primitives against ``repro``'s, step for step.

``repro_torch.distributed.fault_tolerance`` is pure Python and numpy, so
every primitive is driven through the same scripted sequence beside
``repro.distributed.fault_tolerance`` and their whole state compared after
each step, exactly: the circuit breaker's state machine on a
``tests/faults.py`` ``FakeClock``, the straggler monitor's EWMA and flags,
``WorkerHealth`` snapshots, the decorrelated-jitter backoff's draws (the
same ``np.random.default_rng`` stream, ``$REPRO_FAULT_SEED`` included)
and ``hedge_race``'s adjudication on the virtual timeline.
"""
import pytest
import torch

import repro.distributed.fault_tolerance as rft
from repro.core import guards as rguards
import repro_torch.distributed.fault_tolerance as ft
from repro_torch.core import guards

from faults import FakeClock


def _breaker_state(br):
    return (br.state, br.consecutive_failures, br.failures, br.trips,
            br.opened_at, br.ready())


# Each script: (threshold, cooldown, steps), a step one of "fail", "ok",
# "acquire", "ready" or a number (advance the clock by it).
BREAKER_SCRIPTS = [
    (2, 5.0, ["fail", "ready", "fail", "ready", 5.0, "ready", "acquire",
              "ready", "fail", 5.0, "acquire", "ok", "ready"]),
    (3, 0.0, ["fail", "fail", "ok", "fail", "fail", "ready", "fail",
              "acquire", "ok"]),
    (1, 2.0, ["fail", 1.0, "acquire", "ready", 1.0, "acquire", "acquire",
              "fail", 2.0, "acquire", "fail", 0.5, "ready", 1.5, "ok"]),
]


@pytest.mark.parametrize("threshold,cooldown,script", BREAKER_SCRIPTS)
def test_circuit_breaker_step_for_step(threshold, cooldown, script):
    clocks = FakeClock(), FakeClock()
    mine = ft.CircuitBreaker(threshold, cooldown, clock=clocks[0])
    theirs = rft.CircuitBreaker(threshold, cooldown, clock=clocks[1])
    assert _breaker_state(mine) == _breaker_state(theirs)
    for step in script:
        for br, clock in ((mine, clocks[0]), (theirs, clocks[1])):
            if isinstance(step, float):
                clock.advance(step)
            elif step == "fail":
                br.record_failure()
            elif step == "ok":
                br.record_success()
            elif step == "acquire":
                br.acquire()
        assert _breaker_state(mine) == _breaker_state(theirs), step


def test_circuit_breaker_validates_knobs():
    for kw in (dict(threshold=0), dict(cooldown=-1.0)):
        with pytest.raises(guards.SearchInputError):
            ft.CircuitBreaker(**kw)
        with pytest.raises(rguards.SearchInputError):
            rft.CircuitBreaker(**kw)


def test_straggler_monitor_step_for_step():
    dts = [1.0, 1.2, 0.9, 9.0, 1.1, 30.0, 2.0, 0.5, 4.0, 1.0]
    seen = {"mine": [], "theirs": []}
    mine = ft.StragglerMonitor(
        threshold=2.5, alpha=0.3,
        on_straggler=lambda *a: seen["mine"].append(a))
    theirs = rft.StragglerMonitor(
        threshold=2.5, alpha=0.3,
        on_straggler=lambda *a: seen["theirs"].append(a))
    for step, dt in enumerate(dts):
        assert mine.observe(step, dt) == theirs.observe(step, dt)
        assert mine.ewma == theirs.ewma
    assert mine.flagged == theirs.flagged and len(mine.flagged) >= 2
    assert seen["mine"] == seen["theirs"] == mine.flagged


def test_worker_health_step_for_step():
    clocks = FakeClock(), FakeClock()
    mine = ft.WorkerHealth(breaker_threshold=2, breaker_cooldown=3.0,
                           clock=clocks[0])
    theirs = rft.WorkerHealth(breaker_threshold=2, breaker_cooldown=3.0,
                              clock=clocks[1])
    script = [1.0, 1.5, "fail", 7.0, "fail", "fail", 2.0, "acquire", 0.5,
              "fail", 4.0, "acquire", 1.0]
    for step in script:
        for h, clock in ((mine, clocks[0]), (theirs, clocks[1])):
            if step == "fail":
                h.fail()
            elif step == "acquire":
                clock.advance(3.0)
                h.acquire()
            else:
                h.observe(step)
        assert tuple(mine.snapshot()) == tuple(theirs.snapshot()), step
        assert mine.ready() == theirs.ready()
    assert mine.snapshot().trips >= 1


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_jitter_backoff_same_draws(monkeypatch, seed):
    monkeypatch.setenv("REPRO_FAULT_SEED", "13")
    mine = ft.DecorrelatedJitterBackoff(0.01, seed=seed)
    theirs = rft.DecorrelatedJitterBackoff(0.01, seed=seed)
    a = [mine.next() for _ in range(8)]
    b = [theirs.next() for _ in range(8)]
    assert a == b
    assert all(0.01 <= s <= 0.16 for s in a)  # [base, cap = 16 base]
    mine.reset()
    theirs.reset()
    assert mine.next() == theirs.next()
    assert 0.01 <= mine.next() <= 0.16


def test_jitter_backoff_edges():
    assert ft.DecorrelatedJitterBackoff(0.0).next() == 0.0
    capped = ft.DecorrelatedJitterBackoff(1.0, cap=2.0, seed=3)
    theirs = rft.DecorrelatedJitterBackoff(1.0, cap=2.0, seed=3)
    draws = [capped.next() for _ in range(6)]
    assert draws == [theirs.next() for _ in range(6)]
    assert max(draws) <= 2.0
    with pytest.raises(guards.SearchInputError):
        ft.DecorrelatedJitterBackoff(-1.0)


def _race(module, primary_dt, delay, rungs, **kw):
    """``module.hedge_race`` over backups ``(tag, dt, ok)`` on a fresh fake
    clock; returns the outcome, the tags that ran and the failures."""
    clock = FakeClock()
    ran, failed = [], []

    def mk(tag, dt, ok):
        def thunk():
            ran.append(tag)
            if not ok:
                raise RuntimeError(f"backup {tag} down")
            clock.advance(dt)
            return tag
        return tag, thunk

    out = module.hedge_race(
        primary_dt, delay, iter([mk(*r) for r in rungs]), clock=clock,
        on_failure=lambda tag, _e: failed.append(tag), **kw)
    return out, ran, failed


HEDGE_CASES = [
    (50.0, 5.0, [("x", 1.0, True)], {}),                        # one win
    (50.0, 5.0, [("a", 50.0, True), ("b", 50.0, True),
                 ("c", 1.0, True)], {"max_inflight": 2}),      # ladder cap
    (50.0, 5.0, [("a", 1.0, True), ("b", 1.0, True)],
     {"max_inflight": 4}),                                      # stops early
    (50.0, 5.0, [("bad", 0.0, False), ("good", 1.0, True)], {}),  # failure
    (3.0, 5.0, [("late", 1.0, True)], {}),                     # never launched
    (20.0, 4.0, [("a", 30.0, True), ("b", 2.0, True),
                 ("c", 1.0, True)], {"max_inflight": 3}),
]


@pytest.mark.parametrize("primary_dt,delay,rungs,kw", HEDGE_CASES)
def test_hedge_race_matches_repro(primary_dt, delay, rungs, kw):
    mine = _race(ft, primary_dt, delay, rungs, **kw)
    theirs = _race(rft, primary_dt, delay, rungs, **kw)
    assert tuple(mine[0]) == tuple(theirs[0])
    assert mine[1:] == theirs[1:]


def test_hedge_race_guard_error_reraises():
    def bad():
        raise guards.SearchInputError("malformed")

    with pytest.raises(guards.SearchInputError):
        ft.hedge_race(50.0, 5.0, iter([("bad", bad)]), clock=FakeClock())


def test_transient_and_guard_split():
    assert ft.GUARD_ERRORS == (guards.SearchInputError,
                               guards.StreamStateError)
    assert ft.TRANSIENT == rft.TRANSIENT
    # A card running out of memory retries, as in repro.
    assert issubclass(torch.cuda.OutOfMemoryError, ft.TRANSIENT)
    assert issubclass(TimeoutError, ft.TRANSIENT)
    for err in ft.GUARD_ERRORS:
        assert issubclass(err, ft.TRANSIENT)  # why guards are caught first
