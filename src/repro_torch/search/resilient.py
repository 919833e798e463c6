"""Fault-tolerant search over work ranges: retry, reassignment, coverage
accounting, circuit breakers and hedging (port of
``repro/search/resilient.py``).

Candidate window starts are partitioned into work ranges, each range runs
as an independent dispatch (by default ``HostRoundsExecutor.run_range``:
the offline core over the range's slice of the reference, kernel B once
and kernel A a round on the card, seeded with the carried incumbents), and
the host supervises with the transient/guard-error split of
``distributed.fault_tolerance``. The failure story is ``repro``'s
(DESIGN.md §2.7, §2.9):

  * **Bounded retry with backoff** — a transient range failure sleeps a
    decorrelated-jitter backoff (``jitter=False``: ``backoff * 2**k``) and
    retries on the same shard up to ``max_retries`` times; guard errors
    re-raise at once.
  * **Reassignment** — a range that exhausts its retries marks its shard
    failed and moves to the next healthy shard with a fresh budget; later
    ranges of a failed shard skip straight to reassignment. Only a range
    no healthy shard completes stays uncovered.
  * **Coverage accounting** — ``coverage`` is the fraction of candidate
    windows searched and ``uncovered`` the window-start ranges that were
    not; over the covered set the result is exact.
    ``require_full_coverage=True`` raises ``CoverageError`` instead.
  * **Incumbent carry** — the per-query bound is carried across ranges,
    retries and reassignments. A failed attempt may attach achieved
    ``partial_ub`` / ``partial_best`` pairs to its exception, which are
    folded; a bare bound with no achieving start is not.
  * **Soft timeout** — an attempt that completes later than ``timeout``
    keeps its result but strikes its shard; more than ``max_retries``
    strikes mark the shard failed.
  * **Shard health** — a ``WorkerHealth`` per shard: routing prefers
    breaker-ready, non-straggling shards (shard id as the tiebreak), and
    an open breaker pauses a shard without marking it failed.
  * **Hedged dispatch** (``hedge=True``) — an attempt slower than the
    hedge delay is raced on up to ``hedge_max_inflight`` healthy backups
    seeded with the same pre-fold incumbents, so a duplicate completion
    folds to a no-op: a hedge changes the latency, never the answer.

An attempt's time is read after the device work behind its result is
done (the default runner returns host arrays, which waits for it; a
runner that returns tensors on a card is waited for before the clock is
read). The executor is sequential on the host, so the fault recipes of
``tests/faults.py`` replay exactly.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import guards
from repro_torch.core.common import block_until_ready, resolve_device
from repro_torch.distributed.fault_tolerance import (
    GUARD_ERRORS,
    TRANSIENT,
    DecorrelatedJitterBackoff,
    StragglerMonitor,
    WorkerHealth,
    hedge_race,
)
from repro_torch.search.incumbents import IncumbentState, fold_np
from repro_torch.search.pipeline import (
    MULTI_VARIANTS,
    HostRoundsExecutor,
    SearchPlan,
    make_plan,
)


class CoverageError(RuntimeError):
    """Raised by ``require_full_coverage=True`` when ranges stay uncovered."""

    def __init__(self, message: str, uncovered=()):
        super().__init__(message)
        self.uncovered = tuple(uncovered)


class ResilientSearchResult(NamedTuple):
    best_start: np.ndarray   # (Q,) start of each query's covered-set NN (-1: none)
    best_dist: np.ndarray    # (Q,) its DTW distance (== seed when unbeaten)
    coverage: float          # fraction of candidate windows searched
    uncovered: tuple         # ((lo, hi), ...) window-start ranges not searched
    quarantined: int         # non-finite-quarantined windows over the covered set
    attempts: int            # range attempts issued (including failures)
    reassignments: int       # ranges moved off a failed/degraded shard
    failed_shards: tuple     # shard ids marked failed
    hedges_launched: int = 0  # backup attempts raced against stragglers
    hedges_won: int = 0       # races a backup (virtually) finished first
    shard_health: tuple = ()  # per-shard HealthSnapshot, indexed by shard id
    latency: float = 0.0      # summed per-range effective latency (clock units)


def partition_ranges(n_win: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous per-shard window-start ranges covering ``[0, n_win)``."""
    per = -(-n_win // n_shards) if n_win else 0
    out = []
    lo = 0
    while lo < n_win:
        out.append((lo, min(lo + per, n_win)))
        lo += per
    return out


def _merge_ranges(ranges) -> tuple:
    out = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def executor_runner(executor, plan: SearchPlan) -> Callable:
    """A ``resilient_search`` runner over an executor's ``run_range``.

    ``runner(shard_id, lo, hi, ub) -> (starts, dists, quarantined)``: the
    carried bounds ``ub`` seed the range, ``starts`` come back in global
    window coordinates (-1 where the seed was unbeaten) as host int64,
    ``dists`` as host float64. The default runner is this over a
    ``HostRoundsExecutor``; a ``PersistentExecutor`` gives the persistent
    form, and fault injectors wrap the returned callable.
    """

    def runner(shard_id, lo, hi, ub_now):
        nq = int(executor.queries.shape[0])
        dev = executor.device
        state = IncumbentState(
            ub=torch.as_tensor(np.asarray(ub_now, np.float32), device=dev),
            best=torch.full((nq,), -1, dtype=torch.int64, device=dev),
        )
        rr = executor.run_range(plan, state, int(lo), int(hi))
        return (
            rr.state.best.cpu().numpy().astype(np.int64),
            rr.state.ub.cpu().numpy().astype(np.float64),
            int(rr.quarantined),
        )

    return runner


def resilient_search(
    ref,
    queries,
    length: int,
    window: int,
    *,
    n_shards: int = 4,
    variant: str = "eapruned",
    batch: int = 64,
    band_width: int | None = None,
    chunk: int = 4096,
    rows_per_step: int = 1,
    block_k: int = 8,
    row_block: int = 128,
    ub_init=None,
    quarantine: bool = True,
    max_retries: int = 2,
    backoff: float = 0.05,
    jitter: bool = True,
    timeout: float | None = None,
    hedge: bool = False,
    hedge_delay: float | None = None,
    hedge_max_inflight: int = 2,
    breaker_threshold: int = 3,
    breaker_cooldown: float = 1.0,
    n_ranges: int | None = None,
    require_full_coverage: bool = False,
    runner: Callable | None = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.time,
    monitor: StragglerMonitor | None = None,
    device=None,
) -> ResilientSearchResult:
    """Nearest-window search executed as recoverable per-shard work ranges.

    Arguments as ``repro``'s ``resilient_search``, with ``device`` in place
    of ``backend``: the default runner searches on the card unless
    ``device="cpu"``; with no device and no card it raises (also when a
    ``runner`` is given). Same answers as ``multi_query_search`` when
    every range completes, up to the float32 rounding of each range's own
    window stats; exact over the covered set otherwise, with the
    degradation reported in ``coverage`` / ``uncovered``.

    ``runner(shard_id, lo, hi, ub) -> (starts (Q,), dists (Q,),
    quarantined)`` with ``starts`` global (-1 where the seed was unbeaten)
    replaces the default (``executor_runner`` over a
    ``HostRoundsExecutor``); ``sleep``, ``clock`` and ``monitor`` are
    injection points for the fault recipes and a fake clock.
    """
    dev = resolve_device(device)
    if n_shards < 1:
        raise guards.SearchInputError("n_shards must be >= 1")
    if max_retries < 0:
        raise guards.SearchInputError("max_retries must be >= 0")
    if n_ranges is not None and n_ranges < 1:
        raise guards.SearchInputError("n_ranges must be >= 1")
    if hedge_max_inflight < 1:
        raise guards.SearchInputError("hedge_max_inflight must be >= 1")
    if not isinstance(queries, torch.Tensor):
        queries = np.asarray(queries)
    if queries.ndim == 1:
        queries = queries[None]
    guards.ensure_series(ref, "ref", ndim=1, min_len=length)
    guards.ensure_series(queries, "queries", ndim=2, min_len=length)
    guards.ensure_finite(queries, "queries")
    nq = int(queries.shape[0])
    n_win = int(ref.shape[0]) - length + 1
    monitor = monitor or StragglerMonitor()
    health = {
        s: WorkerHealth(
            threshold=monitor.threshold, alpha=monitor.alpha,
            breaker_threshold=breaker_threshold,
            breaker_cooldown=breaker_cooldown, clock=clock,
        )
        for s in range(n_shards)
    }
    backoffs = {s: DecorrelatedJitterBackoff(backoff) for s in range(n_shards)}

    if ub_init is None:
        ub = np.full((nq,), np.inf)
    else:
        ub = np.broadcast_to(np.asarray(ub_init, np.float64), (nq,)).copy()
    best = np.full((nq,), -1, np.int64)

    if runner is None:
        # The default range execution IS the pipeline's executor seam
        # (DESIGN.md §2.8): one HostRoundsExecutor bound to this workload.
        plan = make_plan(
            length=length, window=window, variant=variant, batch=batch,
            band_width=band_width, chunk=chunk, rows_per_step=rows_per_step,
            block_k=block_k, row_block=row_block, quarantine=quarantine,
            allowed_variants=MULTI_VARIANTS,
        )
        runner = executor_runner(HostRoundsExecutor(ref, queries, device=dev),
                                 plan)

    def attempt(shard, lo, hi, ub_now):
        # Wait for the device work behind the result before the caller
        # reads its clock again.
        return block_until_ready(runner(shard, lo, hi, ub_now))

    work = deque(
        (lo, hi, i % n_shards, 0) for i, (lo, hi) in
        enumerate(partition_ranges(n_win, n_ranges or n_shards))
    )
    healthy = set(range(n_shards))
    strikes = {s: 0 for s in range(n_shards)}
    covered: list[tuple[int, int]] = []
    uncovered: list[tuple[int, int]] = []
    attempts = 0
    reassignments = 0
    quarantined = 0
    hedges_launched = 0
    hedges_won = 0
    latency = 0.0

    def _fold(starts, dists):
        nonlocal ub, best
        ub, best = fold_np(ub, best, starts, dists)

    def _order(exclude=frozenset()):
        # Healthiest first: breaker-ready before open, non-straggling
        # before straggling (EWMA > threshold x the fleet EWMA), shard id
        # as the tiebreak.
        fleet = monitor.ewma

        def key(s):
            h = health[s]
            slow = (
                h.ewma is not None and fleet is not None
                and h.ewma > monitor.threshold * fleet
            )
            return (0 if h.ready() else 1, 1 if slow else 0, s)

        return sorted((s for s in healthy if s not in exclude), key=key)

    def _reassign(lo, hi, off_shard):
        nonlocal reassignments
        for cand in _order(exclude={off_shard}):
            work.append((lo, hi, cand, 0))
            reassignments += 1
            return
        uncovered.append((lo, hi))

    while work:
        lo, hi, shard, tries = work.popleft()
        if shard not in healthy:
            _reassign(lo, hi, shard)
            continue
        if tries == 0 and not health[shard].ready():
            # Fresh range on a shard whose breaker is open: route it to a
            # ready shard instead (a reassignment, but the shard is not
            # marked failed — the breaker may yet recover).
            alt = [s for s in _order(exclude={shard}) if health[s].ready()]
            if alt:
                work.append((lo, hi, alt[0], 0))
                reassignments += 1
                continue
        ub_pre = ub.copy()
        try:
            attempts += 1
            health[shard].acquire()
            t0 = clock()
            starts, dists, n_quar = attempt(shard, lo, hi, ub)
            dt = clock() - t0
        except GUARD_ERRORS:
            raise  # caller bug: retrying identical bad input cannot help
        except TRANSIENT as e:
            health[shard].fail()
            # Admissible partial progress: achieved (start, distance) pairs
            # only.
            p_ub = getattr(e, "partial_ub", None)
            p_best = getattr(e, "partial_best", None)
            if p_ub is not None and p_best is not None:
                _fold(np.broadcast_to(np.asarray(p_best, np.int64), (nq,)),
                      np.broadcast_to(np.asarray(p_ub, np.float64), (nq,)))
            tries += 1
            if tries > max_retries:
                healthy.discard(shard)
                _reassign(lo, hi, shard)
                continue
            alt = [s for s in _order(exclude={shard}) if health[s].ready()]
            if not health[shard].ready() and alt:
                # The breaker just opened mid-retry: move the range rather
                # than hammer a shard the breaker took out of rotation.
                work.append((lo, hi, alt[0], 0))
                reassignments += 1
            else:
                if jitter:
                    sleep(backoffs[shard].next())
                else:
                    sleep(backoff * (2 ** (tries - 1)))
                work.appendleft((lo, hi, shard, tries))
            continue
        # The hedge delay is derived before this attempt is observed: a
        # straggler is judged against the baseline it has not yet moved.
        delay = None
        if hedge:
            if hedge_delay is not None:
                delay = hedge_delay
            elif monitor.ewma is not None:
                delay = monitor.threshold * monitor.ewma
        health[shard].observe(dt)
        backoffs[shard].reset()
        _fold(starts, dists)
        effective = dt
        if delay is not None and dt > delay:
            used = {shard}

            def backups():
                while True:
                    cands = [
                        s for s in _order(exclude=used) if health[s].ready()
                    ]
                    if not cands:
                        return
                    s = cands[0]
                    used.add(s)

                    def thunk(s=s):
                        nonlocal attempts
                        attempts += 1
                        health[s].acquire()
                        return attempt(s, lo, hi, ub_pre)

                    yield s, thunk

            race = hedge_race(
                dt, delay, backups(), clock=clock,
                max_inflight=hedge_max_inflight,
                on_failure=lambda tag, _e: health[tag].fail(),
            )
            hedges_launched += race.launched
            if race.won:
                hedges_won += 1
            effective = race.effective_dt
            for tag, res_b, dt_b in race.completions:
                health[tag].observe(dt_b)
                b_starts, b_dists, _b_quar = res_b
                # Idempotent under strict improvement; the backup's
                # quarantine count is dropped (the primary already counted
                # these very windows).
                _fold(b_starts, b_dists)
        monitor.observe(attempts - 1, effective)
        latency += effective
        quarantined += int(n_quar)
        covered.append((lo, hi))
        if timeout is not None and effective > timeout:
            # The result stands (a completed, exact range) but the shard is
            # now suspect for future assignments.
            strikes[shard] += 1
            if strikes[shard] > max_retries:
                healthy.discard(shard)

    covered_n = sum(hi - lo for lo, hi in covered)
    coverage = covered_n / n_win if n_win else 1.0
    uncovered_m = _merge_ranges(uncovered)
    if require_full_coverage and uncovered_m:
        raise CoverageError(
            f"search degraded: {n_win - covered_n}/{n_win} candidate "
            f"windows uncovered after shard failures ({uncovered_m})",
            uncovered=uncovered_m,
        )
    return ResilientSearchResult(
        best_start=best,
        best_dist=ub,
        coverage=coverage,
        uncovered=uncovered_m,
        quarantined=quarantined,
        attempts=attempts,
        reassignments=reassignments,
        failed_shards=tuple(sorted(set(range(n_shards)) - healthy)),
        hedges_launched=hedges_launched,
        hedges_won=hedges_won,
        shard_health=tuple(health[s].snapshot() for s in range(n_shards)),
        latency=latency,
    )
