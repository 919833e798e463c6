"""Fault tolerance for search: stragglers, circuit breakers, backoff, hedging
(port of the search-side half of ``repro/distributed/fault_tolerance.py``).

  * ``TRANSIENT`` / ``GUARD_ERRORS`` — the transient/guard split every
    supervisor shares: ``RuntimeError``, ``ValueError`` and ``OSError``
    retry (a device falling over, a flaky allocator, an RPC deadline —
    ``TimeoutError`` is an ``OSError``; ``torch.cuda.OutOfMemoryError`` is
    a ``RuntimeError``); the typed guard errors are caller bugs and
    re-raise at once. Guard errors subclass ``ValueError`` /
    ``RuntimeError``, so catch them first.
  * ``StragglerMonitor`` — an attempt-time EWMA with a threshold.
  * ``CircuitBreaker`` / ``WorkerHealth`` — the per-worker health the
    hedged scheduling layer routes on (EWMA latency plus a closed → open →
    half-open → closed breaker).
  * ``DecorrelatedJitterBackoff`` — retry sleeps drawn from
    ``uniform(base, 3 * prev)`` capped at ``cap``, from
    ``np.random.default_rng(seed)`` with ``$REPRO_FAULT_SEED`` as the
    default seed, so both packages draw the same sleeps.
  * ``hedge_race`` — the deterministic host emulation of racing backup
    attempts against a straggling primary.
  * ``TrainingSupervisor`` — checkpoint/restart around the LM train step,
    on one device or on placed state (every rank runs it in step).
  * ``elastic_reshard`` — the train state moved onto another mesh.

Pure Python and numpy but for the supervisor's restore: the callers
(``search.resilient``, ``search.pipeline.HedgedExecutor``,
``serve.supervisor``) make an attempt's time include its device work
before they read the clock, and ``TrainingSupervisor`` reads a step's
loss on the host before it does.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np

from repro_torch.core import guards
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.layout import mesh_of

TRANSIENT = (RuntimeError, ValueError, OSError)
GUARD_ERRORS = (guards.SearchInputError, guards.StreamStateError)


@dataclass
class StragglerMonitor:
    threshold: float = 3.0          # x EWMA before flagging
    alpha: float = 0.2
    ewma: float | None = None
    flagged: list = field(default_factory=list)
    on_straggler: Callable[[int, float, float], None] | None = None

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.threshold * self.ewma
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        # stragglers don't poison the baseline estimate
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * min(
            dt, self.ewma * self.threshold
        )
        return is_straggler


class CircuitBreaker:
    """Consecutive-failure circuit breaker.

    State machine: **closed** (normal) → **open** after ``threshold``
    consecutive failures (the worker sheds load for ``cooldown`` seconds)
    → **half_open** once the cooldown elapses and a scheduler *acquires*
    the one probe slot → **closed** on probe success, back to **open**
    (cooldown restarted) on probe failure.

    ``ready()`` is a pure read; ``acquire()`` is called only on the worker
    actually picked, and turns an elapsed cooldown into the one half-open
    probe.
    """

    def __init__(
        self,
        threshold: int = 3,
        cooldown: float = 1.0,
        clock: Callable[[], float] = time.time,
    ):
        if threshold < 1:
            raise guards.SearchInputError("breaker threshold must be >= 1")
        if cooldown < 0:
            raise guards.SearchInputError("breaker cooldown must be >= 0")
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self._clock = clock
        self.state = "closed"
        self.consecutive_failures = 0
        self.failures = 0
        self.trips = 0
        self.opened_at: float | None = None

    def ready(self) -> bool:
        """May an attempt be routed here? (Pure; consumes nothing.)"""
        if self.state == "closed":
            return True
        if self.state == "open":
            return (
                self.opened_at is not None
                and self._clock() - self.opened_at >= self.cooldown
            )
        return False  # half_open: the one probe is already outstanding

    def acquire(self) -> None:
        """An attempt is about to run here; claim the half-open probe slot
        when the cooldown has elapsed."""
        if self.state == "open" and self.ready():
            self.state = "half_open"

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self.state = "closed"
        self.opened_at = None

    def record_failure(self) -> None:
        self.failures += 1
        self.consecutive_failures += 1
        if (
            self.state == "half_open"
            or self.consecutive_failures >= self.threshold
        ):
            if self.state != "open":
                self.trips += 1
            self.state = "open"
            self.opened_at = self._clock()


class HealthSnapshot(NamedTuple):
    """Read-only view of one worker's health, surfaced on results."""
    state: str               # breaker state: closed | open | half_open
    ewma: float | None       # EWMA attempt latency (None: never observed)
    attempts: int            # completed attempts observed
    failures: int            # total failures recorded
    consecutive_failures: int
    trips: int               # times the breaker opened


class WorkerHealth:
    """Per-worker health: EWMA latency + circuit breaker.

    One per shard in ``search.resilient.resilient_search``, one per wrapped
    executor in ``search.pipeline.HedgedExecutor``, one for the engine in
    ``serve.supervisor.SearchSupervisor``.
    """

    def __init__(
        self,
        *,
        threshold: float = 3.0,
        alpha: float = 0.2,
        breaker_threshold: int = 3,
        breaker_cooldown: float = 1.0,
        clock: Callable[[], float] = time.time,
    ):
        self.monitor = StragglerMonitor(threshold=threshold, alpha=alpha)
        self.breaker = CircuitBreaker(
            breaker_threshold, breaker_cooldown, clock
        )
        self.attempts = 0

    @property
    def ewma(self) -> float | None:
        return self.monitor.ewma

    def observe(self, dt: float) -> bool:
        """A completed attempt took ``dt`` seconds (closes the breaker)."""
        self.attempts += 1
        flagged = self.monitor.observe(self.attempts - 1, dt)
        self.breaker.record_success()
        return flagged

    def fail(self) -> None:
        self.breaker.record_failure()

    def ready(self) -> bool:
        return self.breaker.ready()

    def acquire(self) -> None:
        self.breaker.acquire()

    def snapshot(self) -> HealthSnapshot:
        return HealthSnapshot(
            state=self.breaker.state,
            ewma=self.monitor.ewma,
            attempts=self.attempts,
            failures=self.breaker.failures,
            consecutive_failures=self.breaker.consecutive_failures,
            trips=self.breaker.trips,
        )


class DecorrelatedJitterBackoff:
    """Retry sleeps with decorrelated jitter: ``uniform(base, 3 * prev)``.

    Keeps the exponential envelope in expectation while simultaneously
    failed workers do not retry in lockstep (Brooker, "Exponential Backoff
    and Jitter"). Deterministic given its seed; ``seed=None`` reads
    ``$REPRO_FAULT_SEED`` (default 0). ``reset()`` starts a fresh retry
    sequence.
    """

    def __init__(
        self,
        base: float,
        cap: float | None = None,
        seed: int | None = None,
    ):
        if base < 0:
            raise guards.SearchInputError("backoff base must be >= 0")
        self.base = float(base)
        self.cap = float(cap) if cap is not None else self.base * 16.0
        if seed is None:
            seed = int(os.environ.get("REPRO_FAULT_SEED", 0))
        self._rng = np.random.default_rng(seed)
        self._prev = self.base

    def reset(self) -> None:
        self._prev = self.base

    def next(self) -> float:
        if self.base == 0.0:
            return 0.0
        lo, hi = self.base, max(self._prev * 3.0, self.base)
        self._prev = min(self.cap, float(self._rng.uniform(lo, hi)))
        return self._prev


class HedgeOutcome(NamedTuple):
    """One hedged attempt's adjudication (all times in ``clock`` units)."""
    launched: int        # backup attempts actually launched
    won: bool            # a backup (virtually) finished before the primary
    effective_dt: float  # min over completions of their virtual finish time
    completions: tuple   # ((tag, result, backup_dt), ...) completed backups


def hedge_race(
    primary_dt: float,
    delay: float,
    backups,
    *,
    clock: Callable[[], float] = time.time,
    max_inflight: int = 2,
    on_failure: Callable[[Any, BaseException], None] | None = None,
) -> HedgeOutcome:
    """Race backup attempts against a primary that took ``primary_dt``.

    The host runs attempts one after another, so the primary has already
    completed when this runs; the race is replayed on the virtual timeline
    a concurrent deployment would see: backup ``k`` (1-based) launches at
    ``k * delay``, but only if nothing has virtually finished by then, runs
    for its measured ``dt_k`` and finishes at ``k * delay + dt_k``.
    ``effective_dt`` is the min finish time over the primary and every
    completed backup; ``max_inflight`` caps the backups raced.

    ``backups`` yields ``(tag, thunk)`` lazily, so the caller picks each
    next-healthiest worker at launch time. A thunk's time is read around
    the call, so a thunk that queues device work must wait for it before
    it returns. A backup raising a transient error is reported to
    ``on_failure`` and contributes nothing; guard errors re-raise.
    """
    launched = 0
    best_eff = primary_dt
    completions = []
    for k, (tag, thunk) in enumerate(backups, start=1):
        if launched >= max_inflight:
            break
        launch_t = k * delay
        if best_eff <= launch_t:
            break  # someone already (virtually) finished; no more hedges
        launched += 1
        t0 = clock()
        try:
            result = thunk()
        except GUARD_ERRORS:
            raise
        except TRANSIENT as e:
            if on_failure is not None:
                on_failure(tag, e)
            continue
        dt_k = clock() - t0
        completions.append((tag, result, dt_k))
        best_eff = min(best_eff, launch_t + dt_k)
    return HedgeOutcome(
        launched=launched,
        won=best_eff < primary_dt,
        effective_dt=best_eff,
        completions=tuple(completions),
    )


class TrainingSupervisor:
    """Checkpoint/restart wrapper around a train step (``train_step``'s
    in-place step, or any ``(state, batch) -> (state, metrics)``).

    A step ends when its loss is read on the host (``repro`` waits with
    ``jax.block_until_ready``), so the straggler monitor times the device
    work. A restore copies the checkpoint into the state's own tensors: each
    leaf keeps its device, dtype (bfloat16 bit for bit) and place in the
    structure, and a placed leaf its placement.

    On placed state every rank of the mesh runs the supervisor in step,
    with the same data and failures: a checkpoint is gathered by all and
    written by the mesh's first rank (``train.checkpoint``), and before a
    restore (and at the end of ``run``) the ranks wait for that writer's
    files, so every rank resumes from the same step.
    """

    def __init__(
        self,
        train_step: Callable,
        data_at: Callable[[int], Any],
        ckpt_dir: str,
        ckpt_every: int = 50,
        max_retries: int = 3,
        async_ckpt: bool = True,
        keep: int = 3,
    ):
        self.train_step = train_step
        self.data_at = data_at
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.monitor = StragglerMonitor()
        self.restarts = 0
        self._async = (
            ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=keep) if async_ckpt else None
        )
        self.keep = keep

    def _save(self, state, step: int):
        if self._async is not None:
            self._async.submit(state, step)
        else:
            ckpt_lib.save(self.ckpt_dir, state, step)
            ckpt_lib.prune_old(self.ckpt_dir, self.keep)

    def resume_or(self, state):
        """Restore the latest checkpoint into ``state`` if one exists;
        returns ``(state, step)``."""
        if self._async is not None:
            # Write barrier: without it, latest_step can miss a submitted-
            # but-uncommitted step and replay would rewind past real
            # progress (same rule as SearchSupervisor._barrier).
            self._async.wait()
        _mesh_barrier(state)
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            return state, 0
        restored, step = ckpt_lib.restore(self.ckpt_dir, state)
        return ckpt_lib.load_into(state, restored), step

    def run(self, state, n_steps: int, fail_injector: Callable[[int], None] | None = None):
        """Run to ``n_steps`` total steps with checkpoint/restart semantics.

        ``fail_injector(step)`` may raise to simulate node failure; the
        supervisor restores the last checkpoint and replays deterministically.
        """
        state, step = self.resume_or(state)
        metrics_log = []
        retries = 0
        while step < n_steps:
            try:
                if fail_injector is not None:
                    fail_injector(step)
                t0 = time.time()
                batch = self.data_at(step)
                state, metrics = self.train_step(state, batch)
                float(metrics["loss"])  # the step's device work is done
                self.monitor.observe(step, time.time() - t0)
                step += 1
                retries = 0
                metrics_log.append({k: float(v) for k, v in metrics.items()})
                if step % self.ckpt_every == 0:
                    self._save(state, step)
            except TRANSIENT as e:
                self.restarts += 1
                retries += 1
                if retries > self.max_retries:
                    raise RuntimeError(
                        f"exceeded {self.max_retries} retries at step {step}"
                    ) from e
                state, step = self.resume_or(state)
        self._save(state, step)
        if self._async is not None:
            self._async.close()
            self._async = ckpt_lib.AsyncCheckpointer(self.ckpt_dir, keep=self.keep)
        _mesh_barrier(state)
        return state, metrics_log


def _mesh_barrier(state) -> None:
    """On placed state, wait until every rank of its mesh gets here (one
    tiny all-reduce over each mesh dimension in turn); else nothing."""
    mesh = mesh_of(state)
    if mesh is None:
        return
    import torch
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.launch.mesh import mesh_device

    one = torch.ones((), device=mesh_device(mesh))
    DTensor.from_local(one, mesh, (Partial(),) * mesh.ndim,
                       run_check=False).full_tensor()


def elastic_reshard(state, old_mesh, new_mesh, make_specs: Callable):
    """Re-place train state onto a new mesh (shrunk/grown "data" axis).

    ``make_specs(mesh)`` returns the spec tree for the state
    (``sharding.make_state_specs``). DTensor cannot redistribute across
    meshes, so each placed leaf is gathered whole over ``old_mesh`` (a
    collective: every rank of ``old_mesh`` calls this, the new mesh built
    on all of them first) and distributed anew by its new spec; values are
    bit-identical. Afterwards each rank of ``new_mesh`` holds its shard of
    every leaf, and a rank outside it holds DTensors with no local data
    (it has left the job). A plain leaf is placed as it is.
    """
    from repro_torch.distributed.sharding import place

    if old_mesh is not None and mesh_of(state) not in (None, old_mesh):
        raise ValueError("state is not placed on old_mesh")
    return place(state, new_mesh, make_specs(new_mesh))
