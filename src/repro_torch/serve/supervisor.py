"""SearchSupervisor: crash-recoverable serving around a StreamSearchEngine
(port of ``repro/serve/supervisor.py``).

Feed arrivals through ``supervisor.ingest(chunk)`` instead of
``engine.ingest(chunk)``. In return:

  * **Periodic checkpoints** — every ``ckpt_every`` arrivals the engine's
    carried state (``save_state()``) is committed atomically under
    ``ckpt_dir`` through ``train.checkpoint`` (``repro``'s layout, so
    either package resumes the other's directory).
  * **Bounded retry with backoff** — a transient failure (``RuntimeError``
    / ``ValueError`` / ``OSError``) rolls the engine back to the last
    snapshot, replays the arrivals since (at most ``ckpt_every``, kept in
    memory), sleeps a backoff and retries; guard errors (``SearchInputError``,
    ``StreamStateError``) re-raise at once. After ``max_retries``
    consecutive failures a ``RuntimeError`` is raised with the original
    error chained.
  * **Restore-and-replay after a crash** — a fresh process builds the same
    engine and supervisor and calls ``resume()``: the newest *readable*
    checkpoint is restored (a damaged one is skipped for the next older)
    and the number of arrivals already absorbed is returned, so the caller
    re-feeds its source from that index. Results are the uninterrupted
    run's bits: a rollback replays the same ingests on the same inputs.
  * **Async checkpoints** (``async_ckpt=True``) — serialization moves to
    ``train.checkpoint.AsyncCheckpointer``; ``resume()`` and the retry
    ``_rollback()`` take its ``wait()`` barrier first.

An arrival may be a numpy array or a tensor on the engine's device; the
replay buffer keeps the caller's object, which must not be changed in
place while it is buffered. An arrival's time (the straggler monitor and
the breaker's EWMA) is read after the engine's device work is done: one
sync an arrival, on top of the one a round the engine makes anyway.

On a card, an error such as an illegal memory access is sticky: every
later CUDA call of the process fails too, so in-process retries cannot
succeed, and the supervisor gives up after ``max_retries`` with the
original error chained (recover by restarting the process and calling
``resume()``). ``torch.cuda.OutOfMemoryError`` is a ``RuntimeError`` and
takes the transient path.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import guards
from repro_torch.core.common import block_until_ready
from repro_torch.distributed.fault_tolerance import (
    GUARD_ERRORS,
    TRANSIENT,
    DecorrelatedJitterBackoff,
    StragglerMonitor,
    WorkerHealth,
)
from repro_torch.train import checkpoint as ckpt_lib


class SearchSupervisor:
    """Checkpoint/retry/replay wrapper around a ``StreamSearchEngine``.

    Args as ``repro``'s:
      engine: the (freshly constructed) engine to supervise.
      ckpt_dir: checkpoint directory (``train.checkpoint`` layout).
      ckpt_every: arrivals between checkpoints; also bounds the replay
        buffer.
      max_retries: consecutive transient failures tolerated per arrival.
      backoff: base retry sleep in seconds (doubles per consecutive retry).
      jitter: decorrelate retry sleeps (``DecorrelatedJitterBackoff``,
        seeded via ``$REPRO_FAULT_SEED``); off by default.
      keep: checkpoints retained on disk (older ones pruned).
      sleep: injection point for the backoff sleep.
      clock: injection point for latency measurement.
      breaker_threshold, breaker_cooldown: the engine's circuit breaker.
        With a single engine there is nowhere to route away to, so a
        tripped breaker sheds load in time: the retry path waits out
        ``breaker_cooldown`` before the half-open probe.
      async_ckpt: move checkpoint writes off the ingest thread; call
        ``close()`` at shutdown to flush.
    """

    def __init__(
        self,
        engine,
        ckpt_dir: str,
        ckpt_every: int = 16,
        max_retries: int = 3,
        backoff: float = 0.05,
        jitter: bool = False,
        keep: int = 3,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.time,
        breaker_threshold: int = 3,
        breaker_cooldown: float = 1.0,
        async_ckpt: bool = False,
    ):
        if ckpt_every < 1:
            raise ValueError("ckpt_every must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.engine = engine
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.jitter = bool(jitter)
        self.keep = int(keep)
        self._sleep = sleep
        self._clock = clock
        self.monitor = StragglerMonitor()
        self.health = WorkerHealth(
            breaker_threshold=breaker_threshold,
            breaker_cooldown=breaker_cooldown, clock=clock,
        )
        self._backoffs = DecorrelatedJitterBackoff(self.backoff)
        self.restarts = 0
        self.chunks_done = 0          # arrivals fully absorbed
        self._pending: list = []      # arrivals since the last snapshot
        self._snapshot = engine.save_state()
        self._async = (
            ckpt_lib.AsyncCheckpointer(ckpt_dir, keep=keep)
            if async_ckpt
            else None
        )

    # -- persistence ------------------------------------------------------
    def _barrier(self) -> None:
        """Wait out in-flight async checkpoint writes (no-op when sync)."""
        if self._async is not None:
            self._async.wait()

    def resume(self) -> int:
        """Restore the newest readable checkpoint, if any; returns the
        number of arrivals already absorbed (the index to re-feed the
        source from).

        Walks committed checkpoints newest-first: one damaged after commit
        (a truncated leaf file, an unreadable manifest) is skipped and the
        next older one restores instead; with none readable the stream
        starts over (returns 0).
        """
        self._barrier()
        for step in reversed(ckpt_lib.steps(self.ckpt_dir)):
            try:
                state, step = ckpt_lib.restore(
                    self.ckpt_dir, self.engine.save_state(), step=step
                )
                self.engine.restore_state(state)
            except (guards.StreamStateError, OSError, ValueError, KeyError,
                    EOFError):
                continue  # damaged checkpoint: fall back to the next older
            self.chunks_done = int(step)
            self._pending = []
            self._snapshot = self.engine.save_state()
            return self.chunks_done
        return 0

    def checkpoint(self) -> None:
        """Commit the engine state now (also called every ``ckpt_every``)."""
        state = self.engine.save_state()
        if self._async is not None:
            self._async.submit(state, self.chunks_done)
        else:
            ckpt_lib.save(self.ckpt_dir, state, self.chunks_done)
            ckpt_lib.prune_old(self.ckpt_dir, self.keep)
        self._snapshot = state
        self._pending = []

    def close(self) -> None:
        """Flush and stop the async writer (no-op for sync checkpoints)."""
        if self._async is not None:
            self._async.close()
            self._async = None

    def _rollback(self) -> None:
        """Back to the last snapshot, replay the arrivals since.

        Barriers on in-flight checkpoint writes first: the snapshot being
        restored may be the very tree an async writer is still committing,
        and the replay re-reaches the same ``chunks_done`` boundary.
        """
        self._barrier()
        self.engine.restore_state(self._snapshot)
        for c in self._pending:
            self.engine.ingest(c)

    # -- serving ----------------------------------------------------------
    def ingest(self, chunk, fail_injector: Callable[[int], None] | None = None):
        """Feed one arrival with retry/checkpoint semantics.

        Returns ``engine.best()``. ``fail_injector(arrival_index)`` may raise
        to simulate a failure; it runs before the dispatch. The rollback
        before a retry runs inside the retried block, so a failure while
        replaying (as a sticky CUDA error gives) counts as one more retry,
        where ``repro`` lets it escape from the handler.
        """
        if not isinstance(chunk, torch.Tensor):
            chunk = np.asarray(chunk)
        retries = 0
        rolled_back = True  # nothing to undo before the first attempt
        while True:
            try:
                if not rolled_back:
                    self._rollback()
                    rolled_back = True
                if fail_injector is not None:
                    fail_injector(self.chunks_done)
                self.health.acquire()
                t0 = self._clock()
                out = block_until_ready(self.engine.ingest(chunk))
                dt = self._clock() - t0
                self.monitor.observe(self.chunks_done, dt)
                self.health.observe(dt)
                self._backoffs.reset()
                break
            except GUARD_ERRORS:
                raise  # caller bug: retrying identical bad input cannot help
            except TRANSIENT as e:
                self.health.fail()
                self.restarts += 1
                retries += 1
                if retries > self.max_retries:
                    raise RuntimeError(
                        f"exceeded {self.max_retries} retries at arrival "
                        f"{self.chunks_done}"
                    ) from e
                if self.jitter:
                    self._sleep(self._backoffs.next())
                else:
                    self._sleep(self.backoff * (2 ** (retries - 1)))
                if not self.health.ready():
                    # Tripped breaker, single engine: shed load in time —
                    # wait out the cooldown before the half-open probe.
                    self._sleep(self.health.breaker.cooldown)
                rolled_back = False
        self._pending.append(chunk)
        self.chunks_done += 1
        if self.chunks_done % self.ckpt_every == 0:
            self.checkpoint()
        return out
