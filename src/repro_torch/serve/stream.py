"""StreamSearchEngine: standing-query similarity search over a live stream
(port of ``repro/serve/stream.py``).

The serving front end of ``search/streaming.py``. Construct it with Q
standing queries, then feed reference chunks as they arrive::

    eng = StreamSearchEngine(queries, length=256, window=25)
    for chunk in source:
        best_start, best_dist = eng.ingest(chunk)

Each ``ingest`` (1) computes the window stats of exactly the newly valid
windows from the carried ``length - 1`` tail plus the chunk, (2) runs the
LB cascade over those windows only (kernel B on the card), and (3) runs
best-first EAPrunedDTW host rounds (kernel A a round, or kernel D with
``gather="slab"``) seeded with each query's incumbent carried from all
earlier chunks: the paper's tightening trick on the time axis.

Queries, envelopes and incumbents live on the engine's device (CUDA unless
``device="cpu"``; with no device and no CUDA the constructor raises). The
monitoring ring and the re-admission queue are host numpy, as in ``repro``;
the host copies of device data are taken only where ``repro`` reads the
host: the chunk when a ring is configured, the tail in ``correct``, and the
snapshot in ``save_state``. The work and quarantine counters add up lazily
on the device in int64 (``repro``: int32), so an ingest makes no host sync
beyond its rounds' own.

Exactness: for any chunking of a reference series, the final per-query
``(best_dist, best_start)`` equals offline ``multi_query_search`` over the
concatenated stream, up to the rounding of float32 window stats (each
ingest sums over its own context, the offline search over the whole
series; two windows within that rounding can change places) and exact
distance ties (both drivers keep the first strict improvement they meet,
in different orders). Incumbents are monotone non-increasing.

Hardening (DESIGN.md §2.6): non-finite stream samples are quarantined, not
fatal, and counted (``quarantined_windows`` / ``quarantined_samples``);
``correct`` re-admits them (§2.7). ``save_state()`` / ``restore_state()``
expose the carried state as a flat dict of numpy arrays with ``repro``'s
keys; ``restore_state`` also takes a snapshot that ``repro``'s engine saved
(int32 ``best`` and counters), which is how stream state crosses over from
``repro`` (``repro_torch.interop``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import guards
from repro_torch.core.common import resolve_device
from repro_torch.core.lower_bounds import envelope
from repro_torch.search.incumbents import QuarantineLedger
from repro_torch.search.multi import as_float32
from repro_torch.search.pipeline import MULTI_VARIANTS
from repro_torch.search.streaming import (
    StreamIngestExecutor,
    initial_incumbents,
    rescore_windows,
)
from repro_torch.search.znorm import znorm


class _Ring:
    """Fixed-capacity ring over the last W stream samples, oldest-first."""

    def __init__(self, capacity: int, dtype):
        self.capacity = int(capacity)
        self.buf = np.zeros((self.capacity,), dtype)
        self.count = 0
        self.pos = 0  # next write slot

    def extend(self, x: np.ndarray) -> None:
        x = np.asarray(x).reshape(-1)
        if x.shape[0] >= self.capacity:
            self.buf[:] = x[-self.capacity:]
            self.pos = 0
            self.count = self.capacity
            return
        first = min(x.shape[0], self.capacity - self.pos)
        self.buf[self.pos : self.pos + first] = x[:first]
        rest = x.shape[0] - first
        if rest:
            self.buf[:rest] = x[first:]
        self.pos = (self.pos + x.shape[0]) % self.capacity
        self.count = min(self.count + x.shape[0], self.capacity)

    def view(self) -> np.ndarray:
        if self.count < self.capacity:
            return self.buf[: self.count].copy()
        return np.concatenate([self.buf[self.pos :], self.buf[: self.pos]])

    def _phys(self, logical: int) -> int:
        """Physical slot of the ``logical``-th oldest retained sample."""
        if self.count < self.capacity:
            return logical  # never wrapped: data occupies [0, count)
        return (self.pos + logical) % self.capacity

    def get(self, logical: int):
        return self.buf[self._phys(logical)]

    def patch(self, logical: int, value) -> None:
        """Overwrite one retained sample in place (re-admission repair)."""
        self.buf[self._phys(logical)] = value


class StreamSearchEngine:
    """Incremental nearest-window search for Q standing queries.

    Args as ``repro``'s engine, without ``backend``:
      queries: ``(Q, l)`` (or ``(l,)``) raw queries; z-normalized once here.
      length: window/query length.
      window: Sakoe-Chiba warping window in samples.
      variant: ``"eapruned"`` (LB cascade + cb tightening) or
        ``"eapruned_nolb"`` (stream-order rounds, no cascade).
      batch: candidate lanes per query per round.
      band_width, rows_per_step, block_k, row_block: DTW batch knobs, as in
        ``multi_query_search``.
      chunk_lb: the plain cascade's window chunk (memory, not results).
      ub_init: optional per-query incumbent seeds (scalar or ``(Q,)``).
      ring_capacity: keep the last W raw samples for ``recent()`` and for
        re-admitting fully past windows; ``None`` keeps no history.
      stream_chunk: the fixed ingest shape: every ingest is padded to
        ``stream_chunk`` samples and bigger arrivals are split into pieces
        of that size first. ``None`` ingests each arrival as it comes.
      quarantine: exclude windows overlapping non-finite samples (default
        on).
      debug_checks: check after every ingest that no NaN reached the carried
        incumbents (a host sync an ingest); ``None`` defers to
        ``$REPRO_DEBUG_CHECKS``.
      executor: the ingest seam. ``None`` builds the plain
        ``search.streaming.StreamIngestExecutor`` bound to this engine's
        knobs; an object with ``run_ingest`` replaces it; any other callable
        receives the default executor and returns the one to use.
      gather, slab_budget: candidate materialization (``"fused"``: kernel A
        slices the windows; ``"slab"``: kernel D on a gathered slab, within
        ``slab_budget`` bytes when set).
      device: where queries, incumbents and every ingest's work live.
    """

    def __init__(
        self,
        queries,
        length: int,
        window: int,
        variant: str = "eapruned",
        batch: int = 64,
        band_width: int | None = None,
        chunk_lb: int = 4096,
        rows_per_step: int = 1,
        block_k: int = 8,
        row_block: int = 128,
        ub_init=None,
        ring_capacity: int | None = None,
        stream_chunk: int | None = None,
        quarantine: bool = True,
        debug_checks: bool | None = None,
        executor=None,
        gather: str = "fused",
        slab_budget: int | None = None,
        device=None,
    ):
        if variant not in MULTI_VARIANTS:
            raise ValueError(f"variant must be one of {MULTI_VARIANTS}")
        if ring_capacity is not None and ring_capacity < 1:
            raise ValueError("ring_capacity must be >= 1")
        if stream_chunk is not None and stream_chunk < 1:
            raise ValueError("stream_chunk must be >= 1")
        self.device = resolve_device(device)
        q = queries if isinstance(queries, torch.Tensor) else np.asarray(queries)
        if q.ndim == 1:
            q = q[None]
        guards.ensure_series(q, "queries", ndim=2, min_len=length)
        guards.ensure_finite(q, "queries")
        guards.ensure_knobs(
            length=length, window=window, batch=batch, band_width=band_width,
            block_k=block_k, row_block=row_block, rows_per_step=rows_per_step,
        )
        self.length = int(length)
        self.window = int(window)
        self.variant = variant
        self.batch = int(batch)
        self.band_width = band_width
        self.chunk_lb = int(chunk_lb)
        self.rows_per_step = int(rows_per_step)
        self.block_k = int(block_k)
        self.row_block = int(row_block)
        self.stream_chunk = None if stream_chunk is None else int(stream_chunk)
        self.gather = gather
        self.slab_budget = None if slab_budget is None else int(slab_budget)
        self.queries_n = znorm(as_float32(q, self.device)[:, : self.length])
        self.u, self.low = envelope(self.queries_n, self.window)
        self._ub, self._best = initial_incumbents(
            self.queries_n.shape[0], torch.float32, ub_init, device=self.device
        )
        self._tail = torch.zeros(0, dtype=torch.float32, device=self.device)
        self._n_seen = 0
        self._n_chunks = 0
        self._rounds = torch.zeros((), dtype=torch.int64, device=self.device)
        self._lanes = torch.zeros((), dtype=torch.int64, device=self.device)
        self.quarantine = bool(quarantine)
        self.debug_checks = guards.debug_checks_enabled(debug_checks)
        self._ledger = QuarantineLedger(device=self.device)
        self._pending_rescore: list[tuple[np.ndarray, np.ndarray]] = []
        self._ring = (
            _Ring(ring_capacity, np.float32) if ring_capacity is not None
            else None
        )
        # The ingest seam: every ingest's device work goes through
        # self._executor.run_ingest.
        default_executor = StreamIngestExecutor(
            self.queries_n, self.u, self.low,
            length=self.length, window=self.window, variant=self.variant,
            batch=self.batch, band_width=self.band_width,
            chunk_lb=self.chunk_lb, rows_per_step=self.rows_per_step,
            block_k=self.block_k, row_block=self.row_block,
            quarantine=self.quarantine, gather=self.gather,
            slab_budget=self.slab_budget, device=self.device,
        )
        if executor is None:
            executor = default_executor
        elif callable(executor) and not hasattr(executor, "run_ingest"):
            executor = executor(default_executor)
        if not hasattr(executor, "run_ingest"):
            raise guards.SearchInputError(
                "executor must expose run_ingest (or be a factory that "
                "returns one when called with the default executor)"
            )
        self._executor = executor

    # -- state ------------------------------------------------------------
    @property
    def n_queries(self) -> int:
        return int(self.queries_n.shape[0])

    @property
    def n_seen(self) -> int:
        """Raw samples ingested since the stream began."""
        return self._n_seen

    @property
    def n_windows(self) -> int:
        """Candidate windows scanned so far (== offline window count)."""
        return max(0, self._n_seen - self.length + 1)

    @property
    def rounds(self) -> int:
        """Total batch rounds spent across all ingests (host sync)."""
        return int(self._rounds)

    @property
    def lanes(self) -> int:
        """Total candidate lanes submitted across all ingests (host sync)."""
        return int(self._lanes)

    @property
    def quarantined_windows(self) -> int:
        """Windows excluded from search by the non-finite quarantine."""
        return int(self._ledger.windows)

    @property
    def quarantined_samples(self) -> int:
        """Non-finite raw samples seen on the stream so far."""
        return int(self._ledger.samples)

    @property
    def readmitted_windows(self) -> int:
        """Quarantined windows re-admitted (rescored) after ``correct``."""
        return self._ledger.readmitted

    @property
    def pending_rescore(self) -> int:
        """Re-admitted windows queued but not yet rescored (flushed by the
        next ``ingest`` or ``save_state``)."""
        return sum(s.shape[0] for s, _ in self._pending_rescore)

    def best(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Current ``(best_start, best_dist)`` per query, ``(Q,)`` each, on
        the engine's device.

        ``best_start`` is in stream coordinates (-1 while no window has been
        scanned or an ``ub_init`` seed is still unbeaten).
        """
        return self._best, self._ub

    def recent(self) -> np.ndarray:
        """The last ``ring_capacity`` raw samples, oldest first."""
        if self._ring is None:
            raise ValueError("engine built without ring_capacity")
        return self._ring.view()

    # -- re-admission ------------------------------------------------------
    def correct(self, position: int, values) -> int:
        """Patch previously non-finite samples; re-admit the windows they
        poisoned (DESIGN.md §2.7).

        ``position`` is in stream coordinates. The samples are patched
        wherever the engine still holds them (the carried tail, the ring),
        and every fully past window that becomes all-finite again is queued
        for rescoring against the carried incumbents; the rescore runs as
        one launch on the next ``ingest`` (or ``save_state``), through
        ``search.streaming.rescore_windows``. Windows still straddling the
        frontier need no queue: the next ingest scans them through the
        patched tail.

        Only re-admission is supported: every targeted sample must be
        non-finite now (``StreamStateError`` otherwise). Replacement
        ``values`` must be finite (``NonFiniteInputError``), within the
        ingested stream and within retained history (``StreamStateError``);
        without a ring that is the ``length - 1`` tail only. Returns the
        number of windows queued for rescoring.
        """
        if not self.quarantine:
            raise guards.StreamStateError(
                "correct() is the quarantine re-admission path; this engine "
                "was built with quarantine=False"
            )
        values = np.asarray(values, np.float32).reshape(-1)
        k = int(values.shape[0])
        if k == 0:
            raise guards.SearchInputError("correct() needs >= 1 value")
        if not np.all(np.isfinite(values)):
            raise guards.NonFiniteInputError(
                "replacement values must be finite — correct() re-admits "
                "quarantined samples, it does not re-poison them"
            )
        position = int(position)
        if position < 0:
            raise guards.SearchInputError("position must be >= 0")
        n_seen = self._n_seen
        if position + k > n_seen:
            raise guards.StreamStateError(
                f"correct() targets [{position}, {position + k}) but only "
                f"{n_seen} samples have arrived — cannot correct the future",
                n_seen=n_seen, chunk_index=self._n_chunks,
            )
        tail_np = self._tail.cpu().numpy().copy()
        tail_len = int(tail_np.shape[0])
        ring_count = self._ring.count if self._ring is not None else 0
        horizon = max(tail_len, ring_count)
        if position < n_seen - horizon:
            raise guards.StreamStateError(
                f"correct() targets position {position} but retained "
                f"history starts at {n_seen - horizon} (tail {tail_len}, "
                f"ring {ring_count}) — the samples are gone",
                n_seen=n_seen, chunk_index=self._n_chunks,
            )
        tail_base = n_seen - tail_len
        ring_base = n_seen - ring_count
        for i in range(k):
            p = position + i
            cur = (
                tail_np[p - tail_base]
                if p >= tail_base
                else self._ring.get(p - ring_base)
            )
            if np.isfinite(cur):
                raise guards.StreamStateError(
                    f"sample at stream position {p} is already finite — "
                    "correct() only re-admits quarantined samples",
                    n_seen=n_seen, chunk_index=self._n_chunks,
                )
        for i in range(k):
            p = position + i
            if p >= tail_base:
                tail_np[p - tail_base] = values[i]
            if self._ring is not None and p >= ring_base:
                self._ring.patch(p - ring_base, values[i])
        self._tail = torch.as_tensor(tail_np, device=self.device)
        self._ledger.correct_samples(k)

        # Fully past windows revived by this patch: starts overlapping the
        # corrected region whose whole [s, s + length) is retained in the
        # ring and is now all-finite. Each overlaps a patched sample, so each
        # was counted quarantined when it was scanned.
        queued = 0
        if self._ring is not None and ring_count >= self.length:
            hist = self._ring.view()  # post-patch, covers [ring_base, n_seen)
            s_lo = max(position - self.length + 1, ring_base, 0)
            s_hi = min(position + k - 1, n_seen - self.length)
            starts, wins = [], []
            for s in range(s_lo, s_hi + 1):
                w = hist[s - ring_base : s - ring_base + self.length]
                if np.all(np.isfinite(w)):
                    starts.append(s)
                    wins.append(w.copy())
            if starts:
                self._pending_rescore.append(
                    (np.asarray(starts, np.int64), np.stack(wins))
                )
                queued = len(starts)
        return queued

    def _flush_rescore(self) -> None:
        """Rescore queued re-admitted windows against the incumbents."""
        if not self._pending_rescore:
            return
        starts = np.concatenate([s for s, _ in self._pending_rescore])
        wins = np.concatenate([w for _, w in self._pending_rescore])
        self._pending_rescore = []
        self._ub, self._best = rescore_windows(
            wins, starts, self.queries_n, self.u, self.low, self._ub,
            self._best, window=self.window, variant=self.variant,
            band_width=self.band_width, rows_per_step=self.rows_per_step,
            block_k=self.block_k, row_block=self.row_block,
            device=self.device,
        )
        self._ledger.readmit(int(starts.shape[0]))

    # -- checkpoint -------------------------------------------------------
    def save_state(self) -> dict:
        """Snapshot the carried state as a flat dict of numpy arrays, with
        ``repro``'s keys: the boundary tail, the per-query incumbents, the
        counters (int64) and the ring when there is one. Pending rescores
        are flushed first, so a snapshot never carries a queue. The
        queries and knobs are construction-time configuration and are not
        captured; ``restore_state`` validates against the live engine's.
        """
        self._flush_rescore()
        state = {
            "tail": self._tail.cpu().numpy(),
            "ub": self._ub.cpu().numpy(),
            "best": self._best.cpu().numpy().astype(np.int64),
            "n_seen": np.asarray(self._n_seen, np.int64),
            "n_chunks": np.asarray(self._n_chunks, np.int64),
            "rounds": np.asarray(int(self._rounds), np.int64),
            "lanes": np.asarray(int(self._lanes), np.int64),
        }
        state.update(self._ledger.state_dict())
        if self._ring is not None:
            state["ring_buf"] = self._ring.buf.copy()
            state["ring_count"] = np.asarray(self._ring.count, np.int64)
            state["ring_pos"] = np.asarray(self._ring.pos, np.int64)
        return state

    def restore_state(self, state: dict) -> None:
        """Adopt a ``save_state()`` snapshot, the port's or ``repro``'s
        (int32 ``best`` and counters are widened to int64); raises
        ``StreamStateError`` on a snapshot inconsistent with this engine's
        configuration."""
        required = ("tail", "ub", "best", "n_seen", "n_chunks",
                    "rounds", "lanes", "quarantined", "bad_samples")
        missing = [k for k in required if k not in state]
        if missing:
            raise guards.StreamStateError(
                f"checkpoint missing state keys {missing}"
            )
        nq = self.n_queries
        ub = np.asarray(state["ub"])
        if ub.shape != (nq,):
            raise guards.StreamStateError(
                f"checkpoint incumbents have shape {ub.shape}, engine has "
                f"{nq} standing queries — wrong stream?"
            )
        tail = np.asarray(state["tail"])
        if tail.ndim != 1 or tail.shape[0] > self.length - 1:
            raise guards.StreamStateError(
                f"checkpoint tail shape {tail.shape} overflows the "
                f"(length - 1,) = ({self.length - 1},) boundary context",
                n_seen=int(state["n_seen"]),
            )
        if (self._ring is not None) != ("ring_buf" in state):
            raise guards.StreamStateError(
                "checkpoint and engine disagree on ring_capacity monitoring"
            )
        dev = self.device
        self._tail = torch.as_tensor(tail.astype(np.float32), device=dev)
        self._ub = torch.as_tensor(ub.astype(np.float32), device=dev)
        self._best = torch.as_tensor(
            np.asarray(state["best"]).astype(np.int64), device=dev)
        self._n_seen = int(state["n_seen"])
        self._n_chunks = int(state["n_chunks"])
        self._rounds = torch.as_tensor(int(state["rounds"]), dtype=torch.int64,
                                       device=dev)
        self._lanes = torch.as_tensor(int(state["lanes"]), dtype=torch.int64,
                                      device=dev)
        # The ledger owns the quarantine keys (with the fallback for
        # snapshots that predate re-admission); snapshots never carry a
        # pending queue (save_state flushes first).
        self._ledger.load_state_dict(state)
        self._pending_rescore = []
        if self._ring is not None:
            buf = np.asarray(state["ring_buf"])
            if buf.shape != self._ring.buf.shape:
                raise guards.StreamStateError(
                    f"checkpoint ring capacity {buf.shape[0]} != engine "
                    f"ring capacity {self._ring.capacity}"
                )
            self._ring.buf = buf.astype(self._ring.buf.dtype, copy=True)
            self._ring.count = int(state["ring_count"])
            self._ring.pos = int(state["ring_pos"])

    # -- ingest -----------------------------------------------------------
    def ingest(self, chunk) -> tuple[torch.Tensor, torch.Tensor]:
        """Feed one chunk of reference samples; returns ``self.best()``.

        Scans every window whose last sample arrives with this chunk.
        Chunks may have any length (an empty one only flushes pending
        rescores); windows straddling chunk boundaries are handled through
        the carried tail. With ``stream_chunk`` set, arrivals bigger than
        the fixed ingest shape are split into ``stream_chunk``-sized pieces
        (one ingest each) and every piece is padded to that shape.
        """
        self._flush_rescore()  # re-admitted windows score before new ones
        chunk = as_float32(chunk, self.device).reshape(-1)
        if chunk.shape[0] == 0:
            return self.best()
        if self.quarantine:
            self._ledger.note_samples((~torch.isfinite(chunk)).sum())
        if self._ring is not None:
            self._ring.extend(chunk.cpu().numpy())
        if self.stream_chunk is None:
            self._ingest_piece(chunk, pad_to=None)
        else:
            for pos in range(0, int(chunk.shape[0]), self.stream_chunk):
                self._ingest_piece(
                    chunk[pos : pos + self.stream_chunk],
                    pad_to=self.stream_chunk,
                )
        return self.best()

    def _ingest_piece(self, chunk: torch.Tensor, pad_to: int | None) -> None:
        tail_len = int(self._tail.shape[0])
        if tail_len + int(chunk.shape[0]) < self.length:
            # Not a full window yet: extend the boundary context only.
            self._tail = torch.cat([self._tail, chunk])
            self._n_seen += int(chunk.shape[0])
            self._n_chunks += 1
            return
        offset = self._n_seen - tail_len  # stream coordinate of tail[0]
        self._tail, res = self._executor.run_ingest(
            self._tail, chunk, self._ub, self._best, offset,
            pad_to=pad_to, chunk_index=self._n_chunks,
        )
        if self.debug_checks:
            # Synchronous tripwire: a NaN must never reach the carried
            # incumbents (the quarantine exists to guarantee exactly this).
            if bool(torch.isnan(res.ub).any()):
                raise guards.NonFiniteInputError(
                    f"debug-mode tripwire: NaN reached the incumbents "
                    f"(n_seen={self._n_seen}, chunk_index={self._n_chunks})"
                )
        self._ub, self._best = res.ub, res.best
        # Device counters: reading them here would sync on every ingest.
        self._rounds = self._rounds + res.rounds.max()
        self._lanes = self._lanes + res.lanes.sum()
        self._ledger.note_windows(res.quarantined)
        self._n_seen += int(chunk.shape[0])
        self._n_chunks += 1
