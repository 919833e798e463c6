"""The paper's own workload: UCR-suite subsequence similarity search.

Port of ``repro/configs/dtw_search.py`` with only the knobs this slice
reads. The sizes follow the paper's §5 protocol (Herrmann & Webb 2020): a
reference of N = 1,000,000 samples, queries of l = 1024, window ratio 0.1
(w = 102), Q = 8 standing queries and 256 candidates per query per round.
See ``repro``'s config for what each knob does; ``backend`` has no
counterpart (the port dispatches by device). The tiling knobs
``rows_per_step`` and ``row_block`` are accepted and handed to
``make_plan``, and change nothing here (no kernel of the port reads
them); ``block_k`` sets the granularity of the persistent
sweep's ``blocks`` work metric. The streaming knobs are ``repro``'s, and
``make_stream_engine`` hands them to ``serve.stream.StreamSearchEngine``:
``stream_chunk``, the samples an ingest takes (the engine's fixed ingest
shape: bigger arrivals are split and every piece padded to it),
``ring_capacity``, the monitoring ring over the last W raw samples
(``None``: no history), and ``debug_checks``, the per-ingest NaN tripwire
on the incumbents (``False`` still defers to ``$REPRO_DEBUG_CHECKS``).

The resilience and hedging knobs are ``repro``'s, at its defaults (see
its config for what each does), and three helpers hand them over:
``resilient_search`` (``search.resilient``: ``n_shards``,
``shard_max_retries``, ``shard_backoff``, ``retry_jitter``,
``shard_timeout``, ``require_full_coverage``, ``hedge``, ``hedge_delay``,
``hedge_max_inflight`` and the breaker's), ``make_hedged_executor``
(``search.pipeline.HedgedExecutor``: ``hedge_delay``,
``hedge_max_inflight`` and the breaker's) and ``make_supervisor``
(``serve.supervisor.SearchSupervisor``: ``async_ckpt`` and the
breaker's).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class SearchConfig:
    name: str = "dtw-search"
    ref_len: int = 1_000_000         # long reference series R
    query_len: int = 1024            # paper: 128 / 256 / 512 / 1024
    window_ratio: float = 0.1        # paper: 0.1 .. 0.5
    batch: int = 256                 # candidates per query per round
    variant: str = "eapruned"
    band_width: int | None = None    # None = warp-aligned 2*window+1
    rows_per_step: int = 1           # repro's loop-unroll knob; no effect
    block_k: int = 8                 # persistent sweep: lanes per work block
    row_block: int = 128             # repro's rows per grid step; no effect
    rounds: str = "host"             # round driver: "host" | "persistent"
    gather: str = "fused"            # candidate materialization (§2.10)
    slab_budget: int | None = None   # byte cap on host-side slabs (§2.10)
    n_queries: int = 8               # multi-query workload size
    warm_start: int = 0              # incumbent-seeding prepass
    stream_chunk: int = 8192         # samples per streaming ingest (serve.stream)
    ring_capacity: int | None = None  # monitoring ring over last W samples
    quarantine: bool = True          # non-finite window quarantine (§2.6)
    debug_checks: bool = False       # incumbent NaN tripwire (debug only)
    n_shards: int = 4                # resilient-search work ranges (§2.7)
    shard_max_retries: int = 2       # transient failures per (range, shard)
    shard_backoff: float = 0.05      # base retry sleep, doubles per retry
    shard_timeout: float | None = None  # soft per-range wall-clock budget
    require_full_coverage: bool = False  # degraded result -> CoverageError
    async_ckpt: bool = False         # off-thread supervisor checkpoints
    hedge: bool = False              # race stragglers on a backup shard (§2.9)
    hedge_delay: float | None = None  # None = threshold x EWMA from monitor
    hedge_max_inflight: int = 2      # backups raced per straggling attempt
    breaker_threshold: int = 3       # consecutive failures to open breaker
    breaker_cooldown: float = 1.0    # open-breaker load-shed seconds
    retry_jitter: bool = True        # decorrelated retry backoff (§2.9)

    @property
    def window(self) -> int:
        return int(self.query_len * self.window_ratio)

    def make_plan(self, **overrides):
        """Resolve this config into the pipeline's ``SearchPlan``;
        ``overrides`` replace individual knobs."""
        from repro_torch.search.pipeline import make_plan

        kw = dict(
            length=self.query_len,
            window=self.window,
            variant=self.variant,
            batch=self.batch,
            band_width=self.band_width,
            rows_per_step=self.rows_per_step,
            block_k=self.block_k,
            row_block=self.row_block,
            rounds=self.rounds,
            gather=self.gather,
            slab_budget=self.slab_budget,
            quarantine=self.quarantine,
            warm_start=self.warm_start,
        )
        kw.update(overrides)
        return make_plan(**kw)

    def make_stream_engine(self, queries, **overrides):
        """A ``StreamSearchEngine`` over ``queries`` with this config's
        search and streaming knobs; ``overrides`` replace individual
        engine arguments (``device``, ``executor``, ``ub_init``, ...)."""
        from repro_torch.serve.stream import StreamSearchEngine

        kw = dict(
            variant=self.variant,
            batch=self.batch,
            band_width=self.band_width,
            block_k=self.block_k,
            gather=self.gather,
            slab_budget=self.slab_budget,
            quarantine=self.quarantine,
            stream_chunk=self.stream_chunk,
            ring_capacity=self.ring_capacity,
            debug_checks=self.debug_checks or None,
        )
        kw.update(overrides)
        return StreamSearchEngine(queries, self.query_len, self.window, **kw)

    def _breaker(self) -> dict:
        return dict(breaker_threshold=self.breaker_threshold,
                    breaker_cooldown=self.breaker_cooldown)

    def resilient_search(self, ref, queries, **overrides):
        """``search.resilient.resilient_search`` of ``queries`` over
        ``ref`` with this config's search, resilience and hedging knobs;
        ``overrides`` replace individual arguments (``device``,
        ``n_ranges``, ``runner``, ``sleep``, ``clock``, ...)."""
        from repro_torch.search.resilient import resilient_search

        kw = dict(
            n_shards=self.n_shards,
            variant=self.variant,
            batch=self.batch,
            band_width=self.band_width,
            block_k=self.block_k,
            quarantine=self.quarantine,
            max_retries=self.shard_max_retries,
            backoff=self.shard_backoff,
            jitter=self.retry_jitter,
            timeout=self.shard_timeout,
            hedge=self.hedge,
            hedge_delay=self.hedge_delay,
            hedge_max_inflight=self.hedge_max_inflight,
            require_full_coverage=self.require_full_coverage,
            **self._breaker(),
        )
        kw.update(overrides)
        return resilient_search(ref, queries, self.query_len, self.window,
                                **kw)

    def make_hedged_executor(self, executors, **overrides):
        """A ``HedgedExecutor`` over ``executors`` with this config's
        hedging and breaker knobs (``overrides``: ``clock``, ...)."""
        from repro_torch.search.pipeline import HedgedExecutor

        kw = dict(hedge_delay=self.hedge_delay,
                  hedge_max_inflight=self.hedge_max_inflight,
                  **self._breaker())
        kw.update(overrides)
        return HedgedExecutor(executors, **kw)

    def make_supervisor(self, engine, ckpt_dir: str, **overrides):
        """A ``SearchSupervisor`` around ``engine`` with this config's
        ``async_ckpt`` and breaker knobs (``overrides``: ``ckpt_every``,
        ``sleep``, ...)."""
        from repro_torch.serve.supervisor import SearchSupervisor

        kw = dict(async_ckpt=self.async_ckpt, **self._breaker())
        kw.update(overrides)
        return SearchSupervisor(engine, ckpt_dir, **kw)


CONFIG = SearchConfig()
