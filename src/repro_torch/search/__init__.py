"""Similarity search over a long reference series (port of ``repro.search``):
the offline frontends (``subsequence``, ``multi``), the sharded ones on
``torch.distributed`` (``distributed``, ``multi.make_distributed_multi_search``),
the streaming ingest (``streaming``), the fault-tolerant range search
(``resilient``) over the pipeline's executor seam (``pipeline.Executor``:
host rounds, persistent sweep, sharded, hedged), the incumbent store and
quarantine ledger (``incumbents``) and the window statistics (``znorm``).

As in ``repro``, ``cascade`` here is ``search.cascade.cascade`` (the LB
operator chain); the pipeline's stage of the same name is
``pipeline.cascade`` and is not re-exported.
"""
from repro_torch.search.cascade import cascade, cascade_lower_bounds
from repro_torch.search.distributed import (
    DistSearchResult,
    make_distributed_search,
)
from repro_torch.search.incumbents import (
    IncumbentState,
    QuarantineLedger,
    fold_min,
    fold_np,
    initial_state,
    merge_states,
)
from repro_torch.search.multi import (
    DistMultiSearchResult,
    MultiSearchResult,
    make_distributed_multi_search,
    multi_query_search,
)
from repro_torch.search.pipeline import (
    Executor,
    HedgedExecutor,
    HostRoundsExecutor,
    PersistentExecutor,
    RangeResult,
    SearchPlan,
    ShardedExecutor,
    get_executor,
    make_plan,
)
from repro_torch.search.resilient import (
    CoverageError,
    ResilientSearchResult,
    resilient_search,
)
from repro_torch.search.streaming import (
    IngestResult,
    StreamIngestExecutor,
    ingest_chunk,
    initial_incumbents,
    rescore_windows,
)
from repro_torch.search.subsequence import (
    VARIANTS,
    SearchResult,
    subsequence_search,
)
from repro_torch.search.znorm import (
    append_window_stats,
    clamp_sigma,
    gather_norm_windows,
    sanitize_series,
    window_finite_mask,
    window_stats,
    znorm,
)

__all__ = [
    "CoverageError",
    "DistMultiSearchResult",
    "DistSearchResult",
    "Executor",
    "HedgedExecutor",
    "HostRoundsExecutor",
    "IncumbentState",
    "IngestResult",
    "MultiSearchResult",
    "PersistentExecutor",
    "QuarantineLedger",
    "RangeResult",
    "ResilientSearchResult",
    "SearchPlan",
    "SearchResult",
    "ShardedExecutor",
    "StreamIngestExecutor",
    "VARIANTS",
    "append_window_stats",
    "cascade",
    "cascade_lower_bounds",
    "clamp_sigma",
    "fold_min",
    "fold_np",
    "gather_norm_windows",
    "get_executor",
    "ingest_chunk",
    "initial_incumbents",
    "initial_state",
    "make_distributed_multi_search",
    "make_distributed_search",
    "make_plan",
    "merge_states",
    "multi_query_search",
    "rescore_windows",
    "resilient_search",
    "sanitize_series",
    "subsequence_search",
    "window_finite_mask",
    "window_stats",
    "znorm",
]
