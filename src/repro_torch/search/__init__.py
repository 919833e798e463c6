"""Similarity search over a long reference series (port of ``repro.search``):
the offline frontends (``subsequence``, ``multi``), the sharded ones on
``torch.distributed`` (``distributed``, ``multi.make_distributed_multi_search``),
the streaming ingest (``streaming``), the fault-tolerant range search
(``resilient``) over the pipeline's executor seam (``pipeline.Executor``:
host rounds, persistent sweep, sharded, hedged), the incumbent store and
quarantine ledger (``incumbents``) and the window statistics (``znorm``).
"""
from repro_torch.search.distributed import (
    DistSearchResult,
    make_distributed_search,
)
from repro_torch.search.incumbents import (
    IncumbentState,
    QuarantineLedger,
    fold_np,
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
    ShardedExecutor,
    get_executor,
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
from repro_torch.search.subsequence import SearchResult, subsequence_search
from repro_torch.search.znorm import append_window_stats

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
    "SearchResult",
    "ShardedExecutor",
    "StreamIngestExecutor",
    "append_window_stats",
    "fold_np",
    "get_executor",
    "ingest_chunk",
    "initial_incumbents",
    "make_distributed_multi_search",
    "make_distributed_search",
    "merge_states",
    "multi_query_search",
    "rescore_windows",
    "resilient_search",
    "subsequence_search",
]
