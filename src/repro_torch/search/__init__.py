"""Similarity search over a long reference series (port of ``repro.search``):
the offline frontends (``subsequence``, ``multi``), the streaming ingest
(``streaming``), the incumbent store and quarantine ledger
(``incumbents``) and the window statistics (``znorm``).
"""
from repro_torch.search.incumbents import QuarantineLedger, fold_np
from repro_torch.search.multi import MultiSearchResult, multi_query_search
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
    "IngestResult",
    "MultiSearchResult",
    "QuarantineLedger",
    "SearchResult",
    "StreamIngestExecutor",
    "append_window_stats",
    "fold_np",
    "ingest_chunk",
    "initial_incumbents",
    "multi_query_search",
    "rescore_windows",
    "subsequence_search",
]
