"""Similarity search over a long reference series (port of ``repro.search``)."""
from repro_torch.search.multi import MultiSearchResult, multi_query_search
from repro_torch.search.subsequence import SearchResult, subsequence_search

__all__ = [
    "MultiSearchResult",
    "SearchResult",
    "multi_query_search",
    "subsequence_search",
]
