"""Multi-tier request-result cache for the RAG hot path (port of the JAX
package's ``cache/``; the semantic ring is a torch tensor on the store's
device).

Two tiers front ``Retriever.retrieve_many`` (and, opt-in, the full
non-streaming answer):

  * **tier 0 (exact)** — an LRU keyed on the normalized
    ``(query, top_k, chain)`` tuple, each entry stamped with the vector
    store's :meth:`~..retrieval.base.VectorStore.version`; a version
    mismatch is an O(1) invalidation (miss + lazy eviction), never a
    flush.
  * **tier 1 (semantic)** — the query embedding the pipeline computes
    anyway, scored against a small ring buffer of recently-cached query
    vectors in one batched matmul; a cosine similarity above
    ``cache.similarity_threshold`` serves the cached retrieval set.

See ``docs/caching.md`` for tuning and invalidation semantics.
"""

from generativeaiexamples_tpu_torch.cache.core import (
    CacheEntry,
    RetrievalCache,
    normalize_query,
)
from generativeaiexamples_tpu_torch.cache.log import (
    CacheLog,
    bind_cache_log,
    cache_scope,
    current_cache_log,
)
from generativeaiexamples_tpu_torch.cache.metrics import (
    cache_metrics_lines,
    cache_snapshot,
    record_cache_hit,
    record_cache_invalidation,
    record_cache_miss,
    reset_cache_metrics,
)

__all__ = [
    "CacheEntry",
    "RetrievalCache",
    "normalize_query",
    "CacheLog",
    "bind_cache_log",
    "cache_scope",
    "current_cache_log",
    "cache_metrics_lines",
    "cache_snapshot",
    "record_cache_hit",
    "record_cache_invalidation",
    "record_cache_miss",
    "reset_cache_metrics",
]
