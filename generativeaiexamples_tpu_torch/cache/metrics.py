"""Process-wide cache counters and their Prometheus text export.

Exports (appended to ``/metrics`` by BOTH the chain server and the
engine server, zeros from process start so dashboards need no existence
checks — same contract as ``resilience/metrics.py``):

  ``rag_cache_hits_total{tier=exact|semantic}``  requests served from
                                                 each cache tier
  ``rag_cache_misses_total``                     requests that computed
                                                 the full pipeline
  ``rag_cache_entries``                          live exact-tier entries
  ``rag_cache_invalidations_total``              entries dropped on a
                                                 store ``version()``
                                                 mismatch
  ``rag_cache_semantic_scan_ms``                 summary (``_sum`` /
                                                 ``_count``) of the
                                                 batched semantic-ring
                                                 scan time

A copy of the JAX package's ``cache/metrics.py``; the port imports nothing of it.
"""

from __future__ import annotations

import threading
from typing import Dict

_TIERS = ("exact", "semantic")


class _CacheStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.hits: Dict[str, int] = {}
        self.misses = 0
        self.invalidations = 0
        self.semantic_scan_ms_sum = 0.0
        self.semantic_scan_count = 0

    def record_hit(self, tier: str) -> None:
        with self._lock:
            self.hits[tier] = self.hits.get(tier, 0) + 1

    def record_miss(self) -> None:
        with self._lock:
            self.misses += 1

    def record_invalidation(self, n: int = 1) -> None:
        with self._lock:
            self.invalidations += n

    def record_semantic_scan(self, duration_ms: float) -> None:
        with self._lock:
            self.semantic_scan_ms_sum += float(duration_ms)
            self.semantic_scan_count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "hits": dict(self.hits),
                "misses": self.misses,
                "invalidations": self.invalidations,
                "semantic_scan_ms_sum": self.semantic_scan_ms_sum,
                "semantic_scan_count": self.semantic_scan_count,
            }

    def reset(self) -> None:
        with self._lock:
            self.hits.clear()
            self.misses = 0
            self.invalidations = 0
            self.semantic_scan_ms_sum = 0.0
            self.semantic_scan_count = 0


_STATS = _CacheStats()


def record_cache_hit(tier: str) -> None:
    _STATS.record_hit(tier)


def record_cache_miss() -> None:
    _STATS.record_miss()


def record_cache_invalidation(n: int = 1) -> None:
    _STATS.record_invalidation(n)


def record_semantic_scan(duration_ms: float) -> None:
    """One batched semantic-ring scan took ``duration_ms`` (host wall
    time around the jitted matmul, per *batch*, not per query)."""
    _STATS.record_semantic_scan(duration_ms)


def cache_snapshot() -> dict:
    snap = _STATS.snapshot()
    snap["entries"] = _live_entries()
    return snap


def _live_entries() -> int:
    """Exact-tier entry count of the process cache singleton, if built.

    Peeked (never instantiated) so a bare ``/metrics`` scrape cannot
    construct the embedder/store stack — same contract as
    ``peek_store``."""
    try:
        from generativeaiexamples_tpu_torch.chains.factory import (
            peek_retrieval_cache,
        )

        cache = peek_retrieval_cache()
    except Exception:
        return 0
    return len(cache) if cache is not None else 0


def cache_metrics_lines() -> list:
    """Prometheus text lines for the cache counters (both tiers export
    from zero)."""
    snap = _STATS.snapshot()
    lines = [
        "# HELP rag_cache_hits_total Requests served from the result cache, per tier.",
        "# TYPE rag_cache_hits_total counter",
    ]
    for tier in _TIERS:
        lines.append(
            f'rag_cache_hits_total{{tier="{tier}"}} {snap["hits"].get(tier, 0)}'
        )
    for tier, count in sorted(snap["hits"].items()):
        if tier not in _TIERS:
            lines.append(f'rag_cache_hits_total{{tier="{tier}"}} {count}')
    lines += [
        "# HELP rag_cache_misses_total Requests that ran the full retrieval pipeline.",
        "# TYPE rag_cache_misses_total counter",
        f"rag_cache_misses_total {snap['misses']}",
        "# HELP rag_cache_entries Live exact-tier cache entries.",
        "# TYPE rag_cache_entries gauge",
        f"rag_cache_entries {_live_entries()}",
        "# HELP rag_cache_invalidations_total Cache entries dropped on a store version mismatch.",
        "# TYPE rag_cache_invalidations_total counter",
        f"rag_cache_invalidations_total {snap['invalidations']}",
        "# HELP rag_cache_semantic_scan_ms Batched semantic-ring scan time in milliseconds.",
        "# TYPE rag_cache_semantic_scan_ms summary",
        f"rag_cache_semantic_scan_ms_sum {snap['semantic_scan_ms_sum']:g}",
        f"rag_cache_semantic_scan_ms_count {snap['semantic_scan_count']}",
    ]
    return lines


def reset_cache_metrics() -> None:
    """Testing hook: zero the counters (``reset_factories`` calls this
    alongside dropping the cache singleton)."""
    _STATS.reset()
