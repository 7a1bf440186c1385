"""Prometheus lines for the retrieval fabric (port of the JAX package's
``retrieval/fabric/metrics.py``).

Same contracts as every other ``*_metrics_lines`` helper the chain server
composes: **from-zero** (every family exports before any collection
exists, so dashboards need no existence checks) and **peek-only**
(scraping must never instantiate a store or a manager).

Three families:

  * ``rag_shard_*`` — scatter-gather topology and fan-out counters of a
    sharded store.  The port has no sharded store yet (``ROADMAP.md``,
    Queue 1 item 8), so they export their zeros;
  * ``rag_coldtier_*`` — the host-RAM tier of that store: zeros too;
  * ``rag_collection_*`` — tenancy: collection count, lifecycle
    counters, quota rejections.

The store's capacity gauges (:func:`store_metrics_lines`, read by both
servers' ``/metrics``) carry the per-collection
``rag_store_rows{collection=...}`` series in the aggregate gauge's family,
folded by :func:`fold_collection_labels` (the obs/metrics 64-label rule).
"""

from __future__ import annotations

from typing import Optional

# Cardinality guard, mirroring obs/metrics._MAX_LABELS: tenants beyond
# the cap fold into one "other" series instead of growing the exposition
# with every created collection.
_MAX_LABELS = 64

_SCAN_TOP_K = 10  # fixed k for the analytic per-query scan gauges


def _escape(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def fold_collection_labels(per_collection: dict[str, dict]) -> list[tuple[str, dict]]:
    """Sorted ``(label, stats)`` rows with the 64-label cardinality fold:
    the first ``_MAX_LABELS - 1`` collections keep their own label, the
    tail folds into one summed ``"other"`` row."""
    items = sorted(per_collection.items())
    if len(items) < _MAX_LABELS:
        return items
    head = items[: _MAX_LABELS - 1]
    other: dict = {}
    for _, stats in items[_MAX_LABELS - 1 :]:
        for key, val in stats.items():
            if isinstance(val, (int, float)):
                other[key] = other.get(key, 0) + val
    return head + [("other", other)]


def _unwrap_fabric(store):
    """The sharded store behind ``store``: the port has none, so every
    store is unsharded (reference ``_unwrap_fabric``)."""
    return None


def fabric_metrics_lines(store=None, manager=None) -> list[str]:
    """``rag_shard_*`` / ``rag_coldtier_*`` / ``rag_collection_*`` lines.

    ``store`` is the peeked store singleton (or None); ``manager`` the
    peeked :class:`CollectionManager` (or None).  Both optional, both
    never instantiated here."""
    fabric = _unwrap_fabric(store) if store is not None else None
    snap = fabric.stats_snapshot() if fabric is not None else {}
    cap = fabric.capacity_stats() if fabric is not None else {}
    split = (
        fabric.scanned_bytes_split(_SCAN_TOP_K)
        if fabric is not None
        else {}
    )
    lines = [
        "# TYPE rag_shard_count gauge",
        f"rag_shard_count {cap.get('shards', 0)}",
        "# TYPE rag_shard_hot gauge",
        f"rag_shard_hot {cap.get('hot_shards', 0)}",
        "# TYPE rag_shard_cold gauge",
        f"rag_shard_cold {cap.get('cold_shards', 0)}",
        "# TYPE rag_shard_searches_total counter",
        f"rag_shard_searches_total {snap.get('searches_total', 0)}",
        "# TYPE rag_shard_queries_total counter",
        f"rag_shard_queries_total {snap.get('queries_total', 0)}",
        "# TYPE rag_shard_fanout_requests_total counter",
        f"rag_shard_fanout_requests_total {snap.get('requests_total', 0)}",
        "# TYPE rag_shard_fanout_batches_total counter",
        f"rag_shard_fanout_batches_total {snap.get('batches_total', 0)}",
        "# TYPE rag_shard_merge_candidates summary",
        f"rag_shard_merge_candidates_sum {snap.get('merge_candidates_sum', 0)}",
        f"rag_shard_merge_candidates_count {snap.get('merge_count', 0)}",
        "# TYPE rag_shard_replica_hydrations_total counter",
        "rag_shard_replica_hydrations_total "
        f"{snap.get('replica_hydrations_total', 0)}",
        "# TYPE rag_coldtier_promotions_total counter",
        "rag_coldtier_promotions_total "
        f"{snap.get('coldtier_promotions_total', 0)}",
        "# TYPE rag_coldtier_demotions_total counter",
        "rag_coldtier_demotions_total "
        f"{snap.get('coldtier_demotions_total', 0)}",
        "# TYPE rag_coldtier_prefetches_total counter",
        f"rag_coldtier_prefetches_total {snap.get('prefetches_total', 0)}",
        "# TYPE rag_coldtier_prefetch_bytes_total counter",
        "rag_coldtier_prefetch_bytes_total "
        f"{snap.get('prefetch_bytes_total', 0)}",
        "# TYPE rag_coldtier_host_bytes gauge",
        f"rag_coldtier_host_bytes {cap.get('host_bytes', 0)}",
        "# TYPE rag_scan_hbm_bytes_per_query gauge",
        f"rag_scan_hbm_bytes_per_query {split.get('hbm', 0)}",
        "# TYPE rag_scan_host_bytes_per_query gauge",
        f"rag_scan_host_bytes_per_query {split.get('host', 0)}",
    ]
    msnap = manager.stats_snapshot() if manager is not None else {}
    lines += [
        "# TYPE rag_collection_count gauge",
        f"rag_collection_count {msnap.get('collections', 0)}",
        "# TYPE rag_collection_created_total counter",
        f"rag_collection_created_total {msnap.get('created_total', 0)}",
        "# TYPE rag_collection_dropped_total counter",
        f"rag_collection_dropped_total {msnap.get('dropped_total', 0)}",
        "# TYPE rag_collection_quota_rejections_total counter",
        "rag_collection_quota_rejections_total "
        f"{msnap.get('quota_rejections_total', 0)}",
    ]
    return lines


def aggregate_capacity_stats(
    store=None, manager=None
) -> Optional[dict]:
    """Fleet-level ``rag_store_*`` aggregation: the singleton store PLUS
    every named collection (the singleton IS the default collection, so
    it is never double counted).  Returns None when nothing exists yet —
    the from-zero path."""
    totals = {"rows": 0, "bytes": 0, "tail_rows": 0}
    seen = False
    if store is not None:
        stats = store.capacity_stats()
        for key in totals:
            totals[key] += int(stats.get(key, 0))
        seen = True
    if manager is not None:
        for stats in manager.capacity_by_collection().values():
            for key in totals:
                totals[key] += int(stats.get(key, 0))
            seen = True
    return totals if seen else None


def store_metrics_lines(stats: Optional[dict], collections: Optional[dict] = None) -> list[str]:
    """Prometheus lines for vector-store capacity (``rag_store_*``; zeros
    before any store exists).  The unlabeled gauges are the aggregate over
    the singleton and every named collection; ``collections`` maps a
    collection's name to its ``capacity_stats()`` and feeds
    ``rag_store_rows{collection=...}`` (64-label fold) inside the same
    ``# TYPE`` block.  ``rag_store_bytes`` counts every device buffer."""
    s = stats or {}
    lines = ["# TYPE rag_store_rows gauge", f"rag_store_rows {s.get('rows', 0)}"]
    for label, cstats in fold_collection_labels(collections or {}):
        lines.append(f'rag_store_rows{{collection="{_escape(label)}"}} {cstats.get("rows", 0)}')
    return lines + [
        "# TYPE rag_store_bytes gauge",
        f"rag_store_bytes {s.get('bytes', 0)}",
        "# TYPE rag_store_tail_rows gauge",
        f"rag_store_tail_rows {s.get('tail_rows', 0)}",
    ]
