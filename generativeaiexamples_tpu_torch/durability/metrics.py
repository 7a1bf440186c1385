"""Durability metrics: WAL write-path counters and recovery gauges (port of
the JAX package's ``durability/metrics.py``: the same ``rag_wal_*`` and
``rag_recovery_*`` families, from zero).

Same shape as ``cache.metrics``: a module-level stats block under a
lock, ``record_*`` hooks called from the hot paths, and an exposition
helper that emits every family from zero so dashboards and the
from-zero exposition tests see the full schema before the first
mutation or recovery.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()

_WAL_OPS = ("add", "delete", "index_swap")


def _fresh() -> dict:
    return {
        "wal_records": {op: 0 for op in _WAL_OPS},
        "wal_records_other": 0,
        "wal_bytes": 0,
        "wal_fsyncs": 0,
        "wal_truncations": 0,
        "wal_last_seq": 0,
        "snapshots": 0,
        "snapshot_last_ms": 0.0,
        "recoveries": 0,
        "recovery_replayed_records": 0,
        "recovery_quarantined": 0,
        "recovery_resumed_jobs": 0,
        "recovery_last_ms": 0.0,
        "replica_bootstraps": 0,
    }


_STATS = _fresh()


def record_wal_append(op: str, nbytes: int, fsynced: bool, seq: int) -> None:
    with _LOCK:
        if op in _STATS["wal_records"]:
            _STATS["wal_records"][op] += 1
        else:
            _STATS["wal_records_other"] += 1
        _STATS["wal_bytes"] += int(nbytes)
        _STATS["wal_last_seq"] = max(_STATS["wal_last_seq"], int(seq))
        if fsynced:
            _STATS["wal_fsyncs"] += 1


def record_wal_fsync() -> None:
    with _LOCK:
        _STATS["wal_fsyncs"] += 1


def record_wal_truncate() -> None:
    with _LOCK:
        _STATS["wal_truncations"] += 1


def record_snapshot(duration_ms: float) -> None:
    with _LOCK:
        _STATS["snapshots"] += 1
        _STATS["snapshot_last_ms"] = float(duration_ms)


def record_recovery(
    replayed_records: int, quarantined: int, duration_ms: float
) -> None:
    with _LOCK:
        _STATS["recoveries"] += 1
        _STATS["recovery_replayed_records"] += int(replayed_records)
        _STATS["recovery_quarantined"] += int(quarantined)
        _STATS["recovery_last_ms"] = float(duration_ms)


def record_resumed_job() -> None:
    with _LOCK:
        _STATS["recovery_resumed_jobs"] += 1


def record_replica_bootstrap() -> None:
    with _LOCK:
        _STATS["replica_bootstraps"] += 1


def durability_snapshot() -> dict:
    with _LOCK:
        snap = {k: v for k, v in _STATS.items() if k != "wal_records"}
        snap["wal_records"] = dict(_STATS["wal_records"])
    return snap


def reset_durability_metrics() -> None:
    """Test/bench isolation hook (see ``reset_factories``)."""
    global _STATS
    with _LOCK:
        _STATS = _fresh()


def durability_metrics_lines() -> list[str]:
    """Prometheus exposition for the ``rag_wal_*`` / ``rag_recovery_*``
    families; every series appears from zero."""
    s = durability_snapshot()
    lines = [
        "# HELP rag_wal_records_total WAL records appended, by operation.",
        "# TYPE rag_wal_records_total counter",
    ]
    for op in _WAL_OPS:
        lines.append(
            f'rag_wal_records_total{{op="{op}"}} {s["wal_records"][op]}'
        )
    lines += [
        "# HELP rag_wal_bytes_total Bytes appended to the WAL.",
        "# TYPE rag_wal_bytes_total counter",
        f"rag_wal_bytes_total {s['wal_bytes']}",
        "# HELP rag_wal_fsyncs_total fsync calls issued by the WAL.",
        "# TYPE rag_wal_fsyncs_total counter",
        f"rag_wal_fsyncs_total {s['wal_fsyncs']}",
        "# HELP rag_wal_truncations_total WAL truncations after snapshots.",
        "# TYPE rag_wal_truncations_total counter",
        f"rag_wal_truncations_total {s['wal_truncations']}",
        "# HELP rag_wal_last_seq Highest WAL sequence number appended"
        " by this process.",
        "# TYPE rag_wal_last_seq gauge",
        f"rag_wal_last_seq {s['wal_last_seq']}",
        "# HELP rag_wal_snapshots_total Durable store snapshots cut.",
        "# TYPE rag_wal_snapshots_total counter",
        f"rag_wal_snapshots_total {s['snapshots']}",
        "# HELP rag_wal_snapshot_last_duration_ms Duration of the most"
        " recent snapshot.",
        "# TYPE rag_wal_snapshot_last_duration_ms gauge",
        f"rag_wal_snapshot_last_duration_ms {s['snapshot_last_ms']}",
        "# HELP rag_recovery_total Startup recoveries performed"
        " (snapshot restore and/or WAL replay).",
        "# TYPE rag_recovery_total counter",
        f"rag_recovery_total {s['recoveries']}",
        "# HELP rag_recovery_replayed_records_total WAL records replayed"
        " during recovery.",
        "# TYPE rag_recovery_replayed_records_total counter",
        f"rag_recovery_replayed_records_total {s['recovery_replayed_records']}",
        "# HELP rag_recovery_quarantined_records_total Torn/corrupt WAL"
        " tail records quarantined instead of failing boot.",
        "# TYPE rag_recovery_quarantined_records_total counter",
        f"rag_recovery_quarantined_records_total {s['recovery_quarantined']}",
        "# HELP rag_recovery_resumed_jobs_total Journaled bulk-ingest jobs"
        " resumed after restart.",
        "# TYPE rag_recovery_resumed_jobs_total counter",
        f"rag_recovery_resumed_jobs_total {s['recovery_resumed_jobs']}",
        "# HELP rag_recovery_last_duration_ms Duration of the most recent"
        " recovery.",
        "# TYPE rag_recovery_last_duration_ms gauge",
        f"rag_recovery_last_duration_ms {s['recovery_last_ms']}",
        "# HELP rag_recovery_replica_bootstraps_total Replicas hydrated"
        " from the latest snapshot instead of re-embedding.",
        "# TYPE rag_recovery_replica_bootstraps_total counter",
        f"rag_recovery_replica_bootstraps_total {s['replica_bootstraps']}",
    ]
    return lines
