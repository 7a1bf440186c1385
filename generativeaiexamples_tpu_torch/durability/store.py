"""Durable vector store: WAL-fronted wrapper + snapshot/recovery engine
(port of the JAX package's ``durability/store.py``).

``DurableVectorStore`` wraps an in-process :class:`VectorStore` backend
(the port's ``GPUVectorStore`` on the card, or ``MemoryVectorStore``) and
makes its mutations durable:

* every ``add`` / ``delete_source`` is appended to the WAL (write-ahead:
  the record is on disk before the in-memory store mutates);
* ``index_swap`` events a backend reports are logged as marker records
  (replay ignores them; the port's exact store reports none);
* every ``snapshot_every_records`` WAL records a snapshot is cut through
  the backend's own ``save()`` path — written to a temp directory,
  atomically renamed to ``snap-<seq>``, published by atomically replacing
  ``MANIFEST.json`` — and the WAL is truncated.

Directory layout::

    <dir>/wal.log                    append-only mutation log
    <dir>/MANIFEST.json              {"snapshot": "snap-...", "wal_seq": N}
    <dir>/snap-<seq>/                backend save() output
    <dir>/wal.log.quarantine-<off>   torn tail preserved by recovery

Crash windows: ``os.replace`` cannot atomically swap non-empty
directories, so the manifest is the commit point — a crash after the
snapshot rename but before the manifest replace leaves the old manifest
pointing at the old (still present) snapshot; a crash after the manifest
replace but before the WAL truncate leaves records the snapshot already
covers, which recovery skips because the manifest names the highest
sequence it contains.

Recovery restores a snapshot onto the wrapped store's own device (a
``GPUVectorStore`` on the card comes back on the card, and a sharded
fabric with its configured children on its device), and its stats
also carry the recovered store's ``rows``, ``version`` and ``device``
(``cpu`` for a host store), and a fabric's ``shard_devices``, which the
reference's do not.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import uuid
from typing import Any, Callable, Optional, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.durability import metrics
from generativeaiexamples_tpu_torch.durability.wal import (
    WalRecord,
    WriteAheadLog,
    replay,
)
from generativeaiexamples_tpu_torch.retrieval.base import (
    Chunk,
    ScoredChunk,
    VectorStore,
)

logger = logging.getLogger(__name__)

MANIFEST = "MANIFEST.json"
WAL_FILE = "wal.log"


def _read_manifest(directory: str) -> Optional[dict[str, Any]]:
    path = os.path.join(directory, MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        logger.warning("unreadable durability manifest at %s", path)
        return None


def _write_manifest(directory: str, manifest: dict[str, Any]) -> None:
    path = os.path.join(directory, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(manifest, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _apply_record(store: VectorStore, rec: WalRecord) -> bool:
    """Apply one replayed mutation; returns True if it mutated the store."""
    op = rec.header.get("op")
    if op == "add":
        h = rec.header
        chunks = [
            Chunk(text=t, source=s, metadata=m, id=i)
            for t, s, m, i in zip(
                h.get("texts", ()),
                h.get("sources", ()),
                h.get("metas", ()),
                h.get("ids", ()),
            )
        ]
        if chunks and rec.vectors is not None:
            store.add(chunks, rec.vectors)
            return True
        return False
    if op == "delete":
        store.delete_source(str(rec.header.get("source", "")))
        return True
    # index_swap and unknown ops: markers only — the index is derived
    # state and rebuilds from the replayed data.
    return False


def _default_loader(inner: VectorStore) -> Callable[[str], VectorStore]:
    """Reload a snapshot into a store like ``inner``: a store with a
    ``device`` (``GPUVectorStore``) comes back on that device with its
    query bound, never on the loader's default; a sharded fabric comes back
    through its ``load_like``, with its configured children on its device
    and its fan-out knobs (the reference's ``type(inner).load`` rebuilds a
    fabric of numpy ``MemoryVectorStore`` children)."""
    load_like = getattr(inner, "load_like", None)
    if callable(load_like):
        return load_like
    device = getattr(inner, "device", None)
    if device is None:
        return type(inner).load
    return lambda path: type(inner).load(path, device=device, max_query_batch=inner.max_query_batch)


def _recover(
    directory: str,
    inner: VectorStore,
    loader: Optional[Callable[[str], VectorStore]],
) -> tuple[VectorStore, dict[str, Any]]:
    """Restore the latest snapshot (if any) into a store and replay the
    WAL tail on top; never raises on a torn/corrupt tail."""
    t0 = time.perf_counter()
    stats: dict[str, Any] = {
        "snapshot_restored": False,
        "snapshot": "",
        "base_seq": 0,
        "replayed_records": 0,
        "skipped_records": 0,
        "torn_tail": False,
        "quarantined": "",
        "last_seq": 0,
        "duration_ms": 0.0,
    }
    manifest = _read_manifest(directory)
    if manifest and manifest.get("snapshot"):
        snap_dir = os.path.join(directory, str(manifest["snapshot"]))
        if os.path.isdir(snap_dir):
            try:
                load = loader or _default_loader(inner)
                restored = load(snap_dir)
                if restored is not inner and callable(getattr(inner, "close", None)):
                    # The empty store the restore replaces: a fabric's fan-out
                    # workers stop with it.
                    inner.close()
                inner = restored
                stats["snapshot_restored"] = True
                stats["snapshot"] = str(manifest["snapshot"])
                stats["base_seq"] = int(manifest.get("wal_seq", 0))
            except Exception:
                logger.exception(
                    "snapshot restore failed at %s; replaying WAL only",
                    snap_dir,
                )
    records, info = replay(os.path.join(directory, WAL_FILE), repair=True)
    base_seq = stats["base_seq"]
    last_seq = base_seq
    for rec in records:
        last_seq = max(last_seq, rec.seq)
        if rec.seq <= base_seq:
            stats["skipped_records"] += 1
            continue
        try:
            if _apply_record(inner, rec):
                stats["replayed_records"] += 1
        except Exception:
            logger.exception("WAL replay failed for seq=%d; skipping", rec.seq)
    stats["torn_tail"] = bool(info["torn"])
    stats["quarantined"] = info["quarantined"]
    stats["last_seq"] = last_seq
    stats["rows"] = len(inner)
    stats["version"] = inner.version()
    stats["device"] = str(getattr(inner, "device", "cpu"))
    if callable(getattr(inner, "shard_devices", None)):
        stats["shard_devices"] = inner.shard_devices()
    stats["duration_ms"] = round((time.perf_counter() - t0) * 1000, 3)
    return inner, stats


def _record_recovery_event(stats: dict[str, Any], context: str) -> None:
    """Count the recovery and pin it into the flight recorder so the one
    trace that explains 'where did my corpus go after the restart' cannot
    be evicted by healthy traffic."""
    metrics.record_recovery(
        stats["replayed_records"],
        1 if stats["torn_tail"] else 0,
        stats["duration_ms"],
    )
    degraded = [f"durability:{context}"]
    if stats["torn_tail"]:
        degraded.append("durability:torn_tail_quarantined")
    try:
        from generativeaiexamples_tpu_torch.obs.recorder import get_flight_recorder

        # Must stay valid under server.schema.RequestTraceRecord — a
        # non-conforming pinned entry breaks GET /debug/requests for the
        # whole process lifetime.
        get_flight_recorder().record(
            {
                "request_id": f"recovery-{uuid.uuid4().hex[:8]}",
                "route": "startup.recovery",
                "total_ms": stats["duration_ms"],
                "degraded": degraded,
                "attrs": {"recovery": dict(stats)},
            }
        )
    except Exception:  # observability must never fail recovery
        logger.exception("failed to record recovery event")


def hydrate_store(
    directory: str,
    inner: VectorStore,
    *,
    loader: Optional[Callable[[str], VectorStore]] = None,
) -> tuple[VectorStore, dict[str, Any]]:
    """Fast replica bootstrap: restore snapshot + WAL tail into ``inner``
    (or the loader's store) WITHOUT taking ownership of the WAL — for
    read-path hydration of a second store, which would otherwise boot
    empty and re-embed the corpus."""
    store, stats = _recover(directory, inner, loader)
    metrics.record_replica_bootstrap()
    return store, stats


class DurableVectorStore(VectorStore):
    """Write-ahead logged wrapper around an in-process vector store."""

    def __init__(
        self,
        inner: VectorStore,
        directory: str,
        *,
        loader: Optional[Callable[[str], VectorStore]] = None,
        fsync_every: int = 16,
        snapshot_every_records: int = 4096,
        keep_snapshots: int = 2,
    ) -> None:
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self._loader = loader
        self._keep_snapshots = max(1, int(keep_snapshots))
        self.snapshot_every_records = max(0, int(snapshot_every_records))
        self._mutate_lock = threading.RLock()
        inner, stats = _recover(directory, inner, loader)
        self._inner = inner
        self.dimensions = inner.dimensions
        self.last_recovery = stats
        if (
            stats["snapshot_restored"]
            or stats["replayed_records"]
            or stats["torn_tail"]
        ):
            _record_recovery_event(stats, "startup_recovery")
        self._wal = WriteAheadLog(
            os.path.join(directory, WAL_FILE),
            fsync_every=fsync_every,
            start_seq=stats["last_seq"],
        )
        self._records_since_snapshot = 0
        # Log index installs a backend reports as markers.
        inner.add_mutation_listener(self._on_inner_mutation)

    # -- mutations (write-ahead) ------------------------------------------

    def add(
        self, chunks: Sequence[Chunk], embeddings: Sequence[Sequence[float]]
    ) -> list[str]:
        vecs = np.asarray(embeddings, dtype=np.float32)
        if len(chunks) != len(vecs) or (
            len(chunks) and vecs.shape != (len(chunks), self.dimensions)
        ):
            raise ValueError(
                f"embeddings shape {vecs.shape} != "
                f"({len(chunks)}, {self.dimensions})"
            )
        header = {
            "op": "add",
            "ids": [c.id for c in chunks],
            "texts": [c.text for c in chunks],
            "sources": [c.source for c in chunks],
            "metas": [c.metadata for c in chunks],
        }
        with self._mutate_lock:
            self._wal.append(header, vecs)
            ids = self._inner.add(chunks, vecs)
            self._records_since_snapshot += 1
            self._maybe_snapshot_locked()
        return ids

    def delete_source(self, source: str) -> int:
        with self._mutate_lock:
            self._wal.append({"op": "delete", "source": source})
            removed = self._inner.delete_source(source)
            self._records_since_snapshot += 1
            self._maybe_snapshot_locked()
        return removed

    def _on_inner_mutation(self, event: str, info: dict[str, Any]) -> None:
        if event != "index_swap":
            return
        try:
            self._wal.append({"op": "index_swap", **info})
        except Exception:  # the swap itself already succeeded
            logger.exception("failed to log index_swap marker")

    # -- snapshots ---------------------------------------------------------

    def _maybe_snapshot_locked(self) -> None:
        if (
            self.snapshot_every_records
            and self._records_since_snapshot >= self.snapshot_every_records
        ):
            self._snapshot_locked()

    def snapshot(self) -> str:
        """Cut an atomic snapshot now and truncate the WAL."""
        with self._mutate_lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> str:
        t0 = time.perf_counter()
        seq = self._wal.last_seq
        name = f"snap-{seq:010d}"
        final = os.path.join(self.directory, name)
        if not os.path.isdir(final):
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            self._inner.save(tmp)
            os.rename(tmp, final)
        _write_manifest(
            self.directory,
            {
                "snapshot": name,
                "wal_seq": seq,
                "rows": len(self._inner),
                "version": self._inner.version(),
                "saved_at": time.time(),
            },
        )
        self._wal.truncate()
        self._records_since_snapshot = 0
        self._prune_snapshots(keep=name)
        duration_ms = round((time.perf_counter() - t0) * 1000, 3)
        metrics.record_snapshot(duration_ms)
        logger.info("snapshot %s: %d rows in %.3f ms", name, len(self._inner), duration_ms)
        return final

    def _prune_snapshots(self, keep: str) -> None:
        snaps = sorted(
            d
            for d in os.listdir(self.directory)
            if d.startswith("snap-") and not d.endswith(".tmp")
        )
        # Zero-padded names sort by sequence; always keep the newest
        # ``keep_snapshots`` plus the manifest-referenced one.
        survivors = set(snaps[-self._keep_snapshots :])
        survivors.add(keep)
        for d in snaps:
            if d not in survivors:
                shutil.rmtree(
                    os.path.join(self.directory, d), ignore_errors=True
                )

    # -- lifecycle ---------------------------------------------------------

    def flush(self) -> None:
        """fsync the WAL regardless of cadence (durability barrier used by
        the ingest pipeline before journaling ``file_done``)."""
        self._wal.flush()

    def close(self, *, final_snapshot: bool = False) -> None:
        with self._mutate_lock:
            if final_snapshot:
                try:
                    self._snapshot_locked()
                except Exception:
                    logger.exception("final snapshot failed")
            self._wal.close()

    # -- read path: pure delegation ---------------------------------------

    @property
    def inner(self) -> VectorStore:
        return self._inner

    def search(
        self, embedding: Sequence[float], top_k: int
    ) -> list[ScoredChunk]:
        return self._inner.search(embedding, top_k)

    def search_batch(
        self, embeddings: Sequence[Sequence[float]], top_k: int
    ) -> list[list[ScoredChunk]]:
        return self._inner.search_batch(embeddings, top_k)

    def sources(self) -> list[str]:
        return self._inner.sources()

    def __len__(self) -> int:
        return len(self._inner)

    def version(self) -> int:
        return self._inner.version()

    def capacity_stats(self) -> dict:
        return self._inner.capacity_stats()

    def save(self, path: str) -> None:
        self._inner.save(path)
