"""Named multi-tenant collections over the vector-store factory (port of
the JAX package's ``retrieval/fabric/collections.py``).

A :class:`CollectionManager` owns named collections, each an independent
``VectorStore`` built through ``retrieval/factory.py`` with per-collection
config overrides (backend and quantization mode), with

  * **quotas** — per-collection row/byte ceilings enforced at ingest
    admission (:meth:`admit` raises :class:`CollectionQuotaExceeded`
    *before* touching the store, so a tenant filling up cannot take a
    neighbour's device memory);
  * **per-collection versions** — each collection's store keeps its own
    monotonic mutation counter, so the result cache and the WAL/snapshot
    machinery compose per collection (an ingest into tenant A never
    invalidates tenant B's cached retrievals);
  * **aggregated capacity stats** — the fleet-level ``rag_store_*``
    gauges sum over every collection, and the per-collection
    ``rag_store_rows{collection=...}`` series feeds the tenancy
    dashboard (64-label fold, like obs/metrics).

The ``default`` collection is the chains-factory store singleton,
injected at construction so every existing single-namespace path keeps
its exact behaviour (durability wrapper included).
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Optional

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.retrieval.base import VectorStore

logger = get_logger(__name__)

DEFAULT_COLLECTION = "default"
_NAME_RE = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9_.-]{0,63}$")


class CollectionQuotaExceeded(RuntimeError):
    """Ingest admission refusal: the write would breach the collection's
    row or byte quota.  Maps to HTTP 413 on the chain server
    (``POST /documents``)."""

    def __init__(self, collection: str, detail: str) -> None:
        super().__init__(
            f"collection {collection!r} quota exceeded: {detail}"
        )
        self.collection = collection
        self.detail = detail


class UnknownCollection(KeyError):
    """Lookup of a collection that was never created (404 on the API)."""

    def __init__(self, name: str) -> None:
        super().__init__(name)
        self.name = name

    def __str__(self) -> str:
        return f"unknown collection {self.name!r}"


class _Collection:
    __slots__ = ("name", "store", "max_rows", "max_bytes", "config")

    def __init__(
        self,
        name: str,
        store: VectorStore,
        max_rows: int,
        max_bytes: int,
        config: dict,
    ) -> None:
        self.name = name
        self.store = store
        self.max_rows = max_rows
        self.max_bytes = max_bytes
        self.config = config


class CollectionManager:
    """Create/drop/list named collections; route stores and quotas.

    ``store_factory(name, overrides)`` builds a backend for a new
    collection (the retrieval factory partial-applied with app config);
    ``default_store`` supplies the pre-existing singleton lazily so
    building the manager never forces store construction (the
    ``/metrics`` peek contract)."""

    def __init__(
        self,
        store_factory: Callable[[str, dict], VectorStore],
        *,
        default_store: Optional[Callable[[], VectorStore]] = None,
        max_collections: int = 64,
        default_max_rows: int = 0,
        default_max_bytes: int = 0,
    ) -> None:
        self._factory = store_factory
        self._default_store = default_store
        self.max_collections = max(1, int(max_collections))
        self.default_max_rows = max(0, int(default_max_rows))
        self.default_max_bytes = max(0, int(default_max_bytes))
        self._lock = threading.RLock()
        self._collections: dict[str, _Collection] = {}
        self._stats_lock = threading.Lock()
        self._stats = {
            "created_total": 0,
            "dropped_total": 0,
            "quota_rejections_total": 0,
        }

    # -- lifecycle ---------------------------------------------------------

    def create(
        self,
        name: str,
        *,
        max_rows: Optional[int] = None,
        max_bytes: Optional[int] = None,
        **overrides,
    ) -> VectorStore:
        """Create a named collection (idempotent: re-creating an existing
        name returns it unchanged — callers treat create as ensure).

        ``overrides`` pass through to the store factory (``backend``,
        ``quantization``, ...); quotas default to the ``collections.*``
        config section, 0 meaning unlimited."""
        if not _NAME_RE.match(name or ""):
            raise ValueError(
                f"invalid collection name {name!r} (alnum start, "
                "[a-zA-Z0-9_.-], max 64 chars)"
            )
        with self._lock:
            existing = self._collections.get(name)
            if existing is not None:
                return existing.store
            if len(self._collections) >= self.max_collections:
                raise CollectionQuotaExceeded(
                    name,
                    f"collection count cap {self.max_collections} reached",
                )
            store = self._factory(name, dict(overrides))
            col = _Collection(
                name,
                store,
                self.default_max_rows if max_rows is None else int(max_rows),
                self.default_max_bytes
                if max_bytes is None
                else int(max_bytes),
                dict(overrides),
            )
            self._collections[name] = col
        with self._stats_lock:
            self._stats["created_total"] += 1
        logger.info(
            "collection %r created (max_rows=%d max_bytes=%d %s)",
            name, col.max_rows, col.max_bytes, overrides or "",
        )
        return store

    def drop(self, name: str) -> bool:
        """Drop a collection and release its store.  The default
        collection cannot be dropped (it is the singleton every
        legacy path shares)."""
        if name == DEFAULT_COLLECTION:
            raise ValueError("the default collection cannot be dropped")
        with self._lock:
            col = self._collections.pop(name, None)
        if col is None:
            return False
        close = getattr(col.store, "close", None)
        if callable(close):
            try:
                close()
            except Exception:  # noqa: BLE001 — drop is best-effort cleanup
                logger.exception("closing store of dropped %r failed", name)
        with self._stats_lock:
            self._stats["dropped_total"] += 1
        logger.info("collection %r dropped", name)
        return True

    def list(self) -> list[str]:
        with self._lock:
            names = set(self._collections)
        if self._default_store is not None:
            names.add(DEFAULT_COLLECTION)
        return sorted(names)

    def exists(self, name: str) -> bool:
        if name == DEFAULT_COLLECTION and self._default_store is not None:
            return True
        with self._lock:
            return name in self._collections

    def get(self, name: str = DEFAULT_COLLECTION) -> VectorStore:
        """The collection's store; the default lazily materialises the
        chains singleton (durability wrapper and all)."""
        with self._lock:
            col = self._collections.get(name)
            if col is not None:
                return col.store
        if name == DEFAULT_COLLECTION and self._default_store is not None:
            return self._default_store()
        raise UnknownCollection(name)

    def version(self, name: str = DEFAULT_COLLECTION) -> int:
        """Per-collection mutation counter (cache stamps / WAL compose
        per collection, not per process)."""
        return self.get(name).version()

    # -- quota admission ---------------------------------------------------

    def admit(self, name: str, add_rows: int, add_bytes: int) -> None:
        """Raise :class:`CollectionQuotaExceeded` if landing
        ``add_rows``/``add_bytes`` would breach the collection's quota.
        Called at ingest admission — BEFORE embedding or store work."""
        with self._lock:
            col = self._collections.get(name)
        if col is not None:
            max_rows, max_bytes = col.max_rows, col.max_bytes
            if max_rows <= 0 and max_bytes <= 0:
                return
            store = col.store
        elif name == DEFAULT_COLLECTION and self._default_store is not None:
            # The singleton honours the config-level default quotas.
            max_rows = self.default_max_rows
            max_bytes = self.default_max_bytes
            if max_rows <= 0 and max_bytes <= 0:
                return
            store = self._default_store()
        else:
            return
        stats = store.capacity_stats()
        if max_rows > 0 and stats.get("rows", 0) + add_rows > max_rows:
            with self._stats_lock:
                self._stats["quota_rejections_total"] += 1
            raise CollectionQuotaExceeded(
                name,
                f"rows {stats.get('rows', 0)}+{add_rows} > {max_rows}",
            )
        if (
            max_bytes > 0
            and stats.get("bytes", 0) + stats.get("host_bytes", 0) + add_bytes
            > max_bytes
        ):
            with self._stats_lock:
                self._stats["quota_rejections_total"] += 1
            raise CollectionQuotaExceeded(
                name,
                f"bytes {stats.get('bytes', 0)}+{add_bytes} > "
                f"{max_bytes}",
            )

    def add(self, name: str, chunks, embeddings) -> list[str]:
        """Quota-enforced ingest into a collection."""
        est_bytes = sum(
            len(e) * 4 for e in embeddings
        )  # f32 scoring-buffer estimate
        self.admit(name, len(chunks), est_bytes)
        return self.get(name).add(chunks, embeddings)

    # -- metrics -----------------------------------------------------------

    def capacity_by_collection(self) -> dict[str, dict]:
        """``capacity_stats()`` per collection — the labeled-gauge feed.
        The default collection reports only if its singleton already
        exists (the /metrics peek contract: scraping must not build it)."""
        out: dict[str, dict] = {}
        with self._lock:
            cols = list(self._collections.items())
        for name, col in cols:
            try:
                out[name] = col.store.capacity_stats()
            except Exception:  # noqa: BLE001 — one sick store ≠ no metrics
                logger.exception("capacity_stats failed for %r", name)
        return out

    def stats_snapshot(self) -> dict:
        with self._stats_lock:
            snap = dict(self._stats)
        with self._lock:
            snap["collections"] = len(self._collections) + (
                1 if self._default_store is not None else 0
            )
        return snap

    def close(self) -> None:
        """Release every non-default store (test teardown hook)."""
        with self._lock:
            cols = [
                n for n in self._collections if n != DEFAULT_COLLECTION
            ]
        for name in cols:
            try:
                self.drop(name)
            except Exception:  # noqa: BLE001
                pass
