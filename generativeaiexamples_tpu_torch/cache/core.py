"""Exact + semantic result cache over the retrieval pipeline (port of the
JAX package's ``cache/core.py``).

Tier 0 is a plain LRU dict: O(1), no device involvement.  Tier 1 keeps a
fixed-shape ring of the query vectors of recently admitted entries on the
store's device and scores an incoming query batch against all of them in
ONE product (:func:`ring_best`).  Both tiers stamp entries with the vector
store's monotonic :meth:`~..retrieval.base.VectorStore.version`; a
mismatch at lookup time is a miss plus a lazy O(1) eviction
(``rag_cache_invalidations_total``), never a flush.

Similarities are true f32 whatever the process's matmul precision: the
product runs in f64 and rounds once to f32, so a TF32 setting made by a
caller cannot move a similarity across the hard ``>= threshold`` edge,
and a query's similarity does not depend on its batch.

Thread safety: one lock guards the exact dict and the ring bookkeeping.
The ring tensors are replaced, never written in place (an admit writes a
clone), so a lookup that captured ``(ring, valid)`` under the lock keeps
scoring that pair while an admit runs.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.cache.metrics import (
    record_cache_hit,
    record_cache_invalidation,
    record_semantic_scan,
)
from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


def normalize_query(query: str) -> str:
    """Whitespace-collapsed, casefolded form used as the exact-tier key."""
    return " ".join(query.split()).casefold()


@dataclasses.dataclass
class CacheEntry:
    """One cached retrieval result (plus optionally attached answers).

    ``candidates`` is the threshold-filtered vector-order candidate set
    *before* reranking (up to ``fetch_k`` rows): a semantic hit asking
    for a different ``top_k`` re-runs the rerank stage over these rather
    than trusting the stored ``hits`` ordering.  ``answers`` maps an LLM
    generation-settings key to a fully streamed answer text (populated
    only when ``cache.answer_enabled``).
    """

    query: str  # normalized form
    top_k: int
    chain: str
    store_version: int
    embedding: Optional[np.ndarray]  # unit-norm float32, or None
    candidates: list
    hits: list
    answers: dict = dataclasses.field(default_factory=dict)

    def get_answer(self, params_key: tuple) -> Optional[str]:
        return self.answers.get(params_key)


def ring_best(ring: torch.Tensor, valid: torch.Tensor, qs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """argmax cosine similarity of each query row against the ring.

    ``ring`` (cap, d) holds unit-norm f32 vectors (zeros in empty slots),
    ``valid`` (cap,) masks live slots, ``qs`` (B, d) unit-norm f32 queries,
    all on one device.  One product for the whole batch, accumulated in f64
    and rounded to f32; returns (best_idx, best_sim) per query, the first
    slot among equal maxima (as the reference's argmax)."""
    sims = torch.mm(qs.double(), ring.double().t()).float()  # (B, cap)
    sims = sims.masked_fill(~valid[None, :], float("-inf"))
    best = torch.argmax(sims, dim=1)
    best_sim = sims.gather(1, best[:, None])[:, 0]
    return best, best_sim


def _unit(vec) -> np.ndarray:
    v = np.asarray(vec, dtype=np.float32).reshape(-1)
    return v / max(float(np.linalg.norm(v)), 1e-12)


class RetrievalCache:
    """Two-tier (exact LRU + semantic ring) retrieval-result cache."""

    def __init__(
        self,
        dimensions: int,
        *,
        max_entries: int = 1024,
        semantic_entries: int = 512,
        similarity_threshold: float = 0.98,
        semantic_enabled: bool = True,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.dimensions = int(dimensions)
        self.max_entries = max(1, int(max_entries))
        self.similarity_threshold = float(similarity_threshold)
        self.semantic_enabled = bool(semantic_enabled) and semantic_entries > 0
        self._cap = max(1, int(semantic_entries))
        self._lock = threading.Lock()
        self._exact: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        # Ring state: device tensors are replaced (an update writes a
        # clone, never the live tensor) so a concurrent lookup always sees
        # a consistent (ring, valid) pair captured under the lock.
        self._ring = torch.zeros((self._cap, self.dimensions), dtype=torch.float32, device=self.device)
        self._ring_valid = torch.zeros((self._cap,), dtype=torch.bool, device=self.device)
        self._ring_entries: list[Optional[CacheEntry]] = [None] * self._cap
        self._ring_next = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._exact)

    # -- tier 0: exact ------------------------------------------------------

    @staticmethod
    def _key(query: str, top_k: int, chain: str) -> tuple:
        return (normalize_query(query), int(top_k), chain)

    def lookup_exact(
        self, query: str, top_k: int, chain: str, store_version: int
    ) -> Optional[CacheEntry]:
        """Version-checked exact lookup; records the hit, evicts on a
        version mismatch (counted as an invalidation).  Misses are NOT
        recorded here — the retriever counts one miss per query that
        reaches the compute path, so an exact-miss-then-semantic-hit
        never double-counts."""
        key = self._key(query, top_k, chain)
        with self._lock:
            entry = self._exact.get(key)
            if entry is None:
                return None
            if entry.store_version != int(store_version):
                self._drop_locked(key, entry)
                record_cache_invalidation()
                return None
            self._exact.move_to_end(key)
        record_cache_hit("exact")
        return entry

    def _drop_locked(self, key: tuple, entry: CacheEntry) -> None:
        self._exact.pop(key, None)
        for slot, e in enumerate(self._ring_entries):
            if e is entry:
                self._ring_entries[slot] = None
                self._ring_valid = self._ring_set(self._ring_valid, slot, False)
                break

    @staticmethod
    def _ring_set(t: torch.Tensor, slot: int, value) -> torch.Tensor:
        """A copy of ``t`` with row ``slot`` set: the live tensor, which a
        running lookup may hold, is never written."""
        out = t.clone()
        out[slot] = value
        return out

    # -- tier 1: semantic ---------------------------------------------------

    def lookup_semantic_many(
        self,
        embeddings: Sequence[Sequence[float]],
        chain: str,
        store_version: int,
    ) -> list[Optional[tuple[CacheEntry, float]]]:
        """Best ring match per query embedding, one batched matmul.

        Returns ``(entry, similarity)`` where the best live slot clears
        the similarity threshold and matches ``chain`` +
        ``store_version`` (a version mismatch evicts that slot and
        reports a miss for this query).  The caller resolves ``top_k``
        semantics — and records the hit via :func:`record_semantic_hit`
        only once it actually serves from the entry."""
        n = len(embeddings)
        if n == 0 or not self.semantic_enabled:
            return [None] * n
        with self._lock:
            ring, valid = self._ring, self._ring_valid
            entries = list(self._ring_entries)
        if not any(e is not None for e in entries):
            return [None] * n
        t_scan = time.perf_counter()
        qs = torch.from_numpy(np.stack([_unit(e) for e in embeddings])).to(self.device)
        best, best_sim = ring_best(ring, valid, qs)
        # Host values end the stage: the scan's device time stays in it.
        best, best_sim = best.tolist(), best_sim.tolist()
        record_semantic_scan((time.perf_counter() - t_scan) * 1000.0)
        out: list[Optional[tuple[CacheEntry, float]]] = []
        for idx, sim in zip(best, best_sim):
            sim = float(sim)
            entry = entries[int(idx)] if sim >= self.similarity_threshold else None
            if entry is None or entry.chain != chain:
                out.append(None)
                continue
            if entry.store_version != int(store_version):
                with self._lock:
                    self._drop_locked(
                        (entry.query, entry.top_k, entry.chain), entry
                    )
                record_cache_invalidation()
                out.append(None)
                continue
            out.append((entry, sim))
        return out

    @staticmethod
    def record_semantic_hit(entry: CacheEntry) -> None:
        record_cache_hit("semantic")

    # -- admission ----------------------------------------------------------

    def admit(
        self,
        query: str,
        top_k: int,
        chain: str,
        store_version: int,
        embedding: Optional[Sequence[float]],
        candidates: Sequence[Any],
        hits: Sequence[Any],
    ) -> CacheEntry:
        """Insert a freshly computed result into both tiers.

        Callers enforce the admission guards (no degradation marks, no
        expired deadline) BEFORE calling — the cache itself never
        second-guesses a result it is handed."""
        emb = _unit(embedding) if embedding is not None else None
        entry = CacheEntry(
            query=normalize_query(query),
            top_k=int(top_k),
            chain=chain,
            store_version=int(store_version),
            embedding=emb,
            candidates=list(candidates),
            hits=list(hits),
        )
        key = (entry.query, entry.top_k, entry.chain)
        with self._lock:
            old = self._exact.pop(key, None)
            if old is not None:
                # Replacing: free the old ring slot so the stale vector
                # cannot outscore its replacement.
                for slot, e in enumerate(self._ring_entries):
                    if e is old:
                        self._ring_entries[slot] = None
                        self._ring_valid = self._ring_set(self._ring_valid, slot, False)
                        break
            self._exact[key] = entry
            while len(self._exact) > self.max_entries:
                _, evicted = self._exact.popitem(last=False)
                for slot, e in enumerate(self._ring_entries):
                    if e is evicted:
                        self._ring_entries[slot] = None
                        self._ring_valid = self._ring_set(self._ring_valid, slot, False)
                        break
            if self.semantic_enabled and emb is not None:
                slot = self._ring_next
                self._ring_next = (slot + 1) % self._cap
                self._ring_entries[slot] = entry
                self._ring = self._ring_set(self._ring, slot, torch.from_numpy(emb))
                self._ring_valid = self._ring_set(self._ring_valid, slot, True)
        return entry

    def attach_answer(
        self, entry: CacheEntry, params_key: tuple, answer: str
    ) -> None:
        """Attach a cleanly completed answer to an admitted entry."""
        with self._lock:
            entry.answers[params_key] = answer

    # -- serve-stale (degradation rung) -------------------------------------

    def lookup_stale(
        self,
        query: str,
        chain: str,
        embedding: Optional[Sequence[float]] = None,
    ) -> Optional[CacheEntry]:
        """Version-IGNORING match for the ``cache_stale`` degradation
        rung: when the store is hard-down (breaker open, no host
        fallback) a possibly-stale cached result beats a failure.  Exact
        normalized-query match first (any ``top_k``, deepest wins), then
        a semantic match when an embedding is available."""
        nq = normalize_query(query)
        with self._lock:
            best: Optional[CacheEntry] = None
            for (q, _k, c), entry in self._exact.items():
                if q == nq and c == chain:
                    if best is None or entry.top_k > best.top_k:
                        best = entry
            if best is not None:
                return best
            ring, valid = self._ring, self._ring_valid
            entries = list(self._ring_entries)
        if embedding is None or not any(e is not None for e in entries):
            return None
        idx, sim = ring_best(
            ring, valid, torch.from_numpy(_unit(embedding))[None, :].to(self.device)
        )
        sim = float(sim.item())
        if sim < self.similarity_threshold:
            return None
        entry = entries[int(idx.item())]
        if entry is None or entry.chain != chain:
            return None
        return entry

    # -- maintenance --------------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._exact.clear()
            self._ring_entries = [None] * self._cap
            self._ring = torch.zeros_like(self._ring)
            self._ring_valid = torch.zeros_like(self._ring_valid)
            self._ring_next = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._exact),
                "ring_entries": sum(
                    1 for e in self._ring_entries if e is not None
                ),
            }
