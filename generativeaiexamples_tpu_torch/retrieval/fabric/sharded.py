"""Sharded scatter-gather vector store (port of the JAX package's
``retrieval/fabric/sharded.py``).

One logical :class:`~generativeaiexamples_tpu_torch.retrieval.base.VectorStore`
over N partitions.  Rows hash-route to shards by chunk id (stable crc32, so
a row lands on the same shard across processes, restarts and packages);
each shard is an ordinary child store built by ``shard_factory``: a
``MemoryVectorStore``, a ``GPUVectorStore`` on the card, anything honouring
the contract.  Queries fan out to every shard through per-shard
micro-batchers (concurrent fabric callers coalesce into one batched
``search_batch`` dispatch per shard) and merge by exact score: each shard
returns ``max(ceil(k * rescore_multiplier / N) + margin, k)`` candidates
(the clamp to ``k`` keeps the exact-mode merge equal to a single-store
scan, since any one shard could own the whole top-k), and the gather keeps
the best ``k``, stable in shard order for ties.  Child stores report exact
scores, so the merge needs no third scoring pass; cold shards run their
own exact stage-2 rescore (``coldtier.py``) before entering it.

Cold tier: when ``hot_shard_budget`` caps the number of device-resident
shards, per-shard hit EWMAs (updated on every query with whether the shard
contributed to its final top-k) drive demotion: the coldest hot shard
spills to a host-RAM :class:`ColdPartition` (PQ codes + f32 rows), and a
cold shard that out-scores a hot one is promoted back.  Writes promote
their target shard first: the mutable tier is always the hot one.  As in
the reference, ``rebalance`` runs inside every ``search_batch`` under the
fabric's lock, so a search may demote or promote a whole shard inline;
``swap_stats`` counts and times those swaps.

Differences from the reference: the fabric has a ``device`` (the card
unless ``"cpu"`` is passed) on which its default children
(``GPUVectorStore``; the reference's default is ``MemoryVectorStore``) and
the cold tier's stage 2 run; bulk
paths (add, promote, save, load) hand the children f32 arrays rather than
Python lists (the same values); and ``load_like`` reloads a snapshot with
this fabric's shard factory, device and fan-out knobs, which a durable
store's restore uses (the reference's restore builds ``MemoryVectorStore``
children).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
import zlib
from typing import Callable, Optional, Sequence

import numpy as np

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.engine.microbatch import MicroBatcher
from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk, VectorStore
from generativeaiexamples_tpu_torch.retrieval.fabric.coldtier import ColdPartition, HostPrefetcher
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore
from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore

logger = get_logger(__name__)


def _extract_rows(store: VectorStore) -> tuple[list[Chunk], np.ndarray]:
    """Live (chunks, f32 vectors) of an in-process child store: the
    demotion and persistence payload.  Reads the numpy store directly and
    the card's stores through their host mirror and validity mask."""
    if isinstance(store, MemoryVectorStore):
        return list(store._chunks), np.asarray(store._vecs, dtype=np.float32).copy()
    mirror = getattr(store, "_mirror", None)
    if isinstance(mirror, MemoryVectorStore):
        chunks = list(mirror._chunks)
        vecs = np.asarray(mirror._vecs, dtype=np.float32)
        valid = getattr(store, "_valid", None)
        if valid is not None:
            live = np.flatnonzero(valid[: len(chunks)])
            return [chunks[i] for i in live], vecs[live]
        return chunks, vecs.copy()
    raise TypeError(f"{type(store).__name__} exposes no host rows; cannot demote or persist this shard")


class _Shard:
    """One partition: a hot child store XOR a cold host partition."""

    __slots__ = ("idx", "store", "cold", "ewma")

    def __init__(self, idx: int, store: Optional[VectorStore]) -> None:
        self.idx = idx
        self.store = store  # None while demoted
        self.cold: Optional[ColdPartition] = None
        self.ewma = 0.0


class ShardedVectorStore(VectorStore):
    """Hash-sharded scatter-gather store with a host-RAM cold tier.  Its
    children (``GPUVectorStore`` unless ``shard_factory`` says otherwise)
    and its cold tier's rescore run on ``device``: the card unless
    ``device="cpu"``."""

    def __init__(
        self,
        dimensions: int,
        *,
        num_shards: int = 4,
        shard_factory: Optional[Callable[[int], VectorStore]] = None,
        rescore_multiplier: int = 4,
        margin: int = 8,
        fanout_max_batch: int = 32,
        fanout_wait_ms: float = 0.5,
        hot_shard_budget: int = 0,
        ewma_alpha: float = 0.2,
        pq_m: int = 16,
        seed: int = 0,
        name: str = "fabric",
        device=None,
    ) -> None:
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if dimensions % pq_m:
            # The cold tier's product quantizer splits rows into pq_m
            # subspaces; shrink to the largest divisor so demotion never
            # fails at runtime.
            pq_m = math.gcd(dimensions, pq_m) or 1
        self.dimensions = dimensions
        self.device = resolve_device(device)
        self.num_shards = int(num_shards)
        self.rescore_multiplier = max(1, int(rescore_multiplier))
        self.margin = max(0, int(margin))
        self.hot_shard_budget = max(0, int(hot_shard_budget))
        self.ewma_alpha = float(ewma_alpha)
        self.pq_m = int(pq_m)
        self.seed = int(seed)
        self.name = name
        self.fanout_max_batch = max(1, int(fanout_max_batch))
        self.fanout_wait_ms = max(0.0, float(fanout_wait_ms))
        self._factory = shard_factory or (lambda i: GPUVectorStore(dimensions, device=self.device))
        self._lock = threading.RLock()
        self._shards = [_Shard(i, self._factory(i)) for i in range(self.num_shards)]
        self.prefetcher = HostPrefetcher(self.device)
        self._stats_lock = threading.Lock()
        self._stats = {
            "searches_total": 0,
            "queries_total": 0,
            "merge_candidates_sum": 0,
            "merge_count": 0,
            "coldtier_promotions_total": 0,
            "coldtier_demotions_total": 0,
            "replica_hydrations_total": 0,
        }
        # Seconds spent in tier swaps and in the gather's merge (not in the
        # reference's snapshot; ``swap_stats`` reads them).
        self._seconds = {"demote_s_total": 0.0, "promote_s_total": 0.0, "merge_s_total": 0.0}
        # Per-shard fan-out batchers: concurrent fabric searches landing on
        # the same shard share one child search_batch dispatch.
        self._batchers = [
            MicroBatcher(
                self._make_dispatch(i),
                max_batch=self.fanout_max_batch,
                max_wait_ms=self.fanout_wait_ms,
                name=f"{name}-shard{i}",
            )
            for i in range(self.num_shards)
        ]
        self._closed = False

    # -- routing -----------------------------------------------------------

    def route(self, chunk_id: str) -> int:
        """Stable shard index for a chunk id (crc32: identical across
        processes, restarts, replicas and both packages)."""
        return zlib.crc32(chunk_id.encode("utf-8")) % self.num_shards

    def shards_for_replica(self, replica_idx: int, total_replicas: int) -> list[int]:
        """Round-robin shard-to-replica placement: the partitions replica
        ``replica_idx`` of ``total_replicas`` serves (and so the only ones
        its bootstrap hydrates)."""
        total = max(1, int(total_replicas))
        return [s for s in range(self.num_shards) if s % total == replica_idx % total]

    # -- mutation ----------------------------------------------------------

    def add(self, chunks: Sequence[Chunk], embeddings: Sequence[Sequence[float]]) -> list[str]:
        if len(chunks) != len(embeddings):
            raise ValueError("chunks and embeddings length mismatch")
        if not chunks:
            return []
        mat = np.asarray(embeddings, dtype=np.float32)
        if mat.shape != (len(chunks), self.dimensions):
            raise ValueError(f"embeddings shape {mat.shape} != ({len(chunks)}, {self.dimensions})")
        groups: dict[int, list[int]] = {}
        for i, c in enumerate(chunks):
            groups.setdefault(self.route(c.id), []).append(i)
        ids: list[Optional[str]] = [None] * len(chunks)
        with self._lock:
            for sidx, rows in groups.items():
                shard = self._shards[sidx]
                if shard.store is None:
                    # Writes land on the hot tier: promote first.
                    self._promote_locked(shard)
                out = shard.store.add([chunks[i] for i in rows], mat[np.asarray(rows)])
                for i, cid in zip(rows, out):
                    ids[i] = cid
        self._bump_version()
        return [cid if cid is not None else chunks[i].id for i, cid in enumerate(ids)]

    def delete_source(self, source: str) -> int:
        removed = 0
        with self._lock:
            for shard in self._shards:
                if shard.store is not None:
                    removed += shard.store.delete_source(source)
                elif shard.cold is not None:
                    removed += shard.cold.delete_source(source)
        if removed:
            self._bump_version()
        return removed

    def sources(self) -> list[str]:
        seen: dict[str, None] = {}
        with self._lock:
            for shard in self._shards:
                if shard.store is not None:
                    names = shard.store.sources()
                elif shard.cold is not None:
                    names = shard.cold.sources()
                else:
                    names = []
                for n in names:
                    seen.setdefault(n)
        return list(seen)

    def __len__(self) -> int:
        with self._lock:
            return sum(
                len(s.store) if s.store is not None else s.cold.rows() if s.cold is not None else 0
                for s in self._shards
            )

    # -- search ------------------------------------------------------------

    def shard_k(self, top_k: int) -> int:
        """Per-shard candidate count: the oversampled scatter quota, clamped
        to ``top_k`` so exact-mode merges stay equal to a single-store scan
        (any one shard may own the whole top-k)."""
        quota = math.ceil(top_k * self.rescore_multiplier / self.num_shards) + self.margin
        return max(quota, top_k)

    def _cold_hits(self, cold: ColdPartition, e, k: int, prefetcher: Optional[HostPrefetcher]) -> list[ScoredChunk]:
        return [ScoredChunk(cold.chunks[row], score)
                for row, score in cold.scan(e, k, k * self.rescore_multiplier, prefetcher)]

    def _make_dispatch(self, sidx: int):
        def _dispatch(items: list[tuple[np.ndarray, int]]) -> list[list[list[ScoredChunk]]]:
            # Coalesce every queued fabric call into ONE child dispatch at
            # the widest k; each caller keeps its own prefix.
            with self._lock:
                store = self._shards[sidx].store
                cold = self._shards[sidx].cold
            k_max = max(k for _, k in items)
            flat = np.concatenate([embs for embs, _ in items], axis=0)
            if store is not None:
                results = store.search_batch(flat, k_max)
            elif cold is not None:
                results = [self._cold_hits(cold, e, k_max, self.prefetcher) for e in flat]
            else:
                results = [[] for _ in flat]
            out: list[list[list[ScoredChunk]]] = []
            pos = 0
            for embs, k in items:
                out.append([r[:k] for r in results[pos : pos + len(embs)]])
                pos += len(embs)
            return out

        return _dispatch

    def search(self, embedding: Sequence[float], top_k: int) -> list[ScoredChunk]:
        return self.search_batch([embedding], top_k)[0]

    def search_batch(self, embeddings: Sequence[Sequence[float]], top_k: int) -> list[list[ScoredChunk]]:
        if top_k <= 0 or not len(embeddings):
            return [[] for _ in embeddings]
        embs = np.asarray(embeddings, dtype=np.float32).reshape(len(embeddings), -1)
        item = (embs, self.shard_k(top_k))
        # Scatter: shards dispatch through their micro-batchers (the
        # cross-shard fan-out runs in parallel worker threads); a single
        # shard skips the queue, there being nothing to fan out.
        if self.num_shards == 1:
            per_shard = [self._make_dispatch(0)([item])[0]]
        else:
            futures = [b.submit(item) for b in self._batchers]
            per_shard = [f.result() for f in futures]
        # Gather: merge by exact score, stable in shard order for ties.
        t0 = time.perf_counter()
        merged: list[list[ScoredChunk]] = []
        contributed: list[set[int]] = []
        n_cands = 0
        for qi in range(len(embs)):
            cands: list[tuple[float, int, ScoredChunk]] = []
            for sidx, shard_hits in enumerate(per_shard):
                for hit in shard_hits[qi]:
                    cands.append((hit.score, sidx, hit))
            cands.sort(key=lambda t: -t[0])
            top = cands[: min(top_k, len(cands))]
            merged.append([hit for _, _, hit in top])
            contributed.append({sidx for _, sidx, _ in top})
            n_cands += len(cands)
        with self._stats_lock:
            self._stats["merge_candidates_sum"] += n_cands
            self._stats["merge_count"] += len(embs)
            self._stats["searches_total"] += 1
            self._stats["queries_total"] += len(embs)
            self._seconds["merge_s_total"] += time.perf_counter() - t0
        self._update_ewmas(contributed)
        return merged

    def search_fallback(self, embeddings: Sequence[Sequence[float]], top_k: int) -> list[list[ScoredChunk]]:
        """Degradation rung: per-shard host scans (the children's own
        fallback rungs, cold shards rescored in numpy), no fan-out threads.

        Takes a batch, as the retriever calls it and as ``GPUVectorStore``'s
        does; each query merges as the reference's one-query version does
        (which raises on the card's children when the retriever passes it a
        batch)."""
        if len(embeddings) == 0:
            return []
        Q = np.asarray(embeddings, dtype=np.float32).reshape(len(embeddings), -1)
        with self._lock:
            snapshot = [(s.store, s.cold) for s in self._shards]
        k_shard = self.shard_k(top_k)
        per_shard = []
        for store, cold in snapshot:
            if store is not None:
                fallback = getattr(store, "search_fallback", None)
                per_shard.append(fallback(Q, k_shard) if fallback is not None
                                 else [store.search(q, k_shard) for q in Q])
            elif cold is not None:
                per_shard.append([self._cold_hits(cold, q, k_shard, None) for q in Q])
            else:
                per_shard.append([[] for _ in Q])
        out = []
        for qi in range(len(Q)):
            cands = [(hit.score, sidx, hit) for sidx, hits in enumerate(per_shard) for hit in hits[qi]]
            cands.sort(key=lambda t: -t[0])
            out.append([hit for _, _, hit in cands[: min(top_k, len(cands))]])
        return out

    # -- cold tier ---------------------------------------------------------

    def _update_ewmas(self, contributed: list[set[int]]) -> None:
        """Fold each query's shard-contribution bit into the per-shard hit
        EWMAs, then rebalance tiers against the hot budget."""
        if not contributed:
            return
        a = self.ewma_alpha
        with self._lock:
            for shard in self._shards:
                for hits in contributed:
                    x = 1.0 if shard.idx in hits else 0.0
                    shard.ewma = a * x + (1.0 - a) * shard.ewma
        self.rebalance()

    def rebalance(self) -> dict:
        """Enforce ``hot_shard_budget``: keep the highest-EWMA shards hot,
        demote the rest to host RAM.  A budget of 0 disables the cold tier.
        Hysteresis: a cold shard displaces a hot one only when its EWMA
        strictly exceeds the hot shard's, so ties never thrash."""
        if self.hot_shard_budget <= 0:
            return {"promoted": [], "demoted": []}
        promoted: list[int] = []
        demoted: list[int] = []
        with self._lock:
            hot = [s for s in self._shards if s.store is not None]
            cold = [s for s in self._shards if s.cold is not None]
            # Demote overflow beyond the budget, coldest first.
            hot.sort(key=lambda s: (s.ewma, -s.idx))
            while len(hot) > self.hot_shard_budget:
                victim = hot.pop(0)
                if self._demote_locked(victim):
                    demoted.append(victim.idx)
                    cold.append(victim)
            # Promote a cold shard that now out-scores the coldest hot one
            # (swapping, so the budget holds).
            cold.sort(key=lambda s: -s.ewma)
            for cand in cold:
                if cand.cold is None:
                    continue
                if len(hot) < self.hot_shard_budget:
                    self._promote_locked(cand)
                    promoted.append(cand.idx)
                    hot.append(cand)
                    continue
                coldest = min(hot, key=lambda s: (s.ewma, -s.idx))
                if cand.ewma > coldest.ewma:
                    self._promote_locked(cand)
                    promoted.append(cand.idx)
                    if self._demote_locked(coldest):
                        demoted.append(coldest.idx)
                        hot.remove(coldest)
                        hot.append(cand)
        return {"promoted": promoted, "demoted": demoted}

    def _demote_locked(self, shard: _Shard) -> bool:
        if shard.store is None:
            return False
        t0 = time.perf_counter()
        try:
            chunks, vecs = _extract_rows(shard.store)
        except TypeError:
            logger.warning("shard %d child %s cannot demote; staying hot", shard.idx, type(shard.store).__name__)
            return False
        shard.cold = ColdPartition.from_rows(chunks, vecs, pq_m=self.pq_m, seed=self.seed + shard.idx)
        # The child was the only holder of its device buffers: dropping it
        # frees them.
        shard.store = None
        with self._stats_lock:
            self._stats["coldtier_demotions_total"] += 1
            self._seconds["demote_s_total"] += time.perf_counter() - t0
        self._bump_version()
        self._notify_mutation("tier_swap", {"shard": shard.idx, "tier": "cold"})
        return True

    def _promote_locked(self, shard: _Shard) -> None:
        t0 = time.perf_counter()
        store = self._factory(shard.idx)
        if shard.cold is not None:
            chunks, vecs = shard.cold.live_rows()
            if len(chunks):
                store.add(chunks, vecs)
        shard.store = store
        shard.cold = None
        with self._stats_lock:
            self._stats["coldtier_promotions_total"] += 1
            self._seconds["promote_s_total"] += time.perf_counter() - t0
        self._bump_version()
        self._notify_mutation("tier_swap", {"shard": shard.idx, "tier": "hot"})

    def demote_shard(self, idx: int) -> bool:
        """Explicitly spill one shard to the host cold tier."""
        with self._lock:
            return self._demote_locked(self._shards[idx])

    def promote_shard(self, idx: int) -> None:
        """Explicitly rebuild one shard's hot child from its cold rows."""
        with self._lock:
            shard = self._shards[idx]
            if shard.store is None:
                self._promote_locked(shard)

    def shard_devices(self) -> list[str]:
        """Where each shard lives: its hot child's device (``cpu`` for a host
        store), or ``cold`` while demoted."""
        with self._lock:
            return [str(getattr(s.store, "device", "cpu")) if s.store is not None else "cold" for s in self._shards]

    def hot_shards(self) -> list[int]:
        with self._lock:
            return [s.idx for s in self._shards if s.store is not None]

    def cold_shards(self) -> list[int]:
        with self._lock:
            return [s.idx for s in self._shards if s.cold is not None]

    # -- replica hydration -------------------------------------------------

    def hydrate_replica(self, replica_idx: int, total_replicas: int) -> list[int]:
        """Shard-aware replica bootstrap: warm ONLY the partitions this
        replica serves (round-robin placement) instead of a full-corpus
        restore on every scale-up.  Hot shards get their device buffers
        synced (``GPUVectorStore._sync_device``); cold shards stay cold."""
        mine = self.shards_for_replica(replica_idx, total_replicas)
        warmed: list[int] = []
        with self._lock:
            for sidx in mine:
                store = self._shards[sidx].store
                if store is None:
                    continue
                sync = getattr(store, "_sync_device", None)
                if callable(sync):
                    try:
                        with getattr(store, "_lock", None) or contextlib.nullcontext():
                            sync()
                    except Exception:  # noqa: BLE001 — warm-up best effort
                        logger.exception("shard %d device sync failed during hydration", sidx)
                        continue
                warmed.append(sidx)
        with self._stats_lock:
            self._stats["replica_hydrations_total"] += 1
        logger.info("replica %d/%d hydrated shards %s (of %d)", replica_idx, total_replicas, warmed, self.num_shards)
        return warmed

    # -- capacity / metrics ------------------------------------------------

    def capacity_stats(self) -> dict:
        rows = bytes_ = tail = host_bytes = 0
        with self._lock:
            hot = cold = 0
            for shard in self._shards:
                if shard.store is not None:
                    hot += 1
                    s = shard.store.capacity_stats()
                    rows += int(s.get("rows", 0))
                    bytes_ += int(s.get("bytes", 0))
                    tail += int(s.get("tail_rows", 0))
                elif shard.cold is not None:
                    cold += 1
                    rows += shard.cold.rows()
                    host_bytes += shard.cold.host_bytes()
        return {"rows": rows, "bytes": bytes_, "tail_rows": tail, "host_bytes": host_bytes,
                "shards": self.num_shards, "hot_shards": hot, "cold_shards": cold}

    def scanned_bytes_split(self, top_k: int) -> dict:
        """Per-query scan traffic by tier: device bytes (hot shards' scans
        plus cold shards' prefetched rescore rows) vs host bytes (cold code
        scans)."""
        k_shard = self.shard_k(top_k)
        hbm = host = 0
        with self._lock:
            for shard in self._shards:
                if shard.store is not None:
                    fn = getattr(shard.store, "scanned_bytes_per_query", None)
                    if callable(fn):
                        hbm += int(fn(k_shard))
                    else:
                        hbm += len(shard.store) * self.dimensions * 4
                elif shard.cold is not None:
                    h, d = shard.cold.scan_bytes(k_shard, k_shard * self.rescore_multiplier)
                    host += h
                    hbm += d
        return {"hbm": hbm, "host": host}

    def scanned_bytes_per_query(self, top_k: int) -> int:
        split = self.scanned_bytes_split(top_k)
        return split["hbm"] + split["host"]

    def fanout_stats(self) -> dict:
        """Aggregated per-shard micro-batcher counters."""
        agg = {"requests_total": 0, "batches_total": 0, "batch_size_sum": 0, "errors_total": 0}
        for b in self._batchers:
            snap = b.stats.snapshot()
            for key in agg:
                agg[key] += snap.get(key, 0)
        return agg

    def stats_snapshot(self) -> dict:
        with self._stats_lock:
            snap = dict(self._stats)
        snap.update(self.fanout_stats())
        snap["prefetches_total"] = self.prefetcher.prefetches_total
        snap["prefetch_bytes_total"] = self.prefetcher.prefetch_bytes_total
        return snap

    def swap_stats(self) -> dict:
        """Tier swaps (counts and host seconds, inline ones included) and
        the gather's merge seconds."""
        with self._stats_lock:
            return {"demotions": self._stats["coldtier_demotions_total"],
                    "promotions": self._stats["coldtier_promotions_total"], **self._seconds}

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist every shard as compacted host rows (the reference's
        format: ``fabric_meta.json`` and ``shard_{i}/`` memory-store
        snapshots), so ``load`` can rebuild with any child backend."""
        os.makedirs(path, exist_ok=True)
        with self._lock:
            meta = {
                "dimensions": self.dimensions,
                "num_shards": self.num_shards,
                "rescore_multiplier": self.rescore_multiplier,
                "margin": self.margin,
                "hot_shard_budget": self.hot_shard_budget,
                "pq_m": self.pq_m,
                "version": self.version(),
                "cold": self.cold_shards(),
            }
            for shard in self._shards:
                if shard.store is not None:
                    chunks, vecs = _extract_rows(shard.store)
                elif shard.cold is not None:
                    chunks, vecs = shard.cold.live_rows()
                else:
                    chunks, vecs = [], np.zeros((0, self.dimensions), dtype=np.float32)
                sub = MemoryVectorStore(self.dimensions)
                if len(chunks):
                    sub.add(chunks, vecs)
                sub.save(os.path.join(path, f"shard_{shard.idx}"))
        with open(os.path.join(path, "fabric_meta.json"), "w", encoding="utf-8") as fh:
            json.dump(meta, fh)

    @classmethod
    def load(
        cls, path: str, *, shard_factory: Optional[Callable[[int], VectorStore]] = None, **kwargs
    ) -> "ShardedVectorStore":
        with open(os.path.join(path, "fabric_meta.json"), "r", encoding="utf-8") as fh:
            meta = json.load(fh)
        store = cls(
            meta["dimensions"],
            num_shards=meta["num_shards"],
            shard_factory=shard_factory,
            rescore_multiplier=meta.get("rescore_multiplier", 4),
            margin=meta.get("margin", 8),
            hot_shard_budget=meta.get("hot_shard_budget", 0),
            pq_m=meta.get("pq_m", 16),
            **kwargs,
        )
        with store._lock:
            for shard in store._shards:
                sub = MemoryVectorStore.load(os.path.join(path, f"shard_{shard.idx}"))
                if len(sub):
                    shard.store.add(sub._chunks, np.asarray(sub._vecs, dtype=np.float32))
            for sidx in meta.get("cold", []):
                store._demote_locked(store._shards[sidx])
        store._restore_version(meta.get("version", 0))
        return store

    def load_like(self, path: str) -> "ShardedVectorStore":
        """A snapshot loaded as this fabric is configured: its shard factory
        (the configured child backend on its device), device, fan-out
        batching, EWMA rate, seed and name.  The snapshot's meta supplies
        the rest."""
        return type(self).load(
            path, shard_factory=self._factory, device=self.device, fanout_max_batch=self.fanout_max_batch,
            fanout_wait_ms=self.fanout_wait_ms, ewma_alpha=self.ewma_alpha, seed=self.seed, name=self.name,
        )

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Stop the fan-out batcher workers (idempotent)."""
        if self._closed:
            return
        self._closed = True
        for b in self._batchers:
            try:
                b.close(timeout=timeout)
            except Exception:  # noqa: BLE001 — shutdown best effort
                pass
