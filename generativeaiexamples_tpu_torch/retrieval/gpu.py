"""Exact vector search on the card: the corpus as one padded buffer in
device memory, scored against the queries by one product and reduced with
``torch.topk`` (port of the default path of ``retrieval/tpu.py``'s
``TPUVectorStore``: no quantization, one device, no mesh).

Design points, the reference's:
  * **Padded power-of-two capacity**: the main buffer grows by doubling.
  * **Incremental sync**: rows added after a build land in a small padded
    *tail* buffer (1,024 to 8,192 rows); the main buffer stays as it is
    until the tail or the capacity overflows, which rebuilds it from the
    host mirror.  Every write is copy-on-write: a search snapshots the
    device tensors under the store's lock and runs outside it, so a write
    makes new tensors and never changes one a running search holds.
  * **Masked deletes**: deleting a source clears rows in the host validity
    mask; only the masks re-upload (scores pinned to -inf), never the rows.
  * **Scores are f32**: bf16 operands multiply with f32 accumulation and an
    f32 result, as the reference's ``preferred_element_type=float32``
    (``torch.mm(..., out_dtype=float32)`` on the card; on the CPU both
    operands go to f32, where products of bf16 values are exact).  A
    float32 store pins the float32 matmul precision to "highest", so it
    never runs in TF32.
  * **Ties**: equal scores rank the lower row first, as ``lax.top_k`` does;
    ``torch.topk`` promises no order among them, so the selection is fixed
    on the host from the top ``k + 1``.
  * **Persistence**: ``save``/``load`` write and read the JAX store's format
    (``vectors.npz``, ``chunks.json``, ``tpu_meta.json``), so a snapshot of
    either package loads into the other.

  * **Host fallback**: ``search_fallback`` (the resilience ladder's
    ``index_fallback`` rung) scans the host mirror with no device work.
    It scores the values the device holds (rows and queries rounded to the
    store's dtype, as the upload rounds them, with f32 sums), so its ranks
    and scores are the device search's within f32 summation error; the
    reference scores the f32 mirror even for a bf16 store.

Not ported yet (``ROADMAP.md``, Queue 1 item 4): the int8 / PQ two-stage
scan, the IVF store and the mesh-sharded path; the constructor raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk, VectorStore
from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore
from generativeaiexamples_tpu_torch.utils.buckets import bucket_size

logger = get_logger(__name__)

_MIN_CAPACITY = 1024
# Tail floor and ceiling: the tail scales with the main capacity (cap / 8)
# so compactions stay amortized, and its copy-on-write append costs at
# most a copy of 8,192 rows.
_MIN_TAIL = 1024
_MAX_TAIL = 8192
# A rebuild uploads the f32 host mirror in blocks of this many rows, cast
# to the store's dtype on the device: no second host copy of the corpus.
_UPLOAD_ROWS = 65536

_QUANT_MODES = ("none", "int8", "pq")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Keys only the reference's IVF store persists in ``tpu_meta.json``.
_IVF_META_KEYS = ("nlist", "nprobe", "kmeans_iters", "min_train_size", "retrain_growth", "last_train_live")
# ``tpu_meta.json`` of an exact store: the reference's defaults for the
# compressed-scan knobs, which an exact store does not use.
_EXACT_META = {"quantization": "none", "pq_m": 16, "rescore_multiplier": 4, "recall_target": 0.95}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch store yet (ROADMAP.md, Queue 1 item 4)")


def _bucket_queries(Q: np.ndarray, maximum: Optional[int] = None) -> np.ndarray:
    """Zero-pad a query batch up to a power-of-two row bucket (at least 4);
    only the real rows are collected."""
    qb = bucket_size(len(Q), minimum=4, maximum=maximum)
    if qb == len(Q):
        return Q
    padded = np.zeros((qb, Q.shape[1]), dtype=Q.dtype)
    padded[: len(Q)] = Q
    return padded


def _capacity_for(n: int) -> int:
    cap = _MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


def scores_f32(Q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(b, n) f32 inner products of Q (b, d) with rows (n, d), both in the
    store's dtype: f32 accumulation and an f32 result, never rounded to
    bf16."""
    if rows.device.type == "cuda":
        if rows.dtype == torch.float32:
            torch.set_float32_matmul_precision("highest")
            return Q @ rows.t()
        return torch.mm(Q, rows.t(), out_dtype=torch.float32)
    return Q.float() @ rows.float().t()


def _top_rows(scores: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Each row's top ``k`` of ``scores`` (b, n), best first, equal scores by
    lower position (``lax.top_k``'s order): host (values, positions).

    ``torch.topk`` may order equal scores either way and, where the k-th
    and (k+1)-th scores are equal, may select any of them; such a row takes
    its lowest positions at the k-th score from the full row."""
    kk = min(k + 1, scores.shape[1])
    vals, pos = torch.topk(scores, kk, dim=1)
    vals, pos = vals.cpu().numpy(), pos.cpu().numpy()
    out_v, out_p = vals[:, :k].copy(), pos[:, :k].copy()
    if kk > k:
        for r in np.nonzero((vals[:, k - 1] == vals[:, k]) & np.isfinite(vals[:, k]))[0]:
            t = vals[r, k - 1]
            above = vals[r, :k] > t
            n_eq = k - int(above.sum())
            eq = torch.nonzero(scores[r] == t).flatten()[:n_eq].cpu().numpy()
            out_p[r] = np.concatenate([pos[r, :k][above], eq])
            out_v[r] = np.concatenate([vals[r, :k][above], np.full(n_eq, t, vals.dtype)])
    order = np.lexsort((out_p, -out_v), axis=-1)
    return np.take_along_axis(out_v, order, 1), np.take_along_axis(out_p, order, 1)


class GPUVectorStore(VectorStore):
    """Exact inner-product top-k on the card over a padded corpus buffer
    (counterpart of the reference's ``TPUVectorStore``).  Runs on ``cuda``
    unless ``device="cpu"`` is passed."""

    def __init__(
        self,
        dimensions: int,
        *,
        dtype: str = "bfloat16",
        device=None,
        mesh=None,
        max_query_batch: int = 128,
        incremental: bool = True,
        index_type: str = "exact",
        quantization: str = "none",
    ) -> None:
        if quantization not in _QUANT_MODES:
            raise ValueError(f"quantization={quantization!r} not in {_QUANT_MODES}")
        if quantization != "none":
            raise _not_ported(f"quantization={quantization!r} (the two-stage compressed scan)")
        if index_type != "exact":
            raise _not_ported(f"index_type={index_type!r} (the IVF store)")
        if mesh is not None:
            raise _not_ported("the mesh-sharded store")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype={dtype!r} not in {tuple(_DTYPES)}")
        self.dimensions = dimensions
        self.device = resolve_device(device)
        self._dtype = _DTYPES[dtype]
        # Batches larger than this split into chunks of it.
        self.max_query_batch = max(1, int(max_query_batch))
        self._incremental = bool(incremental)
        # Guards the host mirror and the device-tensor references.
        self._lock = threading.RLock()
        # Host mirror: exact f32 vectors and payloads; the device buffer is
        # the scoring copy in the store's dtype.
        self._mirror = MemoryVectorStore(dimensions)
        self._valid = np.zeros((0,), dtype=bool)
        self._device_buf: Optional[torch.Tensor] = None  # (cap, d): mirror rows [0, _base)
        self._device_valid: Optional[torch.Tensor] = None  # (cap,) bool
        self._tail_buf: Optional[torch.Tensor] = None  # (tail_cap, d): mirror rows [_base, _synced)
        self._tail_valid: Optional[torch.Tensor] = None  # (tail_cap,) bool
        self._base = 0  # rows compacted into the main buffer
        self._synced = 0  # rows present on the device (main + tail)
        self._dirty = True
        self._mask_dirty = False

    # -- mutation ----------------------------------------------------------

    def _validate_add(self, chunks: Sequence[Chunk], embeddings) -> Optional[np.ndarray]:
        """A chunks/embeddings mismatch fails here, before any state changes."""
        if len(chunks) != len(embeddings):
            raise ValueError(
                f"add(): got {len(chunks)} chunks but {len(embeddings)} embeddings — one embedding per chunk required"
            )
        if not chunks:
            return None
        try:
            mat = np.asarray(embeddings, dtype=np.float32)
        except ValueError as exc:
            raise ValueError(f"add(): embeddings are ragged or non-numeric ({exc})") from None
        if mat.shape != (len(chunks), self.dimensions):
            raise ValueError(
                f"add(): embeddings shape {mat.shape} != ({len(chunks)}, {self.dimensions}) — wrong embedder "
                "dimensionality for this store?"
            )
        return mat

    def add(self, chunks: Sequence[Chunk], embeddings: Sequence[Sequence[float]]) -> list[str]:
        mat = self._validate_add(chunks, embeddings)
        if mat is None:
            return []
        with self._lock:
            ids = self._mirror.add(chunks, mat)
            self._valid = np.concatenate([self._valid, np.ones(len(chunks), dtype=bool)])
            self._dirty = True
            self._bump_version()
        return ids

    def delete_source(self, source: str) -> int:
        """Masked delete: the rows stay, invalidated; only the validity masks
        re-upload on the next sync."""
        removed = 0
        with self._lock:
            for i, c in enumerate(self._mirror._chunks):
                if c.source == source and self._valid[i]:
                    self._valid[i] = False
                    removed += 1
            if removed:
                self._dirty = True
                self._mask_dirty = True
                self._bump_version()
        return removed

    # -- device sync -------------------------------------------------------

    def _tail_cap_for(self, cap: int) -> int:
        # A non-incremental store keeps a minimal dummy tail, so every
        # search has the same two parts.
        if not self._incremental:
            return 8
        return min(max(_MIN_TAIL, cap // 8), _MAX_TAIL)

    def _upload(self, rows: np.ndarray, out: torch.Tensor) -> None:
        """Copy f32 host rows into ``out`` (rounded to nearest even on the
        device, as ``jnp.asarray(..., bfloat16)``), in blocks."""
        for lo in range(0, len(rows), _UPLOAD_ROWS):
            block = np.ascontiguousarray(rows[lo : lo + _UPLOAD_ROWS], dtype=np.float32)
            out[lo : lo + len(block)].copy_(torch.from_numpy(block).to(self.device))

    def _mask(self, mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(mask).to(self.device)

    def _rebuild_full(self) -> None:
        """O(corpus) compaction: a new main buffer from the mirror and an
        empty tail.  Runs on first sync, capacity or tail overflow, and on
        every sync of a non-incremental store."""
        n = len(self._mirror._chunks)
        cap = _capacity_for(max(n, 1))
        buf = torch.zeros((cap, self.dimensions), dtype=self._dtype, device=self.device)
        self._upload(self._mirror._vecs[:n], buf)
        valid = np.zeros((cap,), dtype=bool)
        valid[:n] = self._valid
        self._device_buf = buf
        self._device_valid = self._mask(valid)
        tail_cap = self._tail_cap_for(cap)
        self._tail_buf = torch.zeros((tail_cap, self.dimensions), dtype=self._dtype, device=self.device)
        self._tail_valid = torch.zeros((tail_cap,), dtype=torch.bool, device=self.device)
        self._base = n
        self._synced = n
        self._mask_dirty = False
        logger.debug("gpu store compacted: %d rows, capacity %d", n, cap)

    def _tail_mask(self, upto: int) -> torch.Tensor:
        tmask = np.zeros((int(self._tail_buf.shape[0]),), dtype=bool)
        tmask[: upto - self._base] = self._valid[self._base : upto]
        return self._mask(tmask)

    def _append_tail(self, n: int) -> None:
        """Sync mirror rows [_synced, n) into a copy of the tail: O(tail),
        never O(corpus).  The rows past n stay zero, as in the reference's
        padded writes."""
        tail = self._tail_buf.clone()
        self._upload(self._mirror._vecs[self._synced : n], tail[self._synced - self._base : n - self._base])
        self._tail_buf = tail
        self._synced = n
        self._tail_valid = self._tail_mask(n)

    def _upload_masks(self) -> None:
        valid = np.zeros((int(self._device_buf.shape[0]),), dtype=bool)
        valid[: self._base] = self._valid[: self._base]
        self._device_valid = self._mask(valid)
        self._tail_valid = self._tail_mask(self._synced)
        self._mask_dirty = False

    def _sync_device(self) -> None:
        """Bring the device copy up to date with the host mirror: appends
        through the tail, deletes by the masks, and a full rebuild only when
        the main capacity or the tail overflows."""
        n = len(self._mirror._chunks)
        if (
            self._device_buf is None
            or not self._incremental
            or _capacity_for(max(n, 1)) > int(self._device_buf.shape[0])
            or (n - self._base) > int(self._tail_buf.shape[0])
        ):
            self._rebuild_full()
        else:
            if n > self._synced:
                self._append_tail(n)
            if self._mask_dirty:
                self._upload_masks()
        self._dirty = False

    # -- search ------------------------------------------------------------

    def _snapshot(self):
        """Device tensors for a search; call under the lock after a sync."""
        return self._device_buf, self._device_valid, self._tail_buf, self._tail_valid, self._base

    def _prepared(self) -> Optional[tuple]:
        """Sync if needed and snapshot, or None for an empty store."""
        with self._lock:
            if int(self._valid.sum()) == 0:
                return None
            if self._dirty:
                self._sync_device()
            return self._snapshot()

    @staticmethod
    def scan(snap, Q: torch.Tensor) -> list[torch.Tensor]:
        """The device work of one search's scoring, with no host sync: the
        masked f32 scores of the main buffer and of the tail against Q
        (b, d) on the device."""
        buf, valid, tail, tvalid, _ = snap
        Qc = Q.to(buf.dtype)
        return [
            scores_f32(Qc, rows).masked_fill_(~mask[None, :], float("-inf"))
            for rows, mask in ((buf, valid), (tail, tvalid))
        ]

    @staticmethod
    def select(snap, parts: list[torch.Tensor], k: int, m: int) -> tuple[np.ndarray, np.ndarray]:
        """Top ``k`` (values, row ids) of the first ``m`` queries over both
        parts, in ``lax.top_k``'s order: tail slot s holds mirror row
        base + s, after every live main row."""
        base = snap[4]
        vals, ids = [], []
        for scores, offset in zip(parts, (0, base)):
            v, p = _top_rows(scores[:m], min(k, scores.shape[1]))
            vals.append(v)
            ids.append(p + offset)
        v, i = np.concatenate(vals, 1), np.concatenate(ids, 1)
        order = np.lexsort((i, -v), axis=-1)[:, :k]
        return np.take_along_axis(v, order, 1), np.take_along_axis(i, order, 1)

    def _search_rows(self, snap, Q: np.ndarray, m: int, k: int) -> list[list[ScoredChunk]]:
        parts = self.scan(snap, torch.from_numpy(Q).to(self.device))
        scores, ids = self.select(snap, parts, k, m)
        return [self._collect(scores[b], ids[b], k) for b in range(m)]

    def search(self, embedding: Sequence[float], top_k: int) -> list[ScoredChunk]:
        snap = self._prepared() if top_k > 0 else None
        if snap is None:
            return []
        k = min(top_k, int(snap[0].shape[0]) + int(snap[2].shape[0]))
        return self._search_rows(snap, np.asarray(embedding, dtype=np.float32)[None, :], 1, k)[0]

    def search_batch(self, embeddings: Sequence[Sequence[float]], top_k: int) -> list[list[ScoredChunk]]:
        if len(embeddings) == 0:
            return []
        snap = self._prepared() if top_k > 0 else None
        if snap is None:
            return [[] for _ in embeddings]
        k = min(top_k, int(snap[0].shape[0]) + int(snap[2].shape[0]))
        # Batches beyond max_query_batch split into chunks; each chunk pads
        # to a power-of-two bucket and only its real rows are collected.
        Q_all = np.asarray(embeddings, dtype=np.float32)
        out: list[list[ScoredChunk]] = []
        for lo in range(0, len(Q_all), self.max_query_batch):
            m = min(self.max_query_batch, len(Q_all) - lo)
            Q = _bucket_queries(Q_all[lo : lo + m], maximum=self.max_query_batch)
            out.extend(self._search_rows(snap, Q, m, k))
        return out

    def _host_rows(self, rows: np.ndarray) -> np.ndarray:
        """f32 host rows holding the values the device scores: rounded to
        nearest even in the store's dtype, as ``_upload`` rounds them."""
        if self._dtype == torch.float32:
            return rows
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self._dtype).float().numpy()

    def search_fallback(self, embeddings: Sequence[Sequence[float]], top_k: int) -> list[list[ScoredChunk]]:
        """Device-free exact scan over the host mirror (the resilience
        ladder's ``index_fallback`` rung, reference ``retrieval/tpu.py``
        ``search_fallback``): the device's values scored on the host in
        blocks, invalidated rows masked, ranks in ``lax.top_k``'s order."""
        if len(embeddings) == 0:
            return []
        with self._lock:
            # add() replaces the mirror's array and delete_source() writes
            # the mask in place, so the mask is copied and the rows are not.
            vecs = self._mirror._vecs
            chunks = list(self._mirror._chunks)
            valid = self._valid.copy()
        live = int(valid.sum())
        if live == 0 or top_k <= 0:
            return [[] for _ in embeddings]
        Q = self._host_rows(np.asarray(embeddings, dtype=np.float32))
        scores = np.empty((len(Q), len(vecs)), dtype=np.float32)
        for lo in range(0, len(vecs), _UPLOAD_ROWS):
            scores[:, lo : lo + _UPLOAD_ROWS] = Q @ self._host_rows(vecs[lo : lo + _UPLOAD_ROWS]).T
        scores[:, ~valid] = -np.inf
        k = min(top_k, live)
        out: list[list[ScoredChunk]] = []
        for row in scores:
            idx = np.argpartition(-row, k - 1)[:k]
            idx = idx[np.lexsort((idx, -row[idx]))]
            out.append([ScoredChunk(chunks[int(i)], float(row[i])) for i in idx if np.isfinite(row[i])])
        return out

    def _collect(self, scores, ids, top_k: int) -> list[ScoredChunk]:
        """Drop -inf (masked or padded) rows and map ids to mirror chunks."""
        out: list[ScoredChunk] = []
        for s, i in zip(scores, ids):
            if not np.isfinite(s):
                continue
            out.append(ScoredChunk(self._mirror._chunks[int(i)], float(s)))
            if len(out) >= top_k:
                break
        return out

    # -- bookkeeping -------------------------------------------------------

    def sources(self) -> list[str]:
        seen: dict[str, None] = {}
        with self._lock:
            for i, c in enumerate(self._mirror._chunks):
                if self._valid[i]:
                    seen.setdefault(c.source)
        return list(seen)

    def __len__(self) -> int:
        return int(self._valid.sum())

    def _device_tensors(self) -> list[torch.Tensor]:
        """Every device tensor the store holds; call under the lock."""
        return [t for t in (self._device_buf, self._device_valid, self._tail_buf, self._tail_valid) if t is not None]

    def capacity_stats(self) -> dict:
        """Live rows, device bytes of every buffer and mask, staged tail rows."""
        with self._lock:
            return {
                "rows": int(self._valid.sum()),
                "bytes": sum(t.numel() * t.element_size() for t in self._device_tensors()),
                "tail_rows": max(self._synced - self._base, 0),
            }

    def scanned_bytes_per_query(self, top_k: int) -> int:
        """Device bytes one query's search reads: the main buffer, the tail
        and its mask, and the main mask."""
        with self._lock:
            if self._device_buf is None:
                if self._dirty and int(self._valid.sum()):
                    self._sync_device()
                else:
                    return 0
            cap = int(self._device_buf.shape[0])
            tail_bytes = self._tail_buf.numel() * self._tail_buf.element_size() + self._tail_valid.numel()
            return cap * self.dimensions * self._device_buf.element_size() + tail_bytes + cap

    def save(self, path: str) -> None:
        """Compact (drop invalidated rows) and write the JAX store's format."""
        with self._lock:
            compact = MemoryVectorStore(self.dimensions)
            live = [i for i in range(len(self._mirror._chunks)) if self._valid[i]]
            compact.add([self._mirror._chunks[i] for i in live], self._mirror._vecs[live].tolist() if live else [])
            compact._restore_version(self.version())
        compact.save(path)
        with open(os.path.join(path, "tpu_meta.json"), "w", encoding="utf-8") as fh:
            json.dump(_EXACT_META, fh)

    @staticmethod
    def _load_meta(path: str) -> dict:
        meta_path = os.path.join(path, "tpu_meta.json")
        if not os.path.exists(meta_path):
            return {}  # legacy snapshot: defaults + kwargs apply
        try:
            with open(meta_path, "r", encoding="utf-8") as fh:
                return dict(json.load(fh))
        except (OSError, ValueError):
            return {}

    @classmethod
    def load(cls, path: str, **kwargs) -> "GPUVectorStore":
        mirror = MemoryVectorStore.load(path)
        meta = cls._load_meta(path)
        if any(key in meta for key in _IVF_META_KEYS):
            kwargs["index_type"] = "ivf"
        kwargs.setdefault("quantization", meta.get("quantization", "none"))
        store = cls(mirror.dimensions, **kwargs)
        store._mirror = mirror
        store._valid = np.ones((len(mirror._chunks),), dtype=bool)
        store._dirty = True
        store._restore_version(mirror.version())
        return store
