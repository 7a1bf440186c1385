"""Vector search on the card (port of ``retrieval/tpu.py``'s
``TPUVectorStore`` and ``TPUIVFVectorStore``, one device, no mesh).

The exact store is the corpus as one padded buffer in device memory, scored
against the queries by one product and reduced with ``torch.topk``.  Design
points, the reference's:
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
    operands go to f32, where products of bf16 values are exact).  Every
    f32 product on the card (a float32 store's scan, k-means, probing, the
    PQ lookup table) runs at "highest" precision for the call only
    (``full_f32``), never in TF32.
  * **Ties**: equal scores rank the lower position first, as ``lax.top_k``
    does; ``torch.topk`` promises no order among them, so the selection is
    fixed on the host from the top ``k + 1``.
  * **Persistence**: ``save``/``load`` write and read the JAX store's format
    (``vectors.npz``, ``chunks.json``, ``tpu_meta.json``, and an IVF
    store's ``ivf_index.npz``), so a snapshot of either package loads into
    the other.
  * **Host fallback**: ``search_fallback`` (the resilience ladder's
    ``index_fallback`` rung) scans the host mirror with no device work.
    It scores the values the device holds (rows and queries rounded to the
    store's dtype, as the upload rounds them, with f32 sums), so its ranks
    and scores are the device search's within f32 summation error; the
    reference scores the f32 mirror even for a bf16 store.

**Compressed scoring** (``quantization='int8'|'pq'``): both stores can scan
a compressed copy of the main corpus instead of the full-width buffer.
``int8`` keeps per-row symmetric codes and f32 scales (1 byte a dim; the
scale multiplies the score after the product), quantized from the f32
mirror as the reference's ``_int8_rows`` does, bit for bit.  ``pq`` keeps
``pq_m`` one-byte codes a row against 256-centroid codebooks per subspace,
trained by L2 k-means on the device and encoded on the host with the
reference's numpy ``_pq_encode``; a query batch scores them through one
(b, pq_m, 256) lookup table.  Search is two-stage: stage one selects
``top_k * rescore_multiplier`` candidates from the compressed scores (delete
masks apply there), stage two gathers those rows from the full-width buffer
and rescores them exactly; the append tail stays full-width and joins the
final top-k directly.  Stage one is an exact ``torch.topk``: the reference
uses ``jax.lax.approx_max_k``, which torch lacks (on the CPU, JAX's
``approx_max_k`` returns ``lax.top_k``'s answer); ``recall_target`` is kept,
validated and persisted.  Stores of at most ``top_k * rescore_multiplier``
main rows skip stage one (exact ``top_k``).

**IVF** (``GPUIVFVectorStore``): the Milvus GPU_IVF_FLAT shape (nlist 64,
nprobe 16).  Inverted lists are padded buckets, a (nlist, cap, d) buffer and
a mask; a query probes its ``nprobe`` nearest centroids (f32 inner product)
and scores only those lists.  Rows appended after a build are assigned to the
frozen centroids on the host and searched exactly from a flat tail until a
fold moves them into the buckets; a k-means retrain runs past a growth
threshold or on bucket overflow.  Folds and retrains run on a background
thread against a snapshot and swap in atomically under the store's lock;
searches keep serving the old index meanwhile (on the same CUDA stream: a
search issued while a build runs queues behind its launches).  The buckets
are built on the device from f32 row blocks; the host keeps only the masks,
the ids and the row-to-list layout.  The bucket ids live on the host, so an
indexed IVF store holds nlist x cap x 4 bytes less on the device than the
reference (``capacity_stats``).

k-means initial centroids come from numpy's ``default_rng`` keyed as the
reference keys ``jax.random`` (the seed for IVF lists, ``seed * 1_000_003 +
m`` for PQ subspace m), so a retrain gives other centroids than the
reference's; a persisted index (``ivf_index.npz``) loads as it was built.

Not ported (``ROADMAP.md``, Queue 1 item 10b-iii): the mesh-sharded store; the
constructor raises ``NotImplementedError`` for it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Sequence

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
# The int8 scan casts its codes to the store's dtype in blocks of as many.
_UPLOAD_ROWS = 65536

_QUANT_MODES = ("none", "int8", "pq")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Keys only the reference's IVF store persists in ``tpu_meta.json``.
_IVF_META_KEYS = ("nlist", "nprobe", "kmeans_iters", "min_train_size", "retrain_growth", "last_train_live")

_PQ_CENTROIDS = 256  # one uint8 code per subspace
_PQ_KMEANS_ITERS = 8
# Codebook training subsample cap: k-means quality saturates long before
# the corpus does.
_PQ_TRAIN_MAX = 32768
# Below this many live rows a 256-centroid codebook is meaningless.
_PQ_MIN_TRAIN = 256
_PQ_ENCODE_CHUNK = 65536
# The int8 scale of an all-zero row, as ``_int8_rows`` computes it.
_INT8_PAD_SCALE = float((np.maximum(np.zeros(1, np.float32), 1e-12) / 127.0).astype(np.float32)[0])
# Device bytes an IVF query chunk may gather (the reference's budget).
_IVF_CHUNK_BYTES = 1 << 31


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch store yet (ROADMAP.md, Queue 1 item 10b-iii)")


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
    return _pow2_at_least(n, _MIN_CAPACITY)


def _pow2_at_least(n: int, floor: int) -> int:
    cap = floor
    while cap < n:
        cap *= 2
    return cap


class _Float32Scope:
    """Full f32 products on the card for the duration of a call: the
    process's float32 matmul precision is "highest" while any caller is
    inside, and goes back to what it was when the last one leaves (other
    threads' calls, a TF32 BERT say, run at "highest" meanwhile)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._users = 0
        self._saved = "highest"

    @contextlib.contextmanager
    def __call__(self, device: torch.device):
        if device.type != "cuda":
            yield
            return
        with self._lock:
            if self._users == 0:
                self._saved = torch.get_float32_matmul_precision()
                torch.set_float32_matmul_precision("highest")
            self._users += 1
        try:
            yield
        finally:
            with self._lock:
                self._users -= 1
                if self._users == 0:
                    torch.set_float32_matmul_precision(self._saved)


full_f32 = _Float32Scope()


def scores_f32(Q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(b, n) f32 inner products of Q (b, d) with rows (n, d), both in the
    store's dtype: f32 accumulation and an f32 result, never rounded to
    bf16 and never in TF32."""
    if rows.device.type == "cuda":
        if rows.dtype == torch.float32:
            with full_f32(rows.device):
                return Q @ rows.t()
        return torch.mm(Q, rows.t(), out_dtype=torch.float32)
    return Q.float() @ rows.float().t()


def _rescore(rows: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """(b, k) f32 inner products of gathered rows (b, k, d) with Q (b, d),
    both in the store's dtype: f32 products (exact for bf16 operands)
    summed in f32."""
    return (rows.float() * Q.float()[:, None, :]).sum(-1)


def _rescored(rows: torch.Tensor, Q: torch.Tensor, cs: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Stage two: the exact scores of the gathered candidate rows (b, k2, d)
    (-inf where stage one's was), top ``k`` with ties by stage-one rank:
    host (values, ranks)."""
    exact = _rescore(rows, Q)
    exact[torch.from_numpy(~np.isfinite(cs)).to(exact.device)] = float("-inf")
    return _top_rows(exact, k)


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


def _merge(parts: list[tuple[np.ndarray, np.ndarray, np.ndarray]], k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top ``k`` (values, ids) over parts of (values, keys, ids), each (b, *):
    best score first, equal scores by lower key (a candidate's position in
    the reference's concatenation)."""
    v = np.concatenate([p[0] for p in parts], 1)
    key = np.concatenate([p[1] for p in parts], 1)
    ids = np.concatenate([p[2] for p in parts], 1)
    order = np.lexsort((key, -v), axis=-1)[:, :k]
    return np.take_along_axis(v, order, 1), np.take_along_axis(ids, order, 1)


# -- compressed-scoring helpers (numpy: bit for bit the reference's) ---------


def _int8_rows(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8: codes + f32 scales (``score = (codes . q) *
    scale``).  All-zero rows get the epsilon scale and zero codes."""
    amax = np.abs(mat).max(axis=1)
    scale = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    codes = np.clip(np.round(mat / scale[:, None]), -127, 127).astype(np.int8)
    return codes, scale


def _int8_rows_t(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_int8_rows`` of f32 rows (n, d) on their device, bit for bit: the
    divisions are tensor by tensor (IEEE; CUDA turns a division by a
    Python scalar into a product by its reciprocal) and ``torch.round``
    rounds half to even, as ``np.round``."""
    amax = rows.abs().amax(dim=1)
    scale = amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)
    codes = torch.round(rows / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return codes, scale


def _pq_encode(vecs: np.ndarray, codebooks: np.ndarray, rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Nearest-centroid codes (n, pq_m) uint8 of ``vecs`` (or of
    ``vecs[rows]``) against frozen codebooks, host numpy in row chunks: the
    reference's arithmetic chunk by chunk, with the chunks spread over
    threads (numpy releases the interpreter lock in the products, the sums
    and the argmins)."""
    pq_m, _, dsub = codebooks.shape
    n = len(vecs) if rows is None else len(rows)
    codes = np.empty((n, pq_m), dtype=np.uint8)
    c2 = (codebooks.astype(np.float32) ** 2).sum(axis=2)  # (pq_m, 256)

    def encode(lo: int) -> None:
        block = vecs[lo : lo + _PQ_ENCODE_CHUNK] if rows is None else vecs[rows[lo : lo + _PQ_ENCODE_CHUNK]]
        chunk = np.asarray(block, dtype=np.float32).reshape(-1, pq_m, dsub)
        d2 = np.empty((len(chunk), codebooks.shape[1]), dtype=np.float32)
        for m in range(pq_m):
            # The reference's c2 - 2.0 * (x @ c.T) in one buffer: -2.0 * dot
            # is exact, and c2 + (-2 dot) rounds as c2 - 2 dot does.
            np.matmul(chunk[:, m, :], codebooks[m].T, out=d2)
            d2 *= -2.0
            d2 += c2[m]
            codes[lo : lo + len(chunk), m] = d2.argmin(axis=1)

    starts = range(0, n, _PQ_ENCODE_CHUNK)
    with ThreadPoolExecutor(max_workers=max(1, min(len(starts), os.cpu_count() or 1, 8))) as pool:
        list(pool.map(encode, starts))
    return codes


def _pq_zero_code(codebooks: np.ndarray) -> np.ndarray:
    """``_pq_encode``'s codes (pq_m,) for an all-zero row (padding): the
    product term is exactly zero, so the code is each subspace's smallest
    centroid norm."""
    c2 = (codebooks.astype(np.float32) ** 2).sum(axis=2)
    return np.argmin(c2, axis=1).astype(np.uint8)


def _init_rows(n: int, k: int, key: int) -> np.ndarray:
    """Rows that seed a k-means: ``k`` of ``n`` drawn by numpy keyed by
    ``key`` (the reference draws them with ``jax.random.choice`` under a
    ``PRNGKey`` of the same integer)."""
    return np.random.default_rng(key).choice(n, k, replace=n < k)


def _lloyd_l2(sub: torch.Tensor, centroids: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd's L2 k-means of one PQ subspace (n, dsub) from the given
    initial centroids, f32: argmin ||x - c||^2 = argmin ||c||^2 - 2 x.c.
    Empty clusters keep their centroid."""
    k = centroids.shape[0]
    with full_f32(sub.device):
        for _ in range(iters):
            d2 = (centroids**2).sum(dim=1)[None, :] - 2.0 * (sub @ centroids.t())
            one_hot = torch.nn.functional.one_hot(d2.argmin(dim=1), k).float()
            sums = one_hot.t() @ sub
            counts = one_hot.sum(dim=0)[:, None]
            centroids = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
    return centroids


def _lloyd_ip(vecs: torch.Tensor, centroids: torch.Tensor, iters: int, n_valid: Optional[int] = None) -> torch.Tensor:
    """Max-inner-product Lloyd (the IVF lists) over f32 rows (n, d) from the
    given initial centroids: assign by argmax of the inner product, plain
    means.  Rows from ``n_valid`` on weigh nothing; empty lists keep their
    centroid."""
    n, k = vecs.shape[0], centroids.shape[0]
    weight = (torch.arange(n, device=vecs.device) < n_valid).float()[:, None] if n_valid is not None else None
    with full_f32(vecs.device):
        for _ in range(iters):
            one_hot = torch.nn.functional.one_hot((vecs @ centroids.t()).argmax(dim=1), k).float()
            if weight is not None:
                one_hot = one_hot * weight
            sums = one_hot.t() @ vecs
            counts = one_hot.sum(dim=0)[:, None]
            centroids = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
    return centroids


def _kmeans_l2(sub: torch.Tensor, key: int, iters: int) -> torch.Tensor:
    """256 L2 centroids of one PQ subspace, seeded from ``key``."""
    init = torch.from_numpy(_init_rows(sub.shape[0], _PQ_CENTROIDS, key)).to(sub.device)
    return _lloyd_l2(sub, sub[init], iters)


def _kmeans(vecs: torch.Tensor, nlist: int, iters: int, key: int, n_valid: Optional[int] = None) -> torch.Tensor:
    """``nlist`` IVF centroids (f32) of rows (n, d), seeded from ``key``
    among the first ``n_valid`` rows."""
    vecs = vecs.float()
    n_init = int(n_valid) if n_valid is not None else vecs.shape[0]
    init = torch.from_numpy(_init_rows(n_init, nlist, key)).to(vecs.device)
    return _lloyd_ip(vecs, vecs[init], iters, n_valid)


def _train_pq(src: np.ndarray, rows: np.ndarray, pq_m: int, seed: int, device: torch.device) -> np.ndarray:
    """(pq_m, 256, d/pq_m) f32 codebooks from the training rows ``src[rows]``
    on a bounded subsample (the reference's numpy draw, so the same rows),
    one k-means per subspace on ``device``."""
    n, d = len(rows), src.shape[1]
    if n > _PQ_TRAIN_MAX:
        rows = rows[np.random.default_rng(seed).choice(n, _PQ_TRAIN_MAX, replace=False)]
    vecs = np.asarray(src[rows], dtype=np.float32)
    dsub = d // pq_m
    sub = np.ascontiguousarray(vecs.reshape(len(vecs), pq_m, dsub).transpose(1, 0, 2))
    books = [
        _kmeans_l2(torch.from_numpy(sub[m]).to(device), seed * 1_000_003 + m, _PQ_KMEANS_ITERS).cpu().numpy()
        for m in range(pq_m)
    ]
    return np.stack(books).astype(np.float32)


def _pq_lut(Q: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """Asymmetric-distance table (b, pq_m, 256): the f32 inner product of
    each query's m-th subspace with codebook m's centroids."""
    M, _, dsub = books.shape
    with full_f32(Q.device):
        return torch.einsum("bmd,mcd->bmc", Q.float().reshape(Q.shape[0], M, dsub), books)


class _Snap(NamedTuple):
    """Device tensors of the flat store for one search (a copy-on-write
    snapshot taken under the lock)."""

    buf: torch.Tensor  # (cap, d): mirror rows [0, base)
    valid: torch.Tensor  # (cap,) bool
    tail: torch.Tensor  # (tail_cap, d): mirror rows [base, synced)
    tvalid: torch.Tensor  # (tail_cap,) bool
    base: int
    qbuf: Optional[torch.Tensor]  # int8 (cap, d) codes | uint8 (pq_m, cap) codes
    qscale: Optional[torch.Tensor]  # f32 (cap,) int8 scales
    books: Optional[torch.Tensor]  # f32 (pq_m, 256, d/pq_m)


class _IVFSnap(NamedTuple):
    """Device tensors (and the host ids) of an IVF index for one search."""

    centroids: torch.Tensor  # f32 (nlist, d)
    buckets: torch.Tensor  # (nlist, cap, d)
    bvalid: torch.Tensor  # (nlist, cap) bool
    bids: np.ndarray  # host int32 (nlist, cap): mirror row of each slot
    tail: torch.Tensor  # (tail_cap, d): mirror rows [tbase, synced)
    tvalid: torch.Tensor
    tbase: int
    qbuckets: Optional[torch.Tensor]  # int8 (nlist, cap, d) | uint8 (nlist, cap, pq_m)
    qscales: Optional[torch.Tensor]  # f32 (nlist, cap)
    books: Optional[torch.Tensor]


class GPUVectorStore(VectorStore):
    """Inner-product top-k on the card over a padded corpus buffer
    (counterpart of the reference's ``TPUVectorStore``): exact, or
    two-stage over an int8 / PQ copy.  Runs on ``cuda`` unless
    ``device="cpu"`` is passed."""

    # Persisted meta keys that are not constructor arguments.
    _META_STATE_KEYS = ("last_train_live",)

    def __init__(
        self,
        dimensions: int,
        *,
        dtype: str = "bfloat16",
        device=None,
        mesh=None,
        max_query_batch: int = 128,
        incremental: bool = True,
        quantization: str = "none",
        pq_m: int = 16,
        rescore_multiplier: int = 4,
        recall_target: float = 0.95,
    ) -> None:
        if quantization not in _QUANT_MODES:
            raise ValueError(f"quantization={quantization!r} not in {_QUANT_MODES}")
        if quantization == "pq" and dimensions % pq_m:
            raise ValueError(f"pq_m={pq_m} must divide dimensions={dimensions}")
        if rescore_multiplier < 1:
            raise ValueError(f"rescore_multiplier must be >= 1, got {rescore_multiplier}")
        if mesh is not None:
            raise _not_ported("the mesh-sharded store")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype={dtype!r} not in {tuple(_DTYPES)}")
        self.dimensions = dimensions
        self.device = resolve_device(device)
        self._dtype = _DTYPES[dtype]
        self.quantization = quantization
        self.pq_m = int(pq_m)
        self.rescore_multiplier = int(rescore_multiplier)
        # Kept, validated by the caller's config and persisted: stage one is
        # an exact top-k here (see the module docstring).
        self.recall_target = float(recall_target)
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
        # Compressed copies of the main buffer, rebuilt at each compaction
        # (the tail stays full-width).
        self._q_buf: Optional[torch.Tensor] = None  # int8 (cap, d) | uint8 (pq_m, cap)
        self._q_scale: Optional[torch.Tensor] = None  # f32 (cap,) (int8)
        self._pq_codebooks: Optional[torch.Tensor] = None  # device f32 (pq_m, 256, d/pq_m)
        self._pq_codebooks_h: Optional[np.ndarray] = None  # host copy (IVF folds re-encode against it)

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
        """A device copy of a host mask (never a view: the host mask may
        change in place after)."""
        return torch.tensor(mask, dtype=torch.bool, device=self.device)

    def _compress_main(self, n: int) -> None:
        """(Re)build the compressed copy of the main buffer from the f32
        mirror rows [0, n): int8 codes quantized on the device in blocks,
        or PQ codebooks trained on the live rows and host-encoded codes,
        stored transposed (pq_m, cap)."""
        self._q_buf = None
        self._q_scale = None
        cap = int(self._device_buf.shape[0])
        vecs = self._mirror._vecs
        if self.quantization == "int8":
            codes = torch.zeros((cap, self.dimensions), dtype=torch.int8, device=self.device)
            scale = torch.full((cap,), _INT8_PAD_SCALE, dtype=torch.float32, device=self.device)
            for lo in range(0, n, _UPLOAD_ROWS):
                block = torch.from_numpy(np.ascontiguousarray(vecs[lo : min(n, lo + _UPLOAD_ROWS)])).to(self.device)
                codes[lo : lo + len(block)], scale[lo : lo + len(block)] = _int8_rows_t(block)
            self._q_buf, self._q_scale = codes, scale
        elif self.quantization == "pq":
            live = np.nonzero(self._valid[:n])[0]
            if len(live) < _PQ_MIN_TRAIN:
                return  # the exact regime: nothing to compress yet
            books = _train_pq(vecs, live, self.pq_m, 0, self.device)
            self._pq_codebooks_h = books
            self._pq_codebooks = torch.from_numpy(books).to(self.device)
            codes = np.empty((self.pq_m, cap), dtype=np.uint8)
            codes[:, :n] = _pq_encode(vecs[:n], books).T
            codes[:, n:] = _pq_zero_code(books)[:, None]
            self._q_buf = torch.from_numpy(codes).to(self.device)

    def _rebuild_full(self) -> None:
        """O(corpus) compaction: a new main buffer (and compressed copy) from
        the mirror and an empty tail.  Runs on first sync, capacity or tail
        overflow, and on every sync of a non-incremental store."""
        n = len(self._mirror._chunks)
        cap = _capacity_for(max(n, 1))
        buf = torch.zeros((cap, self.dimensions), dtype=self._dtype, device=self.device)
        self._upload(self._mirror._vecs[:n], buf)
        valid = np.zeros((cap,), dtype=bool)
        valid[:n] = self._valid
        self._device_buf = buf
        self._device_valid = self._mask(valid)
        self._compress_main(n)
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
        return _Snap(self._device_buf, self._device_valid, self._tail_buf, self._tail_valid, self._base,
                     self._q_buf, self._q_scale, self._pq_codebooks)

    def _prepared(self):
        """Sync if needed and snapshot, or None for an empty store."""
        with self._lock:
            if int(self._valid.sum()) == 0:
                return None
            if self._dirty:
                self._sync_device()
            return self._snapshot()

    def _quant_ready(self, top_k: int, snap: Optional[_Snap] = None) -> bool:
        """Whether the two-stage path serves ``top_k``: a compressed copy
        exists and the main buffer holds more than ``top_k *
        rescore_multiplier`` rows (else stage one would select them all)."""
        qbuf, base = (self._q_buf, self._base) if snap is None else (snap.qbuf, snap.base)
        return qbuf is not None and base > top_k * self.rescore_multiplier

    @staticmethod
    def scan(snap, Q: torch.Tensor) -> list[torch.Tensor]:
        """The device work of one exact search's scoring, with no host sync:
        the masked f32 scores of the main buffer and of the tail against Q
        (b, d) on the device."""
        buf, valid, tail, tvalid = snap[:4]
        Qc = Q.to(buf.dtype)
        return [
            scores_f32(Qc, rows).masked_fill_(~mask[None, :], float("-inf"))
            for rows, mask in ((buf, valid), (tail, tvalid))
        ]

    @staticmethod
    def stage_one(snap: _Snap, Q: torch.Tensor) -> torch.Tensor:
        """The compressed scan of the main buffer against Q (b, d) f32 on the
        device, with no host sync: masked f32 scores (b, cap).  int8: the
        codes cast to the store's dtype in row blocks (never the whole
        buffer at once), the product with Q in that dtype, times the row
        scales.  PQ: the lookup table gathered by each subspace's codes."""
        cap = snap.valid.shape[0]
        if snap.qscale is not None:
            Qc = Q.to(snap.buf.dtype)
            s = torch.empty((Q.shape[0], cap), dtype=torch.float32, device=Q.device)
            for lo in range(0, cap, _UPLOAD_ROWS):
                s[:, lo : lo + _UPLOAD_ROWS] = scores_f32(Qc, snap.qbuf[lo : lo + _UPLOAD_ROWS].to(snap.buf.dtype))
            s.mul_(snap.qscale[None, :])
        else:
            lut = _pq_lut(Q, snap.books)
            s = torch.zeros((Q.shape[0], cap), dtype=torch.float32, device=Q.device)
            for m in range(snap.qbuf.shape[0]):
                s += lut[:, m, :].index_select(1, snap.qbuf[m].int())
        return s.masked_fill_(~snap.valid[None, :], float("-inf"))

    @staticmethod
    def _tail_part(tail_scores: torch.Tensor, k: int, m: int, key0: int, base: int):
        """(values, keys, ids) of the tail's top ``k`` for the merge: tail
        slot s is mirror row base + s, at concatenation position key0 + s."""
        v, p = _top_rows(tail_scores[:m], min(k, tail_scores.shape[1]))
        return v, p + key0, p + base

    @staticmethod
    def select(snap, parts: list[torch.Tensor], k: int, m: int) -> tuple[np.ndarray, np.ndarray]:
        """Top ``k`` (values, row ids) of the first ``m`` queries over the
        exact scan's two parts, in ``lax.top_k``'s order: tail slot s holds
        mirror row base + s, after every live main row."""
        main, tail = parts
        v, p = _top_rows(main[:m], min(k, main.shape[1]))
        return _merge([(v, p, p), GPUVectorStore._tail_part(tail, k, m, snap[4], snap[4])], k)

    def _search_rows(self, snap, Q: np.ndarray, m: int, k: int) -> list[list[ScoredChunk]]:
        parts = self.scan(snap, torch.from_numpy(Q).to(self.device))
        scores, ids = self.select(snap, parts, k, m)
        return [self._collect(scores[b], ids[b], k) for b in range(m)]

    def _search_two_stage(self, snap: _Snap, Q: np.ndarray, m: int, k: int, k2: int) -> list[list[ScoredChunk]]:
        """Stage one selects ``k2`` candidates a query from the compressed
        scores (``lax.top_k``'s order); stage two rescores their full-width
        rows exactly, and the final top ``k`` runs over those (at their
        stage-one rank) then the tail."""
        Qd = torch.from_numpy(Q).to(self.device)
        cs, cid = _top_rows(self.stage_one(snap, Qd)[:m], k2)
        Qc = Qd[:m].to(snap.buf.dtype)
        v, j = _rescored(snap.buf[torch.from_numpy(cid).to(self.device)], Qc, cs, min(k, k2))
        tail = scores_f32(Qc, snap.tail).masked_fill_(~snap.tvalid[None, :], float("-inf"))
        scores, ids = _merge([(v, j, np.take_along_axis(cid, j, 1)),
                              self._tail_part(tail, k, m, k2, snap.base)], k)
        return [self._collect(scores[b], ids[b], k) for b in range(m)]

    def search(self, embedding: Sequence[float], top_k: int) -> list[ScoredChunk]:
        snap = self._prepared() if top_k > 0 else None
        if snap is None:
            return []
        if self._quant_ready(top_k, snap):
            # The two-stage path is batched: a 4-row bucket costs the scan of one.
            return self.search_batch([embedding], top_k)[0]
        k = min(top_k, int(snap.buf.shape[0]) + int(snap.tail.shape[0]))
        return self._search_rows(snap, np.asarray(embedding, dtype=np.float32)[None, :], 1, k)[0]

    def search_batch(self, embeddings: Sequence[Sequence[float]], top_k: int) -> list[list[ScoredChunk]]:
        if len(embeddings) == 0:
            return []
        snap = self._prepared() if top_k > 0 else None
        if snap is None:
            return [[] for _ in embeddings]
        return self._search_flat(snap, np.asarray(embeddings, dtype=np.float32), top_k)

    def _search_flat(self, snap: _Snap, Q_all: np.ndarray, top_k: int) -> list[list[ScoredChunk]]:
        cap = int(snap.buf.shape[0])
        k = min(top_k, cap + int(snap.tail.shape[0]))
        quantized = self._quant_ready(top_k, snap)
        k2 = min(top_k * self.rescore_multiplier, cap)
        # Batches beyond max_query_batch split into chunks; each chunk pads
        # to a power-of-two bucket and only its real rows are collected.
        out: list[list[ScoredChunk]] = []
        for lo in range(0, len(Q_all), self.max_query_batch):
            m = min(self.max_query_batch, len(Q_all) - lo)
            Q = _bucket_queries(Q_all[lo : lo + m], maximum=self.max_query_batch)
            if quantized:
                out.extend(self._search_two_stage(snap, Q, m, k, k2))
            else:
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
        blocks, invalidated rows masked, ranks in ``lax.top_k``'s order.
        The same for every store: the compressed and IVF copies are not
        read."""
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

    def _device_tensors(self) -> list[Optional[torch.Tensor]]:
        """Every device tensor the store holds (None where absent); call
        under the lock."""
        return [self._device_buf, self._device_valid, self._tail_buf, self._tail_valid, self._q_buf, self._q_scale,
                self._pq_codebooks]

    def _tail_rows(self) -> int:
        """Rows staged in the append tail; call under the lock."""
        return max(self._synced - self._base, 0)

    def capacity_stats(self) -> dict:
        """Live rows, device bytes of every buffer, compressed copy and mask,
        staged tail rows."""
        with self._lock:
            return {
                "rows": int(self._valid.sum()),
                "bytes": sum(t.numel() * t.element_size() for t in self._device_tensors() if t is not None),
                "tail_rows": self._tail_rows(),
            }

    def scanned_bytes_per_query(self, top_k: int) -> int:
        """Device bytes one query's search reads: the corpus-proportional
        scan (compressed codes or the full-width buffer), the rescored rows,
        the tail and its mask, and the main mask (the reference's count)."""
        with self._lock:
            if self._device_buf is None:
                if self._dirty and int(self._valid.sum()):
                    self._sync_device()
                else:
                    return 0
            cap = int(self._device_buf.shape[0])
            d = self.dimensions
            itemsize = self._device_buf.element_size()
            tail_bytes = self._tail_buf.numel() * self._tail_buf.element_size() + self._tail_valid.numel()
            if self._quant_ready(top_k):
                k2 = min(top_k * self.rescore_multiplier, cap)
                scan = cap * d + cap * 4 if self.quantization == "int8" else cap * self.pq_m
                return scan + k2 * d * itemsize + tail_bytes + cap
            return cap * d * itemsize + tail_bytes + cap

    def _persist_meta(self) -> dict:
        """Constructor knobs written beside the corpus, so ``load(path)``
        rebuilds the store as configured; call under the lock."""
        return {
            "quantization": self.quantization,
            "pq_m": self.pq_m,
            "rescore_multiplier": self.rescore_multiplier,
            "recall_target": self.recall_target,
        }

    def save(self, path: str) -> None:
        """Compact (drop invalidated rows) and write the JAX store's format."""
        with self._lock:
            compact = MemoryVectorStore(self.dimensions)
            live = [i for i in range(len(self._mirror._chunks)) if self._valid[i]]
            compact.add([self._mirror._chunks[i] for i in live], self._mirror._vecs[live].tolist() if live else [])
            compact._restore_version(self.version())
            meta = self._persist_meta()
        compact.save(path)
        with open(os.path.join(path, "tpu_meta.json"), "w", encoding="utf-8") as fh:
            json.dump(meta, fh)
        self._save_index(path)

    def _save_index(self, path: str) -> None:
        """Backend hook: persist derived index state (the IVF store's)."""

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
        """A store from a snapshot of either package, with every persisted
        knob (``kwargs`` win); a snapshot of an IVF store loads as a
        ``GPUIVFVectorStore`` with its persisted index."""
        mirror = MemoryVectorStore.load(path)
        meta = cls._load_meta(path)
        if cls is GPUVectorStore and any(key in meta for key in _IVF_META_KEYS):
            cls = GPUIVFVectorStore
        for key in cls._META_STATE_KEYS:
            meta.pop(key, None)
        for key, value in meta.items():
            kwargs.setdefault(key, value)
        store = cls(mirror.dimensions, **kwargs)
        store._mirror = mirror
        store._valid = np.ones((len(mirror._chunks),), dtype=bool)
        store._dirty = True
        store._restore_version(mirror.version())
        store._load_index(path)
        return store

    def _load_index(self, path: str) -> None:
        """Backend hook: restore derived index state (the IVF store's)."""


class GPUIVFVectorStore(GPUVectorStore):
    """Clustered search on the card: centroid product, then the probed
    lists' padded buckets (counterpart of the reference's
    ``TPUIVFVectorStore``; nlist 64 and nprobe 16 as Milvus GPU_IVF_FLAT).

    Below ``min_train_size`` live rows (4 x nlist by default) it is the
    exact store.  Appends after a build are assigned to the frozen centroids
    and searched exactly from a tail until a fold; a retrain fires at
    ``retrain_growth`` x the rows of the last train, or when an appended row
    finds no probed list with room.  Both run on a background thread and
    swap in atomically.  With ``quantization`` the buckets get int8 or PQ
    copies, built and swapped with them, and search is two-stage over the
    probed lists.  Probing every list (``nprobe == nlist``) is exact.
    """

    def __init__(
        self,
        dimensions: int,
        *,
        nlist: int = 64,
        nprobe: int = 16,
        kmeans_iters: int = 10,
        min_train_size: Optional[int] = None,
        dtype: str = "bfloat16",
        device=None,
        mesh=None,
        seed: int = 0,
        max_query_batch: int = 128,
        incremental: bool = True,
        retrain_growth: float = 2.0,
        quantization: str = "none",
        pq_m: int = 16,
        rescore_multiplier: int = 4,
        recall_target: float = 0.95,
    ) -> None:
        super().__init__(
            dimensions, dtype=dtype, device=device, mesh=mesh, max_query_batch=max_query_batch,
            incremental=incremental, quantization=quantization, pq_m=pq_m,
            rescore_multiplier=rescore_multiplier, recall_target=recall_target,
        )
        if not 1 <= nprobe <= nlist:
            raise ValueError(f"need 1 <= nprobe={nprobe} <= nlist={nlist}")
        self.nlist = nlist
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self.min_train_size = min_train_size if min_train_size is not None else 4 * nlist
        self._seed = seed
        self.retrain_growth = float(retrain_growth)
        self._centroids: Optional[torch.Tensor] = None  # device f32 (nlist, d)
        self._centroids_h: Optional[np.ndarray] = None  # host copy: append assignment
        self._buckets: Optional[torch.Tensor] = None  # (nlist, cap, d)
        self._bucket_valid: Optional[torch.Tensor] = None  # (nlist, cap) bool
        # Host index state (None until the first build):
        self._bids_h: Optional[np.ndarray] = None  # (nlist, cap) int32 mirror row of each slot
        self._bvalid_h: Optional[np.ndarray] = None  # (nlist, cap) bool mirror of _bucket_valid
        self._fill: Optional[np.ndarray] = None  # (nlist,) occupied slots per list
        self._pos_list: Optional[np.ndarray] = None  # row -> list (rows < _ivf_base), -1 = none
        self._pos_slot: Optional[np.ndarray] = None  # row -> slot within its list
        self._ivf_base = 0  # rows covered by the bucket index
        self._ivf_synced = 0  # rows on the device (buckets + ivf tail)
        self._ivf_tail_buf: Optional[torch.Tensor] = None
        self._ivf_tail_valid: Optional[torch.Tensor] = None
        self._last_train_live = 0
        self._train_thread: Optional[threading.Thread] = None
        self._retrain_requested = False
        self._q_buckets: Optional[torch.Tensor] = None  # int8 (nlist, cap, d) | uint8 (nlist, cap, pq_m)
        self._q_bucket_scales: Optional[torch.Tensor] = None  # f32 (nlist, cap) (int8)

    # -- index construction ------------------------------------------------

    def _drop_index(self) -> None:
        self._centroids = None
        self._centroids_h = None
        self._buckets = None
        self._bucket_valid = None
        self._bids_h = None
        self._bvalid_h = None
        self._fill = None
        self._pos_list = None
        self._pos_slot = None
        self._ivf_base = 0
        self._ivf_synced = 0
        self._ivf_tail_buf = None
        self._ivf_tail_valid = None
        self._q_buckets = None
        self._q_bucket_scales = None

    def _rows_f32(self, src: np.ndarray, rows: np.ndarray) -> torch.Tensor:
        """A device f32 copy of ``src[rows]``, uploaded in blocks."""
        out = torch.empty((len(rows), self.dimensions), dtype=torch.float32, device=self.device)
        for lo in range(0, len(rows), _UPLOAD_ROWS):
            block = np.ascontiguousarray(src[rows[lo : lo + _UPLOAD_ROWS]], dtype=np.float32)
            out[lo : lo + len(block)].copy_(torch.from_numpy(block).to(self.device))
        return out

    def _compute_index(
        self,
        src: np.ndarray,
        live_rows: np.ndarray,
        centroids_h: Optional[np.ndarray],
        codebooks_h: Optional[np.ndarray] = None,
        assign_h: Optional[np.ndarray] = None,
    ) -> dict:
        """The heavy build over the rows ``src[live_rows]``, with no change to
        the store's state, so it can run on a background thread while
        searches serve the current index.

        ``centroids_h`` None retrains k-means; otherwise rows are assigned to
        those frozen centroids (a fold).  PQ codebooks follow the same rule.
        ``assign_h`` (a snapshot's layout) installs the row-to-list layout as
        it is.  The buckets (and their compressed copies) are filled on the
        device from f32 row blocks in list order."""
        dev, d, nlist = self.device, self.dimensions, self.nlist
        n = len(live_rows)
        dev_vecs = self._rows_f32(src, live_rows)
        trained = False
        if assign_h is not None:
            # The saved layout was overflow-balanced when it was built.
            centroids = torch.from_numpy(np.asarray(centroids_h, dtype=np.float32)).to(dev)
            assign = np.asarray(assign_h, dtype=np.int64).copy()
            counts = np.bincount(assign, minlength=nlist)
            cap = max(8, 1 << int(np.ceil(np.log2(max(int(counts.max()), 1)))))
        else:
            if centroids_h is None:
                centroids = _kmeans(dev_vecs, nlist, self.kmeans_iters, self._seed, n_valid=n)
                trained = True
            else:
                centroids = torch.from_numpy(np.asarray(centroids_h, dtype=np.float32)).to(dev)
            with full_f32(dev):
                scores = (dev_vecs @ centroids.t()).cpu().numpy()
            assign = np.argmax(scores, axis=1)
            # One static capacity for every list, capped at 4x the mean list
            # (a skewed cluster would otherwise size every list at the
            # largest's power of two); overflow rows go to their next-nearest
            # list with room.
            counts = np.bincount(assign, minlength=nlist)
            cap_target = min(int(counts.max()), -(-4 * n // nlist))
            cap = max(8, 1 << int(np.ceil(np.log2(max(cap_target, 1)))))
            if int(counts.max()) > cap:
                order = np.argsort(assign, kind="stable")
                grouped = assign[order]
                starts = np.searchsorted(grouped, np.arange(nlist))
                overflow_rows = order[(np.arange(len(order)) - starts[grouped]) >= cap]
                fill = np.minimum(counts, cap)
                pref = np.argsort(-scores[overflow_rows], axis=1)
                for r_i, row in enumerate(overflow_rows):
                    for cand in pref[r_i]:
                        if fill[cand] < cap:
                            assign[row] = cand
                            fill[cand] += 1
                            break
                    else:  # nlist * cap >= 4 * rows, so there is always room
                        raise AssertionError("IVF bucket capacity accounting bug")
            del scores
        order = np.argsort(assign, kind="stable")
        grouped = assign[order]
        starts = np.searchsorted(grouped, np.arange(nlist))
        slots = np.arange(len(order)) - starts[grouped]
        bvalid = np.zeros((nlist, cap), dtype=bool)
        bids = np.zeros((nlist, cap), dtype=np.int32)
        bvalid[grouped, slots] = True
        bids[grouped, slots] = live_rows[order]
        buckets = torch.zeros((nlist, cap, d), dtype=self._dtype, device=dev)
        qbuckets = qscales = None
        if self.quantization == "int8":
            qbuckets = torch.zeros((nlist, cap, d), dtype=torch.int8, device=dev)
            qscales = torch.full((nlist, cap), _INT8_PAD_SCALE, dtype=torch.float32, device=dev)
        dest = grouped * cap + slots
        for lo in range(0, n, _UPLOAD_ROWS):
            rows = dev_vecs.index_select(0, torch.from_numpy(order[lo : lo + _UPLOAD_ROWS]).to(dev))
            at = torch.from_numpy(dest[lo : lo + _UPLOAD_ROWS]).to(dev)
            buckets.view(-1, d).index_copy_(0, at, rows.to(self._dtype))
            if qbuckets is not None:
                codes, scale = _int8_rows_t(rows)
                qbuckets.view(-1, d).index_copy_(0, at, codes)
                qscales.view(-1).index_copy_(0, at, scale)
        del dev_vecs
        if self.quantization == "pq":
            if codebooks_h is None and n >= _PQ_MIN_TRAIN:
                codebooks_h = _train_pq(src, live_rows, self.pq_m, self._seed, dev)
            if codebooks_h is not None:
                codes = _pq_encode(src, codebooks_h, live_rows)
                qcodes = np.empty((nlist, cap, self.pq_m), dtype=np.uint8)
                qcodes[:] = _pq_zero_code(codebooks_h)
                qcodes[grouped, slots] = codes[order]
                qbuckets = torch.from_numpy(qcodes).to(dev)
        return {
            "centroids": centroids,
            "centroids_h": centroids.cpu().numpy().astype(np.float32),
            "buckets": buckets,
            "bvalid": bvalid,
            "bids": bids,
            "fill": np.bincount(assign, minlength=nlist),
            "cap": cap,
            "assign": assign,
            "live_rows": live_rows,
            "trained": trained,
            "qbuckets": qbuckets,
            "qscales": qscales,
            "codebooks_h": codebooks_h if qbuckets is not None and self.quantization == "pq" else None,
        }

    def _install_index(self, built: dict, n_snapshot: int) -> None:
        """Atomic swap of a freshly built index; call under the lock.

        ``n_snapshot`` is the mirror length the build covered: rows added
        since move into a fresh tail and deletes since re-mask the new
        buckets, so no mutation that raced the build is lost."""
        n = len(self._mirror._chunks)
        bvalid = built["bvalid"] & self._valid[built["bids"]]
        self._centroids = built["centroids"]
        self._centroids_h = built["centroids_h"]
        self._buckets = built["buckets"]
        self._bucket_valid = self._mask(bvalid)
        self._bids_h = built["bids"]
        self._bvalid_h = bvalid
        # Compressed copies from the same snapshot (None when quantization
        # is off or PQ had too few rows to train: the plain lists serve).
        self._q_buckets = built["qbuckets"]
        self._q_bucket_scales = built["qscales"]
        if built["codebooks_h"] is not None:
            self._pq_codebooks_h = built["codebooks_h"]
            self._pq_codebooks = torch.from_numpy(built["codebooks_h"]).to(self.device)
        self._fill = built["fill"].copy()
        pos_list = np.full((n_snapshot,), -1, dtype=np.int32)
        pos_slot = np.zeros((n_snapshot,), dtype=np.int32)
        order = np.argsort(built["assign"], kind="stable")
        grouped = built["assign"][order]
        starts = np.searchsorted(grouped, np.arange(self.nlist))
        pos_list[built["live_rows"][order]] = grouped
        pos_slot[built["live_rows"][order]] = np.arange(len(order)) - starts[grouped]
        self._pos_list = pos_list
        self._pos_slot = pos_slot
        self._ivf_base = n_snapshot
        self._ivf_synced = n_snapshot
        if built["trained"]:
            self._last_train_live = len(built["live_rows"])
        # A fresh tail; rows that arrived during a background build replay
        # into it now (O(delta)).
        tail_cap = _pow2_at_least(max(n - n_snapshot, 1), _MIN_TAIL) if self._incremental else 8
        self._ivf_tail_buf = torch.zeros((tail_cap, self.dimensions), dtype=self._dtype, device=self.device)
        self._ivf_tail_valid = torch.zeros((tail_cap,), dtype=torch.bool, device=self.device)
        if n > n_snapshot:
            self._ivf_append(n)
        # The exact-regime buffers (and their compressed copies) go: the
        # device holds one copy of the corpus, not two.
        self._device_buf = None
        self._device_valid = None
        self._tail_buf = None
        self._tail_valid = None
        self._q_buf = None
        self._q_scale = None
        self._base = 0
        self._synced = 0
        self._mask_dirty = False
        # The swap changes which rows are reachable: caches stamped before
        # it must miss, and a durable wrapper journals a marker.
        self._bump_version()
        self._notify_mutation(
            "index_swap",
            {"rows": int(len(built["live_rows"])), "nlist": int(self.nlist), "trained": bool(built["trained"])},
        )
        logger.debug(
            "gpu-ivf index installed: %d rows, nlist=%d, bucket_cap=%d (pad %.2fx), trained=%s",
            len(built["live_rows"]), self.nlist, built["cap"],
            self.nlist * built["cap"] / max(len(built["live_rows"]), 1), built["trained"],
        )

    def _build_inline(self, retrain: bool) -> None:
        """Synchronous build (the first index, non-incremental stores)."""
        n = len(self._mirror._chunks)
        built = self._compute_index(
            self._mirror._vecs, np.nonzero(self._valid[:n])[0],
            None if retrain else self._centroids_h, None if retrain else self._pq_codebooks_h,
        )
        self._install_index(built, n)

    # -- background maintenance --------------------------------------------

    def _maintenance_running(self) -> bool:
        return self._train_thread is not None and self._train_thread.is_alive()

    def _start_background_build(self, retrain: bool) -> None:
        """A fold (frozen centroids) or a retrain off the search path, over
        the rows as they are now (``add`` replaces the mirror's array, so
        the build's rows stay as they were); the swap runs under the lock."""
        if self._maintenance_running():
            self._retrain_requested = self._retrain_requested or retrain
            return
        n0 = len(self._mirror._chunks)
        src, live_rows = self._mirror._vecs, np.nonzero(self._valid[:n0])[0]
        centroids_h = None if retrain else self._centroids_h
        codebooks_h = None if retrain else self._pq_codebooks_h
        self._retrain_requested = False

        def run() -> None:
            try:
                built = self._compute_index(src, live_rows, centroids_h, codebooks_h)
                with self._lock:
                    self._install_index(built, n0)
            except Exception:  # pragma: no cover - a failed build leaves the old index serving
                logger.exception("background IVF build failed")

        t = threading.Thread(target=run, name="gpu-ivf-train", daemon=True)
        self._train_thread = t
        t.start()

    def wait_for_maintenance(self, timeout: Optional[float] = 30.0) -> None:
        """Block until an in-flight background fold or retrain has swapped in
        (tests and benchmarks)."""
        t = self._train_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    # -- persistence -------------------------------------------------------

    def _persist_meta(self) -> dict:
        meta = super()._persist_meta()
        meta.update(
            nlist=self.nlist,
            nprobe=self.nprobe,
            kmeans_iters=self.kmeans_iters,
            min_train_size=self.min_train_size,
            retrain_growth=self.retrain_growth,
            last_train_live=self._last_train_live,
        )
        return meta

    def _save_index(self, path: str) -> None:
        """``ivf_index.npz`` beside the compact corpus: the centroids, each
        saved row's list (indexed rows keep their overflow-balanced list,
        tail rows take their nearest frozen centroid) and the PQ codebooks,
        so ``load`` installs the index without k-means."""
        with self._lock:
            if self._centroids_h is None:
                return  # the exact regime: nothing derived to persist
            n = len(self._mirror._chunks)
            live = np.nonzero(self._valid[:n])[0]
            assign = np.full(len(live), -1, dtype=np.int64)
            pos = self._pos_list
            if pos is not None and len(pos):
                mask = live < len(pos)
                assign[mask] = pos[live[mask]]
            pending = np.nonzero(assign < 0)[0]
            if len(pending):
                vecs = np.asarray(self._mirror._vecs[live[pending]], dtype=np.float32)
                assign[pending] = np.argmax(vecs @ self._centroids_h.T, axis=1)
            arrays = {"centroids": self._centroids_h.astype(np.float32), "assign": assign}
            if self._pq_codebooks_h is not None:
                arrays["codebooks"] = np.asarray(self._pq_codebooks_h, dtype=np.float32)
        np.savez_compressed(os.path.join(path, "ivf_index.npz"), **arrays)

    def _load_index(self, path: str) -> None:
        idx_path = os.path.join(path, "ivf_index.npz")
        n = len(self._mirror._chunks)
        if not os.path.exists(idx_path) or n == 0:
            return  # an exact-regime snapshot: the first sync trains
        data = np.load(idx_path)
        assign = np.asarray(data["assign"], dtype=np.int64) if "assign" in data.files else None
        if assign is not None and len(assign) != n:
            assign = None  # corpus and layout disagree: assign to the centroids
        codebooks = np.asarray(data["codebooks"], dtype=np.float32) if "codebooks" in data.files else None
        built = self._compute_index(self._mirror._vecs, np.arange(n), np.asarray(data["centroids"], np.float32),
                                    codebooks, assign_h=assign)
        with self._lock:
            self._install_index(built, n)
            self._last_train_live = int(self._load_meta(path).get("last_train_live", 0)) or n
            self._dirty = False

    # -- incremental sync --------------------------------------------------

    def _ivf_append(self, n: int) -> None:
        """Sync mirror rows [_ivf_synced, n): assignment to the frozen
        centroids on the host (fill accounting and overflow), then an
        O(new rows) copy-on-write write into the tail."""
        new_vecs = np.asarray(self._mirror._vecs[self._ivf_synced : n], dtype=np.float32)
        scores = new_vecs @ self._centroids_h.T
        cap = int(self._buckets.shape[1])
        counts = np.bincount(np.argmax(scores, axis=1), minlength=self.nlist)
        overflow = False
        if np.all(self._fill + counts <= cap):
            self._fill += counts
        else:
            for row_pref in np.argsort(-scores, axis=1):
                for cand in row_pref[: self.nprobe]:
                    if self._fill[cand] < cap:
                        self._fill[cand] += 1
                        break
                else:
                    overflow = True
        tail = self._ivf_tail_buf
        if n - self._ivf_base > int(tail.shape[0]):
            # Grow the tail: appends never wait for the fold.
            grown = torch.zeros((_pow2_at_least(n - self._ivf_base, int(tail.shape[0])), self.dimensions),
                                dtype=self._dtype, device=self.device)
            grown[: self._ivf_synced - self._ivf_base] = tail[: self._ivf_synced - self._ivf_base]
            tail = grown
        else:
            tail = tail.clone()
        self._upload(self._mirror._vecs[self._ivf_synced : n],
                     tail[self._ivf_synced - self._ivf_base : n - self._ivf_base])
        self._ivf_tail_buf = tail
        self._ivf_synced = n
        self._ivf_tail_valid = self._ivf_tail_mask()
        fill = n - self._ivf_base
        if overflow:
            # A row found no probed list with room: the layout has drifted
            # from the corpus, so retrain, off the search path.
            self._start_background_build(retrain=True)
        elif fill >= min(max(_MIN_TAIL, self._ivf_base // 8), _MAX_TAIL):
            # A proportionally large tail folds into the buckets (frozen
            # centroids); the tail keeps absorbing meanwhile.
            self._start_background_build(retrain=False)

    def _ivf_tail_mask(self) -> torch.Tensor:
        tmask = np.zeros((int(self._ivf_tail_buf.shape[0]),), dtype=bool)
        tmask[: self._ivf_synced - self._ivf_base] = self._valid[self._ivf_base : self._ivf_synced]
        return self._mask(tmask)

    def _upload_ivf_masks(self) -> None:
        self._bucket_valid = self._mask(self._bvalid_h)
        self._ivf_tail_valid = self._ivf_tail_mask()
        self._mask_dirty = False

    def delete_source(self, source: str) -> int:
        # The row mask and the bucket mask change in one critical section:
        # a sync between the two would upload a stale bucket mask.
        removed = 0
        with self._lock:
            indexed = self._centroids is not None
            for i, c in enumerate(self._mirror._chunks):
                if c.source == source and self._valid[i]:
                    self._valid[i] = False
                    removed += 1
                    if indexed and i < len(self._pos_list) and self._pos_list[i] >= 0:
                        # Indexed rows clear their slot; tail rows re-mask
                        # with the tail at sync.
                        self._bvalid_h[self._pos_list[i], self._pos_slot[i]] = False
            if removed:
                self._dirty = True
                self._mask_dirty = True
                self._bump_version()
        return removed

    def _sync_device(self) -> None:
        n = len(self._mirror._chunks)
        live = int(self._valid.sum())
        if self._centroids is None:
            if live < self.min_train_size:
                super()._sync_device()  # the exact regime
                return
            self._build_inline(retrain=True)  # the first crossing: once
            self._dirty = False
            return
        if live < self.min_train_size:
            # The corpus shrank below the training floor: serve exact again.
            self._drop_index()
            super()._sync_device()
            return
        if not self._incremental:
            self._build_inline(retrain=True)
            self._dirty = False
            return
        if n > self._ivf_synced:
            self._ivf_append(n)
        if self._mask_dirty:
            self._upload_ivf_masks()
        if (
            live >= self.retrain_growth * max(self._last_train_live, 1) or self._retrain_requested
        ) and not self._maintenance_running():
            self._start_background_build(retrain=True)
        self._dirty = False

    # -- search ------------------------------------------------------------

    def _snapshot(self):
        if self._centroids is None:
            return super()._snapshot()
        return _IVFSnap(self._centroids, self._buckets, self._bucket_valid, self._bids_h, self._ivf_tail_buf,
                        self._ivf_tail_valid, self._ivf_base, self._q_buckets, self._q_bucket_scales,
                        self._pq_codebooks)

    def search(self, embedding: Sequence[float], top_k: int) -> list[ScoredChunk]:
        return self.search_batch([embedding], top_k)[0]

    def _two_stage_engages(self, snap: _IVFSnap, top_k: int) -> bool:
        """Two-stage only where the oversample is a strict subset of the
        probed rows (else the plain lists are exact and cheaper)."""
        return snap.qbuckets is not None and top_k * self.rescore_multiplier < self.nprobe * snap.buckets.shape[1]

    def query_chunk(self, snap: _IVFSnap, top_k: int) -> int:
        """Queries per search dispatch: the reference's 2 GiB budget over
        what one query gathers (the probed lists in full width, or their
        compressed codes and an f32 score a slot), floored to a power of
        two and capped by ``max_query_batch``."""
        probed = self.nprobe * int(snap.buckets.shape[1])
        if self._two_stage_engages(snap, top_k):
            per_query = probed * ((self.dimensions if self.quantization == "int8" else self.pq_m) + 4)
        else:
            per_query = probed * self.dimensions * snap.buckets.element_size()
        chunk = max(1, _IVF_CHUNK_BYTES // max(per_query, 1))
        while chunk & (chunk - 1):
            chunk &= chunk - 1
        while chunk > self.max_query_batch and chunk > 1:
            chunk //= 2
        return chunk

    @staticmethod
    def probe(snap: _IVFSnap, Q: torch.Tensor, nprobe: int) -> np.ndarray:
        """Each query's ``nprobe`` lists (b, nprobe), nearest first by the
        f32 centroid inner product (the rule rows were indexed by)."""
        with full_f32(Q.device):
            cs = Q.float() @ snap.centroids.t()
        return _top_rows(cs, nprobe)[1]

    @staticmethod
    def list_scores(snap: _IVFSnap, Q: torch.Tensor, probe: np.ndarray, compressed: bool) -> torch.Tensor:
        """The device work of one chunk's scan, with no host sync: masked
        f32 scores (m, nprobe, cap) of each query's probed lists, in probe
        order.  Full-width and int8 lists are read in place, each once for
        the chunk's queries that probe it (int8 codes cast to the store's
        dtype a list at a time); PQ gathers the probed lists' codes, as the
        reference does."""
        m, nprobe = probe.shape
        nlist, cap, d = snap.buckets.shape
        dev = Q.device
        if compressed and snap.qscales is None:
            lut = _pq_lut(Q, snap.books)  # (m, pq_m, 256)
            probe_t = torch.from_numpy(probe).to(dev)
            codes = snap.qbuckets[probe_t].reshape(m, nprobe * cap, -1)
            s = torch.zeros((m, nprobe * cap), dtype=torch.float32, device=dev)
            for j in range(codes.shape[2]):
                s += torch.gather(lut[:, j, :], 1, codes[:, :, j].long())
            return s.view(m, nprobe, cap).masked_fill_(~snap.bvalid[probe_t], float("-inf"))
        Qc = Q.to(snap.buckets.dtype)
        out = torch.empty((m * nprobe, cap), dtype=torch.float32, device=dev)
        for lst in np.unique(probe):
            qi, r = np.nonzero(probe == lst)
            at = torch.from_numpy(np.stack([qi, qi * nprobe + r])).to(dev)
            if compressed:
                s = scores_f32(Qc[at[0]], snap.qbuckets[lst].to(snap.buckets.dtype)).mul_(snap.qscales[lst][None, :])
            else:
                s = scores_f32(Qc[at[0]], snap.buckets[lst])
            out[at[1]] = s.masked_fill_(~snap.bvalid[lst][None, :], float("-inf"))
        return out.view(m, nprobe, cap)

    def search_batch(self, embeddings: Sequence[Sequence[float]], top_k: int) -> list[list[ScoredChunk]]:
        if len(embeddings) == 0:
            return []
        snap = self._prepared() if top_k > 0 else None
        if snap is None:
            return [[] for _ in embeddings]
        Q_all = np.asarray(embeddings, dtype=np.float32)
        if not isinstance(snap, _IVFSnap):
            return self._search_flat(snap, Q_all, top_k)  # the exact regime
        cap = int(snap.buckets.shape[1])
        probed = self.nprobe * cap
        quant = self._two_stage_engages(snap, top_k)
        k2 = min(top_k * self.rescore_multiplier, probed)
        k = min(top_k, (k2 if quant else probed) + int(snap.tail.shape[0]))
        Qd = torch.from_numpy(Q_all).to(self.device)
        probe = self.probe(snap, Qd, self.nprobe)
        chunk = self.query_chunk(snap, top_k)
        out: list[list[ScoredChunk]] = []
        for lo in range(0, len(Q_all), chunk):
            Q, pr = Qd[lo : lo + chunk], probe[lo : lo + chunk]
            m = len(pr)
            rows = np.arange(m)[:, None]
            S = self.list_scores(snap, Q, pr, quant).view(m, -1)
            Qc = Q.to(snap.buckets.dtype)
            if quant:
                cs, cpos = _top_rows(S, k2)
                lists, slots = pr[rows, cpos // cap], cpos % cap
                at = torch.from_numpy(np.stack([lists, slots])).to(self.device)
                v, j = _rescored(snap.buckets[at[0], at[1]], Qc, cs, min(k, k2))
                first = (v, j, np.take_along_axis(snap.bids[lists, slots], j, 1))
                key0 = k2
            else:
                v, p = _top_rows(S, min(k, probed))
                first = (v, p, snap.bids[pr[rows, p // cap], p % cap])
                key0 = probed
            tail = scores_f32(Qc, snap.tail).masked_fill_(~snap.tvalid[None, :], float("-inf"))
            scores, ids = _merge([first, self._tail_part(tail, k, m, key0, snap.tbase)], k)
            out.extend(self._collect(scores[b], ids[b], top_k) for b in range(m))
        return out

    # -- capacity / bandwidth accounting ------------------------------------

    def _device_tensors(self) -> list[Optional[torch.Tensor]]:
        return super()._device_tensors() + [
            self._centroids,
            self._buckets,
            self._bucket_valid,
            self._ivf_tail_buf,
            self._ivf_tail_valid,
            self._q_buckets,
            self._q_bucket_scales,
        ]

    def _tail_rows(self) -> int:
        if self._centroids is None:
            return super()._tail_rows()
        return max(self._ivf_synced - self._ivf_base, 0)

    def scanned_bytes_per_query(self, top_k: int) -> int:
        with self._lock:
            if self._dirty and int(self._valid.sum()):
                self._sync_device()
            if self._centroids is None:
                return super().scanned_bytes_per_query(top_k)  # the exact regime
            cap = int(self._buckets.shape[1])
            d = self.dimensions
            itemsize = self._buckets.element_size()
            probe_bytes = self.nlist * d * 4  # the f32 centroid product
            tail_bytes = self._ivf_tail_buf.numel() * self._ivf_tail_buf.element_size() + self._ivf_tail_valid.numel()
            mask_bytes = self.nprobe * cap  # the probed lists' masks
            k2 = min(top_k * self.rescore_multiplier, self.nprobe * cap)
            if self._q_buckets is not None and top_k * self.rescore_multiplier < self.nprobe * cap:
                scan = self.nprobe * cap * (d + 4 if self.quantization == "int8" else self.pq_m)
                return probe_bytes + scan + k2 * d * itemsize + tail_bytes + mask_bytes
            return probe_bytes + self.nprobe * cap * d * itemsize + tail_bytes + mask_bytes
