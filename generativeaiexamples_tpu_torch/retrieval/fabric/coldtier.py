"""Host-RAM cold tier for sharded retrieval partitions (port of the JAX
package's ``retrieval/fabric/coldtier.py``).

A fabric shard whose hit rate has decayed does not deserve device memory:
its scoring buffer is demoted to host RAM as PQ codes (``pq_m`` subspaces,
256 centroids each, one byte a subspace) plus the original f32 rows.
Searching a cold partition is two-stage:

  1. **Stage 1, host ADC scan.**  A per-subspace lookup table turns the
     query into ``pq_m`` gathers over the code matrix: ``rows * pq_m``
     bytes of host traffic instead of ``rows * dim * 4`` of device traffic.
  2. **Stage 2, exact rescore.**  The stage-1 survivors' f32 rows are
     prefetched to the fabric's device by :class:`HostPrefetcher` and
     rescored exactly there, so reported scores stay exact, like the hot
     tier's quantized modes.

The k-means and the codebook training are the reference's numpy, copied;
the encoder computes the reference's expression in row blocks spread over
threads: codebooks and codes are bit for bit the reference's.

Deliberate difference: the reference's prefetch is a round trip (the rows
go to the device with ``jax.device_put``, come back to numpy and are
rescored with ``rows @ q`` on the host; with no usable backend it passes
the rows through).  Here a CUDA fabric sends the rows pinned and
non-blocking and rescores them on the card in full f32
(``retrieval/gpu.py::full_f32``, never TF32), and a failure raises instead
of falling back.  The card's sum order is cuBLAS's, not numpy's, so a
cold score may differ from the reference's in its last bits; ranks differ
only where two scores lie that close.  A CPU fabric passes the rows
through and rescores in numpy: bit for bit the reference.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import host_to_device
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.gpu import full_f32

logger = get_logger(__name__)

_PQ_CENTROIDS = 256  # uint8 code space, one byte per subspace
_ENCODE_ROWS = 65536  # rows a worker encodes at a time


def _kmeans_np(vecs: np.ndarray, k: int, iters: int, seed: int) -> np.ndarray:
    """Plain numpy Lloyd's k-means (the cold tier must train without a
    device).  Oversized ``k`` collapses to the sample count; empty
    clusters re-seed from the farthest points so codebooks stay full."""
    n = vecs.shape[0]
    k = max(1, min(k, n))
    rng = np.random.default_rng(seed)
    centers = vecs[rng.choice(n, size=k, replace=False)].astype(np.float32)
    for _ in range(max(1, iters)):
        # Squared-L2 assignment via the dot-product expansion.
        d2 = (
            (vecs * vecs).sum(axis=1, keepdims=True)
            - 2.0 * (vecs @ centers.T)
            + (centers * centers).sum(axis=1)[None, :]
        )
        assign = np.argmin(d2, axis=1)
        for c in range(k):
            members = vecs[assign == c]
            if len(members):
                centers[c] = members.mean(axis=0)
            else:
                centers[c] = vecs[int(np.argmax(d2.min(axis=1)))]
    return centers


def train_codebooks(
    vecs: np.ndarray,
    pq_m: int,
    *,
    iters: int = 8,
    seed: int = 0,
    train_cap: int = 16384,
) -> np.ndarray:
    """Per-subspace PQ codebooks ``(pq_m, 256, dim/pq_m)``, trained on at
    most ``train_cap`` sampled rows (demotion must not cost a full k-means
    over the corpus)."""
    n, dim = vecs.shape
    if dim % pq_m:
        raise ValueError(f"pq_m={pq_m} must divide dim={dim}")
    dsub = dim // pq_m
    sample = vecs
    if n > train_cap:
        rng = np.random.default_rng(seed)
        sample = vecs[rng.choice(n, size=train_cap, replace=False)]
    books = np.zeros((pq_m, _PQ_CENTROIDS, dsub), dtype=np.float32)
    for m in range(pq_m):
        sub = np.ascontiguousarray(sample[:, m * dsub : (m + 1) * dsub])
        centers = _kmeans_np(sub, _PQ_CENTROIDS, iters, seed + m)
        books[m, : centers.shape[0]] = centers
        if centers.shape[0] < _PQ_CENTROIDS:
            # Pad with the first centroid so code values stay valid.
            books[m, centers.shape[0] :] = centers[0]
    return books


def encode(vecs: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Assign every row to its nearest centroid per subspace: uint8 codes
    ``(rows, pq_m)``."""
    pq_m, k, dsub = codebooks.shape
    codes = np.zeros((vecs.shape[0], pq_m), dtype=np.uint8)
    cb2 = [(cb * cb).sum(axis=1)[None, :] for cb in codebooks]

    def encode_rows(lo: int) -> None:
        # (x2 - 2.0 * (x @ c.T)) + c2 per subspace, in one buffer: -2.0 *
        # dot is exact and x2 + (-2 dot) rounds as x2 - 2 dot, so each
        # row's codes are the whole-array expression's bit for bit.
        block = vecs[lo : lo + _ENCODE_ROWS]
        d2 = np.empty((len(block), k), dtype=np.float32)
        for m in range(pq_m):
            sub = block[:, m * dsub : (m + 1) * dsub]
            np.matmul(sub, codebooks[m].T, out=d2)
            d2 *= -2.0
            d2 += (sub * sub).sum(axis=1, keepdims=True)
            d2 += cb2[m]
            codes[lo : lo + len(block), m] = d2.argmin(axis=1)

    starts = range(0, vecs.shape[0], _ENCODE_ROWS)
    # numpy releases the interpreter lock in the products and reductions.
    with ThreadPoolExecutor(max_workers=max(1, min(len(starts), os.cpu_count() or 1, 8))) as pool:
        list(pool.map(encode_rows, starts))
    return codes


class HostPrefetcher:
    """Stage-2 rows to the fabric's device, and their exact rescore.

    ``prefetch()`` starts the host-to-device copy (pinned, non-blocking on
    CUDA) and returns the device tensor; ``rescore()`` scores it against
    the query on the device in full f32.  On the CPU the rows pass through
    and the rescore is numpy's ``rows @ q``, the reference's.  Nothing
    falls back: a failed copy or product raises."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.prefetch_bytes_total = 0
        self.prefetches_total = 0
        self._lock = threading.Lock()

    def prefetch(self, rows: np.ndarray):
        with self._lock:
            self.prefetches_total += 1
            self.prefetch_bytes_total += int(rows.nbytes)
        if self.device.type == "cpu":
            return rows
        return host_to_device(torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32)), self.device)

    @staticmethod
    def rescore(handle, q: np.ndarray) -> np.ndarray:
        """Exact f32 scores of the prefetched rows against ``q`` (host)."""
        if isinstance(handle, np.ndarray):
            return handle @ q
        qd = host_to_device(torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)), handle.device)
        with full_f32(handle.device):
            return (handle @ qd).cpu().numpy()


@dataclasses.dataclass
class ColdPartition:
    """One demoted shard: PQ codes + f32 rows in host RAM."""

    chunks: list[Chunk]
    vecs: np.ndarray  # (n, dim) float32: stage-2 rescore rows
    codes: np.ndarray  # (n, pq_m) uint8: stage-1 scan codes
    codebooks: np.ndarray  # (pq_m, 256, dim/pq_m) float32
    valid: np.ndarray  # (n,) bool delete mask

    @classmethod
    def from_rows(
        cls,
        chunks: Sequence[Chunk],
        vecs: np.ndarray,
        *,
        pq_m: int,
        seed: int = 0,
    ) -> "ColdPartition":
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        books = train_codebooks(vecs, pq_m, seed=seed)
        return cls(
            chunks=list(chunks),
            vecs=vecs,
            codes=encode(vecs, books),
            codebooks=books,
            valid=np.ones(len(chunks), dtype=bool),
        )

    # -- capacity ----------------------------------------------------------

    def rows(self) -> int:
        return int(self.valid.sum())

    def host_bytes(self) -> int:
        return int(self.vecs.nbytes + self.codes.nbytes + self.codebooks.nbytes + self.valid.nbytes)

    def scan_bytes(self, top_k: int, rescore_k: int) -> tuple[int, int]:
        """(host, device) bytes one query reads: the code scan + masks on
        the host, the prefetched rescore rows on the device."""
        dim = self.vecs.shape[1]
        host = int(self.codes.nbytes) + int(self.valid.nbytes)
        hbm = min(rescore_k, len(self.chunks)) * dim * 4
        return host, hbm

    # -- mutation ----------------------------------------------------------

    def delete_source(self, source: str) -> int:
        hit = np.fromiter((c.source == source for c in self.chunks), dtype=bool, count=len(self.chunks))
        hit &= self.valid
        removed = int(hit.sum())
        if removed:
            self.valid[hit] = False
        return removed

    def sources(self) -> list[str]:
        seen: dict[str, None] = {}
        for i in np.flatnonzero(self.valid):
            seen.setdefault(self.chunks[i].source)
        return list(seen)

    def live_rows(self) -> tuple[list[Chunk], np.ndarray]:
        """Compacted (chunks, vecs): the promotion payload."""
        idx = np.flatnonzero(self.valid)
        return [self.chunks[i] for i in idx], self.vecs[idx]

    # -- search ------------------------------------------------------------

    def scan(
        self,
        embedding: Sequence[float],
        top_k: int,
        rescore_k: int,
        prefetcher: Optional[HostPrefetcher] = None,
    ) -> list[tuple[int, float]]:
        """Two-stage search: ADC code scan, then exact rescore of the
        survivors.  Returns ``(row_index, exact_score)`` pairs, best first;
        the PQ approximation only ranks the stage-1 cut.  Without a
        prefetcher (the fallback rung) the rescore runs in numpy."""
        if top_k <= 0 or not len(self.chunks) or not self.valid.any():
            return []
        q = np.asarray(embedding, dtype=np.float32)
        pq_m, _, dsub = self.codebooks.shape
        # Stage 1: LUT per subspace, gather-accumulate over the codes.
        luts = np.einsum("mcd,md->mc", self.codebooks, q.reshape(pq_m, dsub))  # (pq_m, 256)
        approx = luts[np.arange(pq_m)[None, :], self.codes.astype(np.intp)].sum(axis=1)
        approx[~self.valid] = -np.inf
        k2 = min(max(rescore_k, top_k), len(self.chunks))
        cand = np.argpartition(-approx, k2 - 1)[:k2]
        cand = cand[np.isfinite(approx[cand])]
        if not len(cand):
            return []
        # Stage 2: exact rescore of the candidates' rows.
        rows = self.vecs[cand]
        if prefetcher is not None:
            exact = HostPrefetcher.rescore(prefetcher.prefetch(rows), q)
        else:
            exact = rows @ q
        order = np.argsort(-exact, kind="stable")[: min(top_k, len(cand))]
        return [(int(cand[i]), float(exact[i])) for i in order]
