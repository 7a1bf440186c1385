"""ctypes bindings for the native C++ vecsearch library (port of the JAX
package's ``retrieval/native.py``).

The CPU engine of the retrieval layer: exact and IVF search in
``native/vecsearch.cpp``, compiled on first use by the port's
``utils/native_build.py`` into ``build/torch_native/``.  A host store by
design: it takes no ``device``.  Built with the reference's flags, it gives
the reference's ids and scores bit for bit on the same host.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk, VectorStore

logger = get_logger(__name__)

_configured = False


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the vecsearch shared library."""
    from generativeaiexamples_tpu_torch.utils.native_build import load_native_library

    global _configured
    lib = load_native_library("vecsearch")
    if not _configured:
        lib.vs_create.restype = ctypes.c_void_p
        lib.vs_create.argtypes = [ctypes.c_int]
        lib.vs_free.argtypes = [ctypes.c_void_p]
        lib.vs_size.restype = ctypes.c_int64
        lib.vs_size.argtypes = [ctypes.c_void_p]
        lib.vs_valid_count.restype = ctypes.c_int64
        lib.vs_valid_count.argtypes = [ctypes.c_void_p]
        lib.vs_add.restype = ctypes.c_int64
        lib.vs_add.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        lib.vs_set_valid.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        lib.vs_search.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.vs_build_ivf.restype = ctypes.c_int
        lib.vs_build_ivf.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
        lib.vs_search_ivf.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.vs_nlist.restype = ctypes.c_int
        lib.vs_nlist.argtypes = [ctypes.c_void_p]
        _configured = True
    return lib


def _as_float_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeVectorStore(VectorStore):
    """C++ exact / IVF similarity search with Python-side payloads.

    ``index_type`` ``exact`` scans all rows; ``ivf`` k-means-clusters the
    corpus (nlist 64, nprobe 16 by default, Milvus's) and probes a subset.
    The IVF index is built once the corpus reaches ``ivf_build_threshold``
    rows; later rows join the existing lists."""

    def __init__(
        self,
        dimensions: int,
        *,
        index_type: str = "exact",
        nlist: int = 64,
        nprobe: int = 16,
        ivf_build_threshold: int = 2048,
        kmeans_iters: int = 8,
    ) -> None:
        self.dimensions = dimensions
        self.index_type = index_type
        self.nlist = nlist
        self.nprobe = nprobe
        self.ivf_build_threshold = ivf_build_threshold
        self.kmeans_iters = kmeans_iters
        self._lib = load_library()
        self._handle = ctypes.c_void_p(self._lib.vs_create(dimensions))
        self._chunks: list[Chunk] = []
        self._lock = threading.Lock()

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        try:
            if getattr(self, "_handle", None):
                self._lib.vs_free(self._handle)
        except Exception:
            pass

    def add(self, chunks: Sequence[Chunk], embeddings: Sequence[Sequence[float]]) -> list[str]:
        if len(chunks) != len(embeddings):
            raise ValueError("chunks and embeddings length mismatch")
        if not chunks:
            return []
        mat = np.ascontiguousarray(embeddings, dtype=np.float32)
        if mat.shape != (len(chunks), self.dimensions):
            raise ValueError(f"embeddings shape {mat.shape} != ({len(chunks)}, {self.dimensions})")
        with self._lock:
            self._lib.vs_add(self._handle, len(chunks), _as_float_ptr(mat))
            self._chunks.extend(chunks)
            if (
                self.index_type == "ivf"
                and self._lib.vs_nlist(self._handle) == 0
                and len(self._chunks) >= self.ivf_build_threshold
            ):
                built = self._lib.vs_build_ivf(self._handle, self.nlist, self.kmeans_iters, 0)
                logger.info("built IVF index with %d lists", built)
            self._bump_version()
        return [c.id for c in chunks]

    def search(self, embedding: Sequence[float], top_k: int) -> list[ScoredChunk]:
        if not self._chunks or top_k <= 0:
            return []
        q = np.ascontiguousarray(embedding, dtype=np.float32)
        k = min(top_k, len(self._chunks))
        out_idx = np.empty((k,), dtype=np.int64)
        out_score = np.empty((k,), dtype=np.float32)
        with self._lock:
            if self.index_type == "ivf" and self._lib.vs_nlist(self._handle) > 0:
                self._lib.vs_search_ivf(
                    self._handle, _as_float_ptr(q), k, self.nprobe,
                    out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _as_float_ptr(out_score),
                )
            else:
                self._lib.vs_search(
                    self._handle, _as_float_ptr(q), k,
                    out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _as_float_ptr(out_score),
                )
        out: list[ScoredChunk] = []
        for i, s in zip(out_idx, out_score):
            if i < 0 or not np.isfinite(s):
                continue
            out.append(ScoredChunk(self._chunks[int(i)], float(s)))
        return out

    def sources(self) -> list[str]:
        with self._lock:
            seen: dict[str, None] = {}
            for c in self._chunks:
                if c.metadata.get("_deleted") is None:
                    seen.setdefault(c.source)
            return list(seen)

    def delete_source(self, source: str) -> int:
        removed = 0
        with self._lock:
            for i, c in enumerate(self._chunks):
                if c.source == source and c.metadata.get("_deleted") is None:
                    self._lib.vs_set_valid(self._handle, i, 0)
                    c.metadata["_deleted"] = True
                    removed += 1
            if removed:
                self._bump_version()
        return removed

    def __len__(self) -> int:
        return int(self._lib.vs_valid_count(self._handle))
