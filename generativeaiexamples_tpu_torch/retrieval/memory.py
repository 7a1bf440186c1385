"""In-memory exact vector store (numpy), with optional disk persistence (a
copy of the JAX package's ``retrieval/memory.py``).

The exact store on the card (``retrieval.gpu``) keeps one as its f32 host
mirror, and saves and loads through it: ``vectors.npz`` + ``chunks.json``,
the JAX package's format.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk, VectorStore


class MemoryVectorStore(VectorStore):
    def __init__(self, dimensions: int) -> None:
        self.dimensions = dimensions
        self._vecs = np.zeros((0, dimensions), dtype=np.float32)
        self._chunks: list[Chunk] = []

    def add(
        self, chunks: Sequence[Chunk], embeddings: Sequence[Sequence[float]]
    ) -> list[str]:
        if len(chunks) != len(embeddings):
            raise ValueError("chunks and embeddings length mismatch")
        if not chunks:
            return []
        mat = np.asarray(embeddings, dtype=np.float32)
        if mat.shape != (len(chunks), self.dimensions):
            raise ValueError(
                f"embeddings shape {mat.shape} != ({len(chunks)}, {self.dimensions})"
            )
        self._vecs = np.concatenate([self._vecs, mat], axis=0)
        self._chunks.extend(chunks)
        self._bump_version()
        return [c.id for c in chunks]

    def search(
        self, embedding: Sequence[float], top_k: int
    ) -> list[ScoredChunk]:
        if not self._chunks or top_k <= 0:
            return []
        q = np.asarray(embedding, dtype=np.float32)
        scores = self._vecs @ q
        k = min(top_k, len(self._chunks))
        idx = np.argpartition(-scores, k - 1)[:k]
        idx = idx[np.argsort(-scores[idx])]
        return [ScoredChunk(self._chunks[i], float(scores[i])) for i in idx]

    def sources(self) -> list[str]:
        seen: dict[str, None] = {}
        for c in self._chunks:
            seen.setdefault(c.source)
        return list(seen)

    def delete_source(self, source: str) -> int:
        keep = [i for i, c in enumerate(self._chunks) if c.source != source]
        removed = len(self._chunks) - len(keep)
        if removed:
            self._vecs = self._vecs[keep]
            self._chunks = [self._chunks[i] for i in keep]
            self._bump_version()
        return removed

    def __len__(self) -> int:
        return len(self._chunks)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(os.path.join(path, "vectors.npz"), vecs=self._vecs)
        payload = [
            {"id": c.id, "text": c.text, "source": c.source, "metadata": c.metadata}
            for c in self._chunks
        ]
        with open(os.path.join(path, "chunks.json"), "w", encoding="utf-8") as fh:
            json.dump(
                {
                    "dimensions": self.dimensions,
                    # The monotonic mutation counter must survive the
                    # round-trip: caches stamp entries with it, and a
                    # reload that restarts at 0 would let stale stamps
                    # alias the recovered corpus.
                    "version": self.version(),
                    "chunks": payload,
                },
                fh,
            )

    @classmethod
    def load(cls, path: str) -> "MemoryVectorStore":
        with open(os.path.join(path, "chunks.json"), "r", encoding="utf-8") as fh:
            data = json.load(fh)
        store = cls(data["dimensions"])
        store._restore_version(data.get("version", 0))
        store._vecs = np.load(os.path.join(path, "vectors.npz"))["vecs"]
        store._chunks = [
            Chunk(
                text=c["text"],
                source=c["source"],
                metadata=c["metadata"],
                id=c["id"],
            )
            for c in data["chunks"]
        ]
        return store
