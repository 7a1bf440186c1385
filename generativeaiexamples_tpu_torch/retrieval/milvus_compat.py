"""Milvus-backed store (port of the JAX package's
``retrieval/milvus_compat.py``).

The upstream's default backend is an external Milvus service.  This
adapter keeps that option for users migrating with an existing Milvus
deployment; the ``pymilvus`` client library is imported only when a store is built
without an injected client.
"""

from __future__ import annotations

from typing import Sequence

from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk, VectorStore

_COLLECTION = "generativeaiexamples_tpu"


class MilvusVectorStore(VectorStore):
    def __init__(self, dimensions: int, url: str, collection: str = _COLLECTION, *, client=None):
        """``client`` injects a duck-typed MilvusClient (the hermetic tests
        drive the adapter through a fake; production uses pymilvus)."""
        if client is None:
            try:
                from pymilvus import MilvusClient  # type: ignore
            except ImportError as exc:
                raise RuntimeError(
                    "vector_store.name=milvus requires the pymilvus driver; "
                    "install it or use the in-process 'tpu'/'native' backends"
                ) from exc
            client = MilvusClient(uri=url)
        self.dimensions = dimensions
        self._client = client
        self._collection = collection
        if not self._client.has_collection(collection):
            self._client.create_collection(
                collection,
                dimension=dimensions,
                metric_type="IP",
                auto_id=True,  # server-assigned PKs; chunk_id carries ours
            )

    def add(self, chunks: Sequence[Chunk], embeddings) -> list[str]:
        rows = [
            {"vector": list(map(float, e)), "text": c.text, "source": c.source, "chunk_id": c.id}
            for c, e in zip(chunks, embeddings)
        ]
        self._client.insert(self._collection, rows)
        self._bump_version()
        return [c.id for c in chunks]

    def search(self, embedding, top_k: int) -> list[ScoredChunk]:
        res = self._client.search(
            self._collection,
            data=[list(map(float, embedding))],
            limit=top_k,
            output_fields=["text", "source", "chunk_id"],
        )
        out = []
        for hit in res[0]:
            ent = hit.get("entity", {})
            out.append(
                ScoredChunk(
                    Chunk(text=ent.get("text", ""), source=ent.get("source", ""), id=ent.get("chunk_id", "")),
                    float(hit.get("distance", 0.0)),
                )
            )
        return out

    def sources(self) -> list[str]:
        res = self._client.query(self._collection, filter="", output_fields=["source"], limit=16384)
        return sorted({r["source"] for r in res})

    def delete_source(self, source: str) -> int:
        # Escape the filename before interpolating it into the filter
        # expression (filenames are user-supplied via upload).
        escaped = source.replace("\\", "\\\\").replace('"', '\\"')
        res = self._client.delete(self._collection, filter=f'source == "{escaped}"')
        # pymilvus versions differ: a list of deleted PKs (<=2.4.x) or a
        # {"delete_count": n} dict (newer MilvusClient).
        if isinstance(res, dict):
            removed = int(res.get("delete_count", 0))
        else:
            removed = len(res) if isinstance(res, list) else 0
        if removed:
            self._bump_version()
        return removed

    def __len__(self) -> int:
        stats = self._client.get_collection_stats(self._collection)
        return int(stats.get("row_count", 0))
