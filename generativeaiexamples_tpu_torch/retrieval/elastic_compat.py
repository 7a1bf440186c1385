"""Elasticsearch-backed store (port of the JAX package's
``retrieval/elastic_compat.py``).

Speaks the ES REST API directly, with a ``dense_vector`` mapping and the
kNN search API, so a deployment already running Elasticsearch can point
``APP_VECTORSTORE_NAME=elasticsearch`` at it.  Deliberate difference: the
reference sends its requests with ``requests``, which the card machine
does not have; this adapter uses the port's ``core/httpclient.py`` (the
standard library's ``http.client``) with the same requests and bodies, and
a 4xx/5xx answer raises ``HTTPStatusError`` where the reference raises
``requests.HTTPError``.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

from generativeaiexamples_tpu_torch.core.httpclient import HTTPStatusError, request
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk, VectorStore

logger = get_logger(__name__)

_INDEX = "generativeaiexamples-tpu"


class ElasticsearchVectorStore(VectorStore):
    def __init__(
        self, dimensions: int, url: str = "http://localhost:9200", index: str = _INDEX, *, timeout: float = 30.0
    ) -> None:
        self.dimensions = dimensions
        self._base = url.rstrip("/")
        self._index = index.lower()
        self._timeout = timeout
        status, body = request("HEAD", f"{self._base}/{self._index}", timeout=self._timeout)
        if status not in (200, 404):
            # A booting or unauthorized cluster must not be mistaken for
            # "index exists": the first add() would then auto-create a
            # dynamic (non-dense_vector) mapping and break kNN for good.
            raise HTTPStatusError(status, body)
        if status == 404:
            mapping = {
                "mappings": {
                    "properties": {
                        "vector": {"type": "dense_vector", "dims": dimensions, "index": True,
                                   "similarity": "dot_product"},
                        "text": {"type": "text"},
                        "source": {"type": "keyword"},
                        "chunk_id": {"type": "keyword"},
                    }
                }
            }
            self._call("PUT", f"/{self._index}", mapping)

    def _call(self, method: str, path: str, payload=None, *, ndjson: Optional[str] = None) -> dict:
        """One request; a 4xx/5xx raises, a body parses as JSON."""
        if ndjson is not None:
            body, ctype = ndjson.encode(), "application/x-ndjson"
        elif payload is not None:
            body, ctype = json.dumps(payload).encode(), "application/json"
        else:
            body, ctype = None, None
        status, data = request(method, f"{self._base}{path}", body, {"Content-Type": ctype} if ctype else None,
                               timeout=self._timeout)
        if status >= 400:
            raise HTTPStatusError(status, data)
        return json.loads(data) if data else {}

    def _normalize(self, embedding) -> list[float]:
        # dot_product similarity requires unit vectors; normalizing here
        # keeps scores identical to the in-process cosine backends.  Zero
        # vectors never reach here: add() skips zero-embedding chunks and
        # search() short-circuits zero queries.
        vec = [float(x) for x in embedding]
        norm = sum(x * x for x in vec) ** 0.5 or 1.0
        return [x / norm for x in vec]

    def add(self, chunks: Sequence[Chunk], embeddings) -> list[str]:
        lines = []
        for chunk, emb in zip(chunks, embeddings):
            if not any(float(x) for x in emb):
                # As in the in-process backends, a zero embedding scores 0
                # against every query and is never retrieved: it is not
                # indexed, and its id is still returned.
                logger.warning("skipping zero-embedding chunk %s (never retrievable)", chunk.id)
                continue
            lines.append(json.dumps({"index": {"_index": self._index}}))
            lines.append(json.dumps({"vector": self._normalize(emb), "text": chunk.text, "source": chunk.source,
                                     "chunk_id": chunk.id}))
        if not lines:
            return [c.id for c in chunks]
        body = self._call("POST", "/_bulk?refresh=wait_for", ndjson="\n".join(lines) + "\n")
        if body.get("errors"):
            failed = [
                item.get("index", {}).get("error")
                for item in body.get("items", [])
                if item.get("index", {}).get("error")
            ]
            raise RuntimeError(
                f"elasticsearch rejected {len(failed)} of {len(chunks)} "
                f"documents (first: {failed[0] if failed else 'unknown'})"
            )
        self._bump_version()
        return [c.id for c in chunks]

    def search(self, embedding, top_k: int) -> list[ScoredChunk]:
        if not any(float(x) for x in embedding):
            return []
        body = {
            "knn": {"field": "vector", "query_vector": self._normalize(embedding), "k": top_k,
                    "num_candidates": max(50, top_k * 4)},
            "_source": ["text", "source", "chunk_id"],
        }
        hits = self._call("POST", f"/{self._index}/_search", body).get("hits", {}).get("hits", [])
        # ES dot_product kNN reports _score = (1 + cosine) / 2; every other
        # backend (and the retriever's score_threshold) works in raw cosine.
        return [
            ScoredChunk(
                Chunk(text=h["_source"].get("text", ""), source=h["_source"].get("source", ""),
                      id=h["_source"].get("chunk_id", "")),
                2.0 * float(h.get("_score", 0.0)) - 1.0,
            )
            for h in hits
        ]

    def sources(self) -> list[str]:
        body = {"size": 0, "aggs": {"srcs": {"terms": {"field": "source", "size": 10000}}}}
        buckets = self._call("POST", f"/{self._index}/_search", body).get("aggregations", {}).get(
            "srcs", {}).get("buckets", [])
        return sorted(b["key"] for b in buckets)

    def delete_source(self, source: str) -> int:
        body = {"query": {"term": {"source": source}}}
        removed = int(self._call("POST", f"/{self._index}/_delete_by_query?refresh=true", body).get("deleted", 0))
        if removed:
            self._bump_version()
        return removed

    def __len__(self) -> int:
        return int(self._call("GET", f"/{self._index}/_count").get("count", 0))
