"""pgvector-backed store (port of the JAX package's
``retrieval/pgvector_compat.py``).

Postgres with pgvector as an external vector database; the ``psycopg2``
client library is imported only when a store is built without an
injected connection.
"""

from __future__ import annotations

from typing import Sequence

from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk, VectorStore

_TABLE = "gaie_tpu_chunks"


class PgVectorStore(VectorStore):
    def __init__(self, dimensions: int, url: str, table_suffix: str = "default", *, conn=None):
        """``conn`` injects a duck-typed DB-API connection (the hermetic
        tests drive the adapter's SQL through a fake; production uses
        psycopg2)."""
        if conn is None:
            try:
                import psycopg2  # type: ignore
            except ImportError as exc:
                raise RuntimeError(
                    "vector_store.name=pgvector requires psycopg2; install "
                    "it or use the in-process 'tpu'/'native' backends"
                ) from exc
            conn = psycopg2.connect(url)
        self._table = f"{_TABLE}_{table_suffix}" if table_suffix else _TABLE
        self.dimensions = dimensions
        self._conn = conn
        self._conn.autocommit = True
        with self._conn.cursor() as cur:
            cur.execute("CREATE EXTENSION IF NOT EXISTS vector")
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {self._table} ("
                "id TEXT PRIMARY KEY, text TEXT, source TEXT, "
                f"embedding vector({dimensions}))"
            )

    def add(self, chunks: Sequence[Chunk], embeddings) -> list[str]:
        with self._conn.cursor() as cur:
            for c, e in zip(chunks, embeddings):
                cur.execute(
                    f"INSERT INTO {self._table} (id, text, source, embedding) "
                    "VALUES (%s, %s, %s, %s) ON CONFLICT (id) DO NOTHING",
                    (c.id, c.text, c.source, list(map(float, e))),
                )
        self._bump_version()
        return [c.id for c in chunks]

    def search(self, embedding, top_k: int) -> list[ScoredChunk]:
        with self._conn.cursor() as cur:
            cur.execute(
                f"SELECT id, text, source, 1 - (embedding <=> %s::vector) "
                f"FROM {self._table} ORDER BY embedding <=> %s::vector LIMIT %s",
                (list(map(float, embedding)), list(map(float, embedding)), top_k),
            )
            rows = cur.fetchall()
        return [ScoredChunk(Chunk(text=t, source=s, id=i), float(score)) for i, t, s, score in rows]

    def sources(self) -> list[str]:
        with self._conn.cursor() as cur:
            cur.execute(f"SELECT DISTINCT source FROM {self._table}")
            return [r[0] for r in cur.fetchall()]

    def delete_source(self, source: str) -> int:
        with self._conn.cursor() as cur:
            cur.execute(f"DELETE FROM {self._table} WHERE source = %s", (source,))
            removed = cur.rowcount
        if removed:
            self._bump_version()
        return removed

    def __len__(self) -> int:
        with self._conn.cursor() as cur:
            cur.execute(f"SELECT COUNT(*) FROM {self._table}")
            return int(cur.fetchone()[0])
