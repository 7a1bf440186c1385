"""Timestamped transcript store (sqlite; a copy of
``streaming/timestamps.py``).

Parity target: ``fm-asr-streaming-rag/chain-server/database.py:38-93`` —
every stored chunk is recorded with its time window so queries can be
scoped "in the last N minutes" / "around time T"; the RAG chains join
vector hits back to their timestamps.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Optional


class TimestampDatabase:
    """Thread-safe sqlite store of (source, text, t_first, t_last)."""

    def __init__(self, path: str = ":memory:") -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(
                """CREATE TABLE IF NOT EXISTS chunks (
                    id INTEGER PRIMARY KEY AUTOINCREMENT,
                    source TEXT NOT NULL,
                    text TEXT NOT NULL,
                    t_first REAL NOT NULL,
                    t_last REAL NOT NULL
                )"""
            )
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_chunks_time ON chunks (t_last)"
            )
            self._conn.commit()

    def insert(self, text: str, source: str, t_first: float, t_last: float) -> int:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO chunks (source, text, t_first, t_last) VALUES (?,?,?,?)",
                (source, text, t_first, t_last),
            )
            self._conn.commit()
            return int(cur.lastrowid)

    def recent(self, seconds: float, now: float, limit: int = 20) -> list[dict]:
        """Chunks whose window overlaps [now - seconds, now], newest first."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT source, text, t_first, t_last FROM chunks "
                "WHERE t_last >= ? ORDER BY t_last DESC LIMIT ?",
                (now - seconds, limit),
            ).fetchall()
        return [self._row(r) for r in rows]

    def window(self, t_start: float, t_end: float, limit: int = 50) -> list[dict]:
        """Chunks overlapping [t_start, t_end] in time order."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT source, text, t_first, t_last FROM chunks "
                "WHERE t_last >= ? AND t_first <= ? ORDER BY t_first LIMIT ?",
                (t_start, t_end, limit),
            ).fetchall()
        return [self._row(r) for r in rows]

    def all_chunks(self, limit: int = 1000) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT source, text, t_first, t_last FROM chunks "
                "ORDER BY t_first LIMIT ?",
                (limit,),
            ).fetchall()
        return [self._row(r) for r in rows]

    def count(self) -> int:
        with self._lock:
            return int(self._conn.execute("SELECT COUNT(*) FROM chunks").fetchone()[0])

    @staticmethod
    def _row(r) -> dict:
        return {"source": r[0], "text": r[1], "t_first": r[2], "t_last": r[3]}

    def close(self) -> None:
        with self._lock:
            self._conn.close()
