"""Rolling-transcript accumulator (a copy of ``streaming/accumulator.py``:
pure Python).

Parity target: ``fm-asr-streaming-rag/chain-server/accumulator.py:24-48`` —
accumulate streaming ASR text, emit full chunks (1024 chars with 200-char
overlap) to the vector store + timestamp database.  The reference carries
an acknowledged multi-stream race TODO (``accumulator.py:22-23``); this
implementation locks per source: concurrent appends to one stream
serialize (chunk order within a source is part of the contract — the
overlap stitching is meaningless out of order), while independent
streams never contend — one slow sink (a vector-store insert mid-WAL
fsync) cannot stall every other channel's transcript.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CHUNK_CHARS = 1024
OVERLAP_CHARS = 200


class TextAccumulator:
    """Accumulates text per source; flushes overlapping chunks via callback.

    ``sink(chunk_text, source, t_first, t_last)`` is called for every full
    chunk; timestamps are the wall-clock of the first/last update that
    contributed to the chunk.  The sink runs under that source's lock, so
    per-source chunk delivery is ordered; sinks must not call back into
    the accumulator for the same source.
    """

    def __init__(
        self,
        sink: Callable[[str, str, float, float], None],
        chunk_chars: int = CHUNK_CHARS,
        overlap_chars: int = OVERLAP_CHARS,
    ) -> None:
        if overlap_chars >= chunk_chars:
            raise ValueError("overlap must be smaller than chunk size")
        self.sink = sink
        self.chunk_chars = chunk_chars
        self.overlap_chars = overlap_chars
        # Master lock guards only the lock/buffer dict shape; each
        # source's buffer is guarded by its own lock for the duration of
        # an update (sink call included).
        self._master = threading.Lock()
        self._locks: dict[str, threading.Lock] = {}
        self._buffers: dict[str, str] = {}
        self._t_first: dict[str, float] = {}

    def _source_lock(self, source: str) -> threading.Lock:
        with self._master:
            lock = self._locks.get(source)
            if lock is None:
                lock = threading.Lock()
                self._locks[source] = lock
            return lock

    def update(self, text: str, source: str = "default", now: Optional[float] = None) -> int:
        """Append text; flush any completed chunks. Returns chunks flushed."""
        if not text:
            return 0
        now = time.time() if now is None else now
        flushed = 0
        with self._source_lock(source):
            buf = self._buffers.get(source, "")
            if not buf:
                self._t_first[source] = now
                buf = text.strip()
            else:
                # No outer strip: the carried overlap tail may legitimately
                # start with whitespace and must be preserved byte-for-byte.
                buf = f"{buf} {text.strip()}"
            while len(buf) >= self.chunk_chars:
                chunk, buf = buf[: self.chunk_chars], buf[self.chunk_chars - self.overlap_chars :]
                self.sink(chunk, source, self._t_first[source], now)
                self._t_first[source] = now
                flushed += 1
            self._buffers[source] = buf
        return flushed

    def flush(self, source: str = "default", now: Optional[float] = None) -> int:
        """Force-flush the partial buffer (end of stream)."""
        now = time.time() if now is None else now
        with self._source_lock(source):
            buf = self._buffers.pop(source, "").strip()
            if not buf:
                return 0
            self.sink(buf, source, self._t_first.pop(source, now), now)
            return 1

    def pending(self, source: str = "default") -> str:
        with self._source_lock(source):
            return self._buffers.get(source, "")
