"""Per-request record of cache decisions.

The cache fires deep inside the retrieval stack (or inside the
micro-batcher's worker thread), but the *response* must carry
``cached``/``cache_tier`` fields and an ``X-Cache`` header.  A
:class:`CacheLog` is the channel, exactly mirroring
:class:`~..resilience.degrade.DegradeLog`: the chain server opens one per
request, the retriever/chain mark hits on it, and the server reads it
when composing the response.  Batched retrieval items carry their own
log references because contextvars do not cross the batcher's worker
thread.

A copy of the JAX package's ``cache/log.py``; the port imports nothing of it.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Iterator, Optional


class CacheLog:
    """Which cache tier (if any) served this request."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tier = ""
        self._entry: Optional[object] = None
        self._answer = False

    def mark_hit(self, tier: str, entry: Optional[object] = None) -> None:
        with self._lock:
            self._tier = tier
            if entry is not None:
                self._entry = entry

    def note_entry(self, entry: Optional[object]) -> None:
        """Record the cache entry backing this request WITHOUT marking a
        hit — the retriever notes freshly admitted entries here so the
        chain can attach a cleanly generated answer to them."""
        with self._lock:
            if entry is not None:
                self._entry = entry

    def mark_answer(self) -> None:
        """The full answer (not just the retrieval set) came from cache."""
        with self._lock:
            self._answer = True

    @property
    def tier(self) -> str:
        with self._lock:
            return self._tier

    @property
    def entry(self) -> Optional[object]:
        with self._lock:
            return self._entry

    @property
    def answer_hit(self) -> bool:
        with self._lock:
            return self._answer

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._tier)


_CURRENT: contextvars.ContextVar[Optional[CacheLog]] = contextvars.ContextVar(
    "gaie_cache_log", default=None
)


def current_cache_log() -> Optional[CacheLog]:
    return _CURRENT.get()


def bind_cache_log(log: Optional[CacheLog]) -> None:
    """Bind into the *current* context (for ``Context.run`` priming)."""
    _CURRENT.set(log)


@contextlib.contextmanager
def cache_scope(log: Optional[CacheLog] = None) -> Iterator[CacheLog]:
    log = log if log is not None else CacheLog()
    token = _CURRENT.set(log)
    try:
        yield log
    finally:
        _CURRENT.reset(token)
