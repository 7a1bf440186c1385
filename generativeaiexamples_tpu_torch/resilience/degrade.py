"""Per-request record of graceful-degradation decisions.

The degradation ladder (skip reranking → shrink k → exact-scan index
fallback → LLM-only answer) fires deep inside the retrieval stack, but
the *response* must carry a ``degraded: [...]`` marker and ``/metrics``
must count ladder activations per stage.  A :class:`DegradeLog` is the
channel: the chain server opens one per request (``degrade_scope``),
components call :func:`mark_degraded` wherever they shed work, and the
server reads ``log.stages()`` when composing the final chunk.

Stage names are free-form but the ladder uses a fixed vocabulary:

  ``rerank``          reranking skipped (breaker open / fault / budget)
  ``shrink_k``        fetch_k/top_k reduced to fit the remaining budget
  ``index_fallback``  approximate/quantized index bypassed for the
                      exact host-side scan
  ``retrieval``       retrieval abandoned entirely; answer is LLM-only
  ``spec_draft``      scheduler tick fell back from speculative to plain
                      decoding (draft model faulted); requests keep
                      streaming, throughput drops to the non-spec rate

Like the request deadline, the log rides a ``contextvars`` scope so it
crosses the server's generator-pump thread via ``Context.run`` without
new parameters on every signature.  The retrieval micro-batcher fans
one batch out over many requests, so batched items carry their own log
references and a batch-level mark is applied to each member's log.

A copy of the JAX package's ``resilience/degrade.py``; the port imports nothing of it.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Iterator, List, Optional


class DegradeLog:
    """Ordered, deduplicated set of degradation stages for one request."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stages: List[str] = []

    def mark(self, stage: str) -> bool:
        """Record ``stage``; returns True the first time (so callers can
        bump per-request counters exactly once)."""
        with self._lock:
            if stage in self._stages:
                return False
            self._stages.append(stage)
            return True

    def stages(self) -> List[str]:
        with self._lock:
            return list(self._stages)

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._stages)


_CURRENT: contextvars.ContextVar[Optional[DegradeLog]] = contextvars.ContextVar(
    "gaie_degrade_log", default=None
)


def current_degrade_log() -> Optional[DegradeLog]:
    return _CURRENT.get()


def bind_degrade_log(log: Optional[DegradeLog]) -> None:
    """Bind into the *current* context (for ``Context.run`` priming)."""
    _CURRENT.set(log)


@contextlib.contextmanager
def degrade_scope(log: Optional[DegradeLog] = None) -> Iterator[DegradeLog]:
    log = log if log is not None else DegradeLog()
    token = _CURRENT.set(log)
    try:
        yield log
    finally:
        _CURRENT.reset(token)


def mark_degraded(stage: str, log: Optional[DegradeLog] = None) -> None:
    """Record a ladder activation on ``log`` (or the context's log) and
    count it in ``rag_degraded_total{stage=...}`` once per request."""
    from generativeaiexamples_tpu_torch.resilience.metrics import record_degraded

    log = log if log is not None else _CURRENT.get()
    if log is None:
        # No request scope (bare library use): still count the event.
        record_degraded(stage)
        return
    if log.mark(stage):
        record_degraded(stage)
