"""Request-scoped stage trace.

:class:`RequestTrace` mirrors the ``DegradeLog``/``CacheLog`` pattern
(``resilience/degrade.py``, ``cache/log.py``): one mutable, thread-safe
object per request, bound into the request's contextvars for same-thread
code and carried *explicitly* through the micro-batcher's worker-thread
items (contextvars do not cross threads).  Every recorded stage also
feeds the ``rag_stage_latency_ms`` histogram (deferred to the first
read — finish/snapshot — so the hot path only appends a raw tuple);
:meth:`RequestTrace.finish`
feeds ``rag_request_latency_ms`` and — when ``ENABLE_TRACING=true`` —
exports the whole trace as real OTel spans with faithful timestamps.

A copy of the JAX package's ``obs/trace.py``; the port imports nothing of it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
import uuid
from typing import Any, Iterator, Optional

from generativeaiexamples_tpu_torch.core.tracing import tracing_enabled
from generativeaiexamples_tpu_torch.obs.metrics import observe_request, observe_stage

# Bound per stage list so a pathological request (or a bug in a retry
# loop) cannot grow a trace without limit.
_MAX_STAGES = 128
# Server-Timing grows one token per stage; cap the header at a sane size.
_MAX_SERVER_TIMING_STAGES = 12

# Request ids are a random 64-bit process prefix + a 64-bit counter: the
# same 32-hex shape as uuid4().hex without an os.urandom syscall per
# request (new_request_id sits on the hot path of every response).
# next() on itertools.count is atomic in CPython, so no lock.
_ID_PREFIX = uuid.uuid4().hex[:16]
_ID_COUNTER = itertools.count(1)


def new_request_id() -> str:
    return _ID_PREFIX + format(next(_ID_COUNTER) & 0xFFFFFFFFFFFFFFFF, "016x")


class RequestTrace:
    """Monotonic stage timings + attributes for one request.

    ``add_stage`` durations are wall-time milliseconds measured by the
    instrumentation sites with ``time.perf_counter()``; ``start_ms`` is
    the stage's offset from the trace's creation.  Attributes hold the
    facts already computed on the path (cache tier, degrade rungs, store
    version, batch id/size, tokens/sec) so ``/debug/requests`` can answer
    "where did this request's time go?" without re-deriving anything.
    """

    def __init__(self, request_id: str = "", route: str = "") -> None:
        self.request_id = request_id or new_request_id()
        self.route = route
        self.status: Optional[int] = None
        self.error: Optional[str] = None
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        # Two-phase stage store: ``add_stage`` appends a raw tuple to
        # ``_pending`` (GIL-atomic, no lock, no dict build — the hot
        # path runs between every pipeline stage); ``_render_locked``
        # turns pending tuples into the structured dicts of ``_stages``
        # and feeds the latency histogram, amortized into the first
        # read (finish/snapshot/server_timing) instead of the hot path.
        self._pending: list[tuple] = []
        self._stages: list[dict] = []
        self._attrs: dict[str, Any] = {}
        self._finished = False
        self._total_ms: Optional[float] = None

    # -- recording ---------------------------------------------------------

    def add_stage(
        self,
        stage: str,
        duration_ms: float,
        *,
        start: Optional[float] = None,
        **attrs: Any,
    ) -> None:
        """Record one completed stage.

        ``start`` is an optional ``time.perf_counter()`` stamp of when the
        stage began (defaults to "it just ended"); extra keyword args
        become the stage's attributes (e.g. ``batch_id=...``).
        """
        # Hot path: one float coercion + a GIL-atomic append.  The cap
        # check is racy by design — a few entries of overshoot under
        # concurrent appends is harmless, a lock per stage is not.
        if len(self._pending) + len(self._stages) >= _MAX_STAGES:
            return
        duration_ms = float(duration_ms)
        begin = (
            start
            if start is not None
            else time.perf_counter() - duration_ms / 1000.0
        )
        self._pending.append((stage, duration_ms, begin, attrs or None))

    @contextlib.contextmanager
    def stage(self, name: str, **attrs: Any) -> Iterator[None]:
        """Time a block as one stage."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_stage(
                name, (time.perf_counter() - t0) * 1000.0, start=t0, **attrs
            )

    def set_attr(self, key: str, value: Any) -> None:
        with self._lock:
            self._attrs[key] = value

    def mark_error(self, exc: BaseException) -> None:
        with self._lock:
            self.error = f"{type(exc).__name__}: {exc}"[:300]

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0

    def finish(self, status: Optional[int] = None) -> dict:
        """Close the trace: fix the total, feed the request histogram,
        export OTel spans when enabled, and return the snapshot the
        flight recorder stores.  Idempotent (first finish wins)."""
        with self._lock:
            if not self._finished:
                self._finished = True
                self._total_ms = round(
                    (time.perf_counter() - self._t0) * 1000.0, 3
                )
                if status is not None:
                    self.status = status
                first = True
            else:
                first = False
            snap = self._snapshot_locked()
        if first:
            observe_request(self.route or "other", self._total_ms)
            self._export_otel()
        return snap

    # -- read side ---------------------------------------------------------

    def _render_locked(self) -> None:
        """Drain raw pending tuples into structured stage dicts, feeding
        the ``rag_stage_latency_ms`` histogram once per stage.  Caller
        holds the lock; FIFO drain keeps chronological order across
        multiple renders."""
        while self._pending:
            stage, duration_ms, begin, attrs = self._pending.pop(0)
            entry = {
                "stage": stage,
                "start_ms": round(max(0.0, (begin - self._t0) * 1000.0), 3),
                "duration_ms": round(duration_ms, 3),
            }
            if attrs:
                entry["attrs"] = attrs
            self._stages.append(entry)
            observe_stage(stage, duration_ms)

    def stages(self) -> list[dict]:
        with self._lock:
            self._render_locked()
            return [dict(s) for s in self._stages]

    def snapshot(self) -> dict:
        """Structured view for ``/debug/requests`` (schema:
        ``RequestTraceRecord``)."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        self._render_locked()
        attrs = dict(self._attrs)
        total = (
            self._total_ms
            if self._total_ms is not None
            else round((time.perf_counter() - self._t0) * 1000.0, 3)
        )
        return {
            "request_id": self.request_id,
            "route": self.route,
            "status": self.status,
            "error": self.error,
            "degraded": list(attrs.get("degraded", ())),
            "total_ms": total,
            "started_at": round(self._wall0, 3),
            # Shallow copy is enough: stage entries are frozen once
            # appended (add_stage builds a fresh dict every call).
            "stages": list(self._stages),
            "attrs": attrs,
        }

    def server_timing(self) -> str:
        """``Server-Timing`` header value: per-stage ``dur`` entries plus
        the running (or final) total."""
        with self._lock:
            self._render_locked()
            stages = self._stages[:_MAX_SERVER_TIMING_STAGES]
            total = (
                self._total_ms
                if self._total_ms is not None
                else (time.perf_counter() - self._t0) * 1000.0
            )
        parts = [f"{s['stage']};dur={s['duration_ms']}" for s in stages]
        parts.append(f"total;dur={round(total, 3)}")
        return ", ".join(parts)

    # -- OTel export -------------------------------------------------------

    def _export_otel(self) -> None:
        """Emit the finished trace as one parent span + one child span per
        stage, with faithful start/end timestamps.  Best-effort: any
        failure (otel absent, exporter down) is swallowed — the trace is
        already durable as structured data."""
        if not tracing_enabled():  # cheap env probe before any import
            return
        try:
            from generativeaiexamples_tpu_torch.core.tracing import get_tracer

            tracer = get_tracer()
            if not hasattr(tracer, "start_span"):  # no-op tracer
                return
            from opentelemetry import trace as otel_trace

            wall0_ns = int(self._wall0 * 1e9)
            with self._lock:
                self._render_locked()
                stages = [dict(s) for s in self._stages]
                attrs = dict(self._attrs)
                total_ms = self._total_ms or 0.0
            root = tracer.start_span(
                f"request {self.route or 'other'}", start_time=wall0_ns
            )
            root.set_attribute("request_id", self.request_id)
            if self.status is not None:
                root.set_attribute("http.status_code", int(self.status))
            for key, value in attrs.items():
                if isinstance(value, (list, tuple)):
                    value = ",".join(str(v) for v in value)
                if isinstance(value, (str, bool, int, float)):
                    root.set_attribute(key, value)
            parent_ctx = otel_trace.set_span_in_context(root)
            for entry in stages:
                begin_ns = wall0_ns + int(entry["start_ms"] * 1e6)
                child = tracer.start_span(
                    entry["stage"], context=parent_ctx, start_time=begin_ns
                )
                for key, value in (entry.get("attrs") or {}).items():
                    if isinstance(value, (str, bool, int, float)):
                        child.set_attribute(key, value)
                child.end(end_time=begin_ns + int(entry["duration_ms"] * 1e6))
            root.end(end_time=wall0_ns + int(total_ms * 1e6))
        except Exception:  # pragma: no cover - exporter variance
            pass


# -- contextvar plumbing (mirrors resilience/degrade.py) -------------------

_CURRENT: contextvars.ContextVar[Optional[RequestTrace]] = contextvars.ContextVar(
    "gaie_request_trace", default=None
)


def current_request_trace() -> Optional[RequestTrace]:
    return _CURRENT.get()


def bind_request_trace(trace: Optional[RequestTrace]) -> None:
    """Set the trace in the CURRENT context (for ``Context.run`` priming,
    like ``bind_deadline``/``bind_degrade_log``)."""
    _CURRENT.set(trace)


class trace_scope:
    """Bind ``trace`` as the context's current trace for a ``with``
    block.  A handwritten context manager, not ``@contextmanager``: one
    of these runs per request, and the generator machinery is pure
    overhead on that path."""

    __slots__ = ("_trace", "_token")

    def __init__(self, trace: Optional[RequestTrace]) -> None:
        self._trace = trace

    def __enter__(self) -> Optional[RequestTrace]:
        self._token = _CURRENT.set(self._trace)
        return self._trace

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)


def traced_stream(gen, trace: Optional[RequestTrace] = None):
    """Wrap a token-chunk generator, recording LLM stream stages.

    Records ``llm_ttft`` (time to the first chunk) and — once the stream
    ends — ``llm_stream`` with the chunk count and an
    ``llm_tokens_per_sec`` attribute (chunks are tokens for the TPU
    backend; word-sized for the echo/scripted backends).  With no trace
    (argument or context) the generator passes through untouched.
    """
    if trace is None:
        trace = current_request_trace()
    if trace is None:
        yield from gen
        return
    t0 = time.perf_counter()
    chunks = 0
    try:
        for piece in gen:
            now = time.perf_counter()
            if chunks == 0:
                trace.add_stage("llm_ttft", (now - t0) * 1000.0, start=t0)
            chunks += 1
            yield piece
    finally:
        if chunks:
            dur_s = time.perf_counter() - t0
            trace.add_stage(
                "llm_stream", dur_s * 1000.0, start=t0, chunks=chunks
            )
            if dur_s > 0:
                trace.set_attr("llm_tokens_per_sec", round(chunks / dur_s, 2))
