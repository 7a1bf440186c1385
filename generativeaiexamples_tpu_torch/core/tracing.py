"""OpenTelemetry tracing glue.

Parity with the reference (``common/tracing.py:34-89``): a tracer provider +
W3C propagator that are real when tracing is enabled and cheap no-ops when it
is not, plus helpers to extract incoming trace context from HTTP headers and
to instrument request handlers.  Gated on ``ENABLE_TRACING=true`` exactly
like the reference; additionally degrades to no-ops when the opentelemetry
packages are absent.

A copy of the JAX package's ``core/tracing.py``; the port imports nothing of it.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Any, Callable, Iterator, Mapping, Optional

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


def tracing_enabled() -> bool:
    """Same truthy set as the config system's bool coercion, so
    ``ENABLE_TRACING=true|1|yes|on`` all enable spans."""
    return os.environ.get("ENABLE_TRACING", "").strip().lower() in (
        "true",
        "1",
        "yes",
        "on",
    )


class _NoopSpan:
    def set_attribute(self, *a: Any, **k: Any) -> None:
        pass

    def add_event(self, *a: Any, **k: Any) -> None:
        pass

    def record_exception(self, *a: Any, **k: Any) -> None:
        pass

    def end(self) -> None:
        pass


class _NoopTracer:
    @contextlib.contextmanager
    def start_as_current_span(self, name: str, **kwargs: Any) -> Iterator[_NoopSpan]:
        yield _NoopSpan()


_tracer: Any = None


def get_tracer() -> Any:
    """Return a real OTel tracer when enabled+available, else a no-op."""
    global _tracer
    if _tracer is not None:
        return _tracer
    if not tracing_enabled():
        _tracer = _NoopTracer()
        return _tracer
    try:
        from opentelemetry import trace
        from opentelemetry.sdk.resources import SERVICE_NAME, Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import SimpleSpanProcessor

        resource = Resource(attributes={SERVICE_NAME: "chain-server"})
        provider = TracerProvider(resource=resource)
        exporter = _make_exporter()
        if exporter is not None:
            provider.add_span_processor(SimpleSpanProcessor(exporter))
        trace.set_tracer_provider(provider)
        _tracer = trace.get_tracer("generativeaiexamples_tpu_torch")
        logger.info("OpenTelemetry tracing enabled")
    except Exception as exc:  # pragma: no cover - otel missing/broken
        logger.warning("tracing requested but unavailable: %s", exc)
        _tracer = _NoopTracer()
    return _tracer


def _make_exporter() -> Optional[Any]:
    try:
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )

        # The exporter reads OTEL_EXPORTER_OTLP_(TRACES_)ENDPOINT itself with
        # the spec's precedence; don't override it here.
        return OTLPSpanExporter()
    except Exception:
        try:
            from opentelemetry.sdk.trace.export import ConsoleSpanExporter

            return ConsoleSpanExporter()
        except Exception:  # pragma: no cover
            return None


def extract_context(headers: Mapping[str, str]) -> Any:
    """Extract W3C trace context from incoming HTTP headers
    (reference ``tracing.py:44-73``); returns ``None`` when disabled."""
    if not tracing_enabled():
        return None
    try:
        from opentelemetry.trace.propagation.tracecontext import (
            TraceContextTextMapPropagator,
        )

        return TraceContextTextMapPropagator().extract(dict(headers))
    except Exception:
        return None


def inject_context(headers: dict[str, str]) -> dict[str, str]:
    """Inject current trace context into outgoing HTTP headers
    (reference ``frontend/tracing.py``)."""
    if not tracing_enabled():
        return headers
    try:
        from opentelemetry.trace.propagation.tracecontext import (
            TraceContextTextMapPropagator,
        )

        TraceContextTextMapPropagator().inject(headers)
    except Exception:
        pass
    return headers


# --------------------------------------------------------------------------
# Fleet propagation (W3C trace context, dependency-light)
#
# The OTel glue above only runs when ENABLE_TRACING is set and the otel
# packages exist.  Cross-process request correlation cannot depend on
# either: the flight recorder's request ids must line up between the chain
# server and the engine server in every deployment.  These helpers are the
# single propagation implementation for all engine-bound clients
# (embedder_client, chains/llm, frontend/api): they carry the active
# ``RequestTrace.request_id`` — already a 32-hex W3C trace-id — as both
# ``traceparent`` and ``X-Request-Id``, and additionally run the OTel
# inject/extract so real spans keep working when tracing is enabled.
# --------------------------------------------------------------------------

TRACEPARENT_HEADER = "traceparent"
REQUEST_ID_HEADER = "X-Request-Id"


def _is_hex(value: str, width: int) -> bool:
    if len(value) != width:
        return False
    try:
        int(value, 16)
    except ValueError:
        return False
    return True


def inject_trace_headers(
    headers: dict[str, str], request_id: str = ""
) -> dict[str, str]:
    """Inject ``traceparent`` + ``X-Request-Id`` for the active request.

    ``request_id`` overrides the ambient :class:`~obs.trace.RequestTrace`;
    with neither, the headers pass through untouched.  Mutates and returns
    ``headers``.
    """
    rid = (request_id or "").strip()
    if not rid:
        from generativeaiexamples_tpu_torch.obs.trace import current_request_trace

        trace = current_request_trace()
        if trace is not None:
            rid = trace.request_id
    if rid:
        headers[REQUEST_ID_HEADER] = rid
        if _is_hex(rid, 32) and int(rid, 16) != 0:
            import uuid

            span_id = uuid.uuid4().hex[:16]
            headers[TRACEPARENT_HEADER] = f"00-{rid}-{span_id}-01"
    # OTel parity: when real tracing is on, its propagator overwrites
    # traceparent with the live span context (same trace id).
    inject_context(headers)
    return headers


def extract_trace_headers(headers: Mapping[str, str]) -> tuple[str, str]:
    """Return ``(request_id, parent_span_id)`` from incoming headers.

    Prefers a well-formed W3C ``traceparent`` (trace-id doubles as the
    request id); falls back to ``X-Request-Id``.  Either field is ``""``
    when absent or malformed — callers mint a fresh id in that case.
    """
    getter = getattr(headers, "get", None)
    if getter is None:  # pragma: no cover - defensive
        return "", ""
    raw = (getter(TRACEPARENT_HEADER) or getter("Traceparent") or "").strip()
    rid = ""
    parent_span = ""
    if raw:
        parts = raw.split("-")
        if (
            len(parts) >= 4
            and _is_hex(parts[0], 2)
            and _is_hex(parts[1], 32)
            and _is_hex(parts[2], 16)
            and int(parts[1], 16) != 0
            and int(parts[2], 16) != 0
        ):
            rid = parts[1]
            parent_span = parts[2]
    if not rid:
        rid = (getter(REQUEST_ID_HEADER) or getter("x-request-id") or "").strip()
    return rid, parent_span


def traced(span_name: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Decorator: run the wrapped callable inside a span.

    Handles sync and async callables AND (async) generator functions.
    Generators need their own branch: wrapping ``fn(...)`` in a plain
    ``with`` closes the span as soon as the *generator object* is
    returned — before a single item is produced — so streamed work (SSE
    generation, chunked ingest) used to be recorded as ~0 ms.  Here the
    span stays open across the whole iteration, and exceptions are
    recorded on the span (no-op spans implement ``record_exception``
    too, so the behavior is consistent with tracing off).
    """

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        import inspect

        if inspect.isasyncgenfunction(fn):

            @functools.wraps(fn)
            async def agen_wrapper(*args: Any, **kwargs: Any) -> Any:
                with get_tracer().start_as_current_span(span_name) as span:
                    try:
                        async for item in fn(*args, **kwargs):
                            yield item
                    except Exception as exc:
                        span.record_exception(exc)
                        raise

            return agen_wrapper

        if inspect.isgeneratorfunction(fn):

            @functools.wraps(fn)
            def gen_wrapper(*args: Any, **kwargs: Any) -> Any:
                with get_tracer().start_as_current_span(span_name) as span:
                    try:
                        yield from fn(*args, **kwargs)
                    except Exception as exc:
                        span.record_exception(exc)
                        raise

            return gen_wrapper

        if inspect.iscoroutinefunction(fn):

            @functools.wraps(fn)
            async def async_wrapper(*args: Any, **kwargs: Any) -> Any:
                with get_tracer().start_as_current_span(span_name) as span:
                    try:
                        return await fn(*args, **kwargs)
                    except Exception as exc:
                        span.record_exception(exc)
                        raise

            return async_wrapper

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with get_tracer().start_as_current_span(span_name) as span:
                try:
                    return fn(*args, **kwargs)
                except Exception as exc:
                    span.record_exception(exc)
                    raise

        return wrapper

    return deco
