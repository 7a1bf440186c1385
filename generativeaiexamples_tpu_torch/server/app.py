"""Chain server (port of the JAX package's ``server/app.py``) on the
standard library's ``http.server``.

Routes: ``POST /generate`` streaming SSE ``ChainResponse`` chunks ended by
a ``[DONE]`` chunk (bytes identical to the reference's but for the uuid
``id``), ``POST /documents`` (multipart upload), ``POST /documents/bulk``
(a background job through the bulk-ingest pipeline, 202 with its id) and
``GET /documents/status``, ``GET``/``DELETE /documents``, ``POST
/search``, each of them on a named collection with ``?collection=`` (or
the body's ``collection``), ``GET /health``, ``GET /metrics``, ``GET
/debug/requests``, ``GET /debug/timeseries``, and ``POST
/debug/profiler/{start,stop}`` behind ``GAIE_ENABLE_PROFILER``.  One
thread per connection runs its request end to end: the telemetry shell
(request id, W3C ``traceparent``, a ``RequestTrace``, ``Server-Timing``,
the flight recorder and the TSDB/SLO feeds), the admission gate, the
request deadline, and the pipeline generator under a ``contextvars``
context that binds the deadline, degrade log, cache log and trace.  With
``durability.enabled``, ``create_app`` recovers the store and resumes the
journal's interrupted jobs before it serves.

Differences from the reference, on purpose: the profiler writes a Chrome
trace, not a TensorBoard one; uploads default to a directory under the
temporary directory.
"""

from __future__ import annotations

import contextvars
import email.parser
import email.policy
import json
import math
import os
import tempfile
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Iterator, Optional, Sequence

from generativeaiexamples_tpu_torch.cache.log import CacheLog, bind_cache_log
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.core.tracing import extract_trace_headers, get_tracer
from generativeaiexamples_tpu_torch.obs.debug import debug_requests, debug_timeseries
from generativeaiexamples_tpu_torch.obs.debug import feed_fleet_telemetry as _feed_fleet_telemetry
from generativeaiexamples_tpu_torch.obs.debug import obs_enabled as _obs_enabled
from generativeaiexamples_tpu_torch.obs.recorder import get_flight_recorder
from generativeaiexamples_tpu_torch.obs.slo import slo_health
from generativeaiexamples_tpu_torch.obs.trace import RequestTrace, bind_request_trace, new_request_id
from generativeaiexamples_tpu_torch.resilience.breaker import CircuitOpenError, all_breakers
from generativeaiexamples_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded, bind_deadline
from generativeaiexamples_tpu_torch.resilience.degrade import DegradeLog, bind_degrade_log
from generativeaiexamples_tpu_torch.retrieval.fabric.collections import (
    DEFAULT_COLLECTION,
    CollectionQuotaExceeded,
    UnknownCollection,
)
from generativeaiexamples_tpu_torch.retrieval.fabric.metrics import store_metrics_lines  # noqa: F401 (its home)
from generativeaiexamples_tpu_torch.server import schema
from generativeaiexamples_tpu_torch.server.plugins import discover_example

logger = get_logger(__name__)

DEADLINE_HEADER = "X-Request-Deadline-Ms"
REQUEST_ID_HEADER = "X-Request-Id"
SERVER_TIMING_HEADER = "Server-Timing"

UPLOAD_DIR_ENV = "GAIE_UPLOAD_DIR"
# The reference's default is /tmp-data/uploaded_files (reference
# server.py:221); the port keeps uploads under the temporary directory.
DEFAULT_UPLOAD_DIR = os.path.join(tempfile.gettempdir(), "gaie_uploaded_files")
MAX_BODY_BYTES = 512 * 1024 * 1024  # the reference's client_max_size

_ERROR_MESSAGE = "Error from chain server. Please check chain-server logs for more details."
_SSE_HEADERS = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}


class Response:
    """A buffered response, or (``sent``) one a handler already streamed."""

    def __init__(self, status: int, body: bytes = b"", content_type: str = "application/json",
                 headers: Optional[dict] = None, sent: bool = False) -> None:
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = dict(headers or {})
        self.sent = sent


def json_response(payload: Any, status: int = 200, headers: Optional[dict] = None) -> Response:
    return Response(status, json.dumps(payload).encode(), headers=headers)


def _request_deadline(headers) -> Optional[Deadline]:
    """The request's budget: ``X-Request-Deadline-Ms`` header, else
    ``resilience.default_deadline_ms`` config; clamped to
    ``resilience.max_deadline_ms``.  ``None`` means unlimited."""
    try:
        from generativeaiexamples_tpu_torch.core.configuration import get_config

        r = get_config().resilience
        default_ms, cap_ms = r.default_deadline_ms, r.max_deadline_ms
    except Exception:  # config unavailable: header-only behavior
        default_ms, cap_ms = 0.0, 0.0
    ms = 0.0
    header = headers.get(DEADLINE_HEADER, "")
    if header:
        try:
            ms = float(header)
        except ValueError:
            ms = 0.0
    if ms <= 0:
        ms = default_ms
    if ms > 0 and cap_ms > 0:
        ms = min(ms, cap_ms)
    if ms <= 0:
        return None
    return Deadline.after_ms(ms)


def _request_context(
    deadline: Optional[Deadline],
    degrade_log: Optional[DegradeLog],
    cache_log: Optional[CacheLog] = None,
    trace: Optional[RequestTrace] = None,
) -> contextvars.Context:
    """A context primed with the request's deadline, degrade and cache
    logs and stage trace, for running pipeline code under."""
    ctx = contextvars.copy_context()
    ctx.run(bind_deadline, deadline)
    ctx.run(bind_degrade_log, degrade_log)
    ctx.run(bind_cache_log, cache_log)
    ctx.run(bind_request_trace, trace)
    return ctx


def _iterate_in_context(gen: Iterator[str], ctx: contextvars.Context) -> Iterator[str]:
    """Drive a pipeline generator on this thread, every step inside
    ``ctx`` (so its frames see the request's bindings)."""
    try:
        while True:
            try:
                item = ctx.run(next, gen)
            except StopIteration:
                return
            yield item
    finally:
        ctx.run(gen.close)


def _finalize_trace(trace: Optional[RequestTrace], status: Optional[int]) -> None:
    """Close the trace and hand its snapshot to the flight recorder and
    the fleet telemetry feeds."""
    if trace is None:
        return
    snap = trace.finish(status=status)
    get_flight_recorder().record(snap)
    try:
        _feed_fleet_telemetry(snap)
    except Exception:  # telemetry must never fail a request
        logger.exception("fleet telemetry feed failed")


# API routes gated by priority-class admission control; the value is the
# route's default traffic class (None = the configured default_class).
# Ingest defaults to the lowest class so uploads yield to queries.
_ADMISSION_ROUTES = {
    ("POST", "/generate"): None,
    ("POST", "/search"): None,
    ("POST", "/documents"): "ingest",
    ("POST", "/documents/bulk"): "ingest",
}


def _admitted(req: "_Request", handler) -> Response:
    """Priority-class admission gate over the API routes (inside the
    telemetry shell, so shed 429s are traced).  An admitted request
    releases its slot, with its measured duration, when the handler is
    done, streamed or not."""
    key = (req.method, req.path)
    if key not in _ADMISSION_ROUTES:
        return handler(req)
    from generativeaiexamples_tpu_torch.resilience.admission import get_admission_controller

    ctrl = get_admission_controller()
    cls = ctrl.classify(req.headers, default=_ADMISSION_ROUTES[key])
    deadline = _request_deadline(req.headers)
    deadline_ms = deadline.remaining_ms() if deadline is not None else None
    if deadline_ms is not None and not math.isfinite(deadline_ms):
        deadline_ms = None
    decision = ctrl.try_admit(cls, deadline_ms=deadline_ms, route=req.path)
    trace = req.trace
    if trace is not None:
        trace.set_attr("admission_class", decision.cls)
    if not decision.admitted:
        if trace is not None:
            trace.set_attr("admission_shed", decision.reason)
        return json_response(
            {"detail": f"request shed by admission control ({decision.reason}); retry later",
             "class": decision.cls, "reason": decision.reason},
            status=429,
            headers={"Retry-After": str(max(1, round(decision.retry_after_s))), "X-Admission-Class": decision.cls},
        )
    started = time.monotonic()
    try:
        return handler(req)
    finally:
        ctrl.release(decision.cls, duration_ms=(time.monotonic() - started) * 1000.0)


def _telemetry_headers(req: "_Request") -> dict:
    """Telemetry headers for a response the handler streams itself:
    ``Server-Timing`` holds the stages completed by now (for /generate,
    the retrieval side, fixed at first-chunk time)."""
    headers = {REQUEST_ID_HEADER: req.request_id}
    if req.trace is not None:
        headers[SERVER_TIMING_HEADER] = req.trace.server_timing()
    return headers


def _annotate_trace(
    trace: Optional[RequestTrace], degrade_log: Optional[DegradeLog] = None, cache_log: Optional[CacheLog] = None
) -> None:
    """Copy the request's degrade rungs and cache disposition onto the
    trace (the shell finishes the trace but cannot see the logs)."""
    if trace is None:
        return
    if degrade_log is not None:
        stages = degrade_log.stages()
        if stages:
            trace.set_attr("degraded", list(stages))
    cached, tier = _cache_disposition(cache_log)
    if cached:
        trace.set_attr("cache_tier", tier)


def _cache_disposition(cache_log: Optional[CacheLog]) -> tuple[bool, str]:
    """(cached, tier) for the response surface; an answer replay reports
    tier "answer" (it subsumes the retrieval-tier hit)."""
    if cache_log is None:
        return False, ""
    if cache_log.answer_hit:
        return True, "answer"
    tier = cache_log.tier
    return bool(tier), tier


def _cache_headers(cache_log: Optional[CacheLog]) -> dict:
    cached, tier = _cache_disposition(cache_log)
    headers = {"X-Cache": "HIT" if cached else "MISS"}
    if tier:
        headers["X-Cache-Tier"] = tier
    return headers


def _sse(chunk: schema.ChainResponse) -> bytes:
    return f"data: {chunk.to_json()}\n\n".encode()


def _content_chunk(resp_id: str, content: str) -> schema.ChainResponse:
    return schema.ChainResponse(
        id=resp_id,
        choices=[schema.ChainResponseChoices(index=0, message=schema.Message(role="assistant", content=content))],
    )


def _done_chunk(resp_id: str, degraded: Sequence[str] = (), cache_log: Optional[CacheLog] = None) -> schema.ChainResponse:
    cached, tier = _cache_disposition(cache_log)
    return schema.ChainResponse(
        id=resp_id,
        choices=[schema.ChainResponseChoices(finish_reason="[DONE]")],
        degraded=list(degraded),
        cached=cached,
        cache_tier=tier,
    )


def _error_chunk(message: str) -> schema.ChainResponse:
    return schema.ChainResponse(
        id="",
        choices=[schema.ChainResponseChoices(
            index=0, message=schema.Message(role="assistant", content=message), finish_reason="[DONE]")],
    )


def _requested_collection(value: str) -> str:
    """Empty and ``"default"`` both mean the singleton store (the example
    pipeline owns retrieval and ingestion); any other name routes the
    request to that named collection's own store."""
    name = (value or "").strip()
    return "" if name == DEFAULT_COLLECTION else name


def _collection_search_sync(name: str, query: str, top_k: int, device) -> list[dict]:
    """Embed + search a named collection's store directly (the example
    pipeline only knows the singleton).  Returns ``document_search``-shaped
    dicts; raises :class:`UnknownCollection` for a 404."""
    from generativeaiexamples_tpu_torch.chains.factory import get_collection_manager, get_embedder
    from generativeaiexamples_tpu_torch.core.configuration import get_config

    store = get_collection_manager(device).get(name)
    embedding = get_embedder(device).embed_query(query)
    threshold = get_config().retriever.score_threshold
    hits = store.search(embedding, top_k=top_k)
    return [
        {"content": h.chunk.text, "source": h.chunk.source, "score": float(h.score)}
        for h in hits
        if float(h.score) >= threshold
    ]


def _collection_ingest_sync(name: str, file_path: str, filename: str, example, device) -> int:
    """Parse → embed → quota-admitted append into a named collection,
    created on first ingest (create-as-ensure, config default quotas);
    parsing prefers the example's ``parse_chunks`` hook.  Raises
    :class:`CollectionQuotaExceeded` for a 413."""
    from generativeaiexamples_tpu_torch.chains.factory import get_collection_manager, get_embedder, get_splitter
    from generativeaiexamples_tpu_torch.ingest.loaders import load_document
    from generativeaiexamples_tpu_torch.retrieval.base import Chunk

    manager = get_collection_manager(device)
    manager.create(name)
    parse = getattr(example, "parse_chunks", None)
    if callable(parse):
        chunks = list(parse(file_path, filename))
    else:
        chunks = [Chunk(text=piece, source=filename) for piece in get_splitter().split(load_document(file_path))]
    embeddings = get_embedder(device).embed_documents([c.text for c in chunks])
    manager.add(name, chunks, embeddings)
    return len(chunks)


def handle_health(req: "_Request") -> Response:
    slo = slo_health()
    degraded = bool(slo.get("degraded"))
    return json_response(schema.HealthResponse(
        message="Service is degraded: SLO fast-burn alert firing." if degraded else "Service is up.",
        status="degraded" if degraded else "ok",
        breakers={name: breaker.state for name, breaker in sorted(all_breakers().items())},
        slo=slo,
    ).to_dict())


def metrics_text() -> str:
    """The chain server's Prometheus exposition, in the reference's order:
    the retrieval micro-batcher's ``rag_*`` series, the bulk pipeline's
    ``ingest_*``, store capacity (aggregate and per collection), the
    fabric's shard, cold-tier and collection families, resilience,
    admission, the engine pool's sizes (zeros), cache, per-stage latency,
    SLO, durability and the gray-failure families (zeros).  Peek-only:
    a scrape builds no store, manager or pipeline."""
    from generativeaiexamples_tpu_torch.cache.metrics import cache_metrics_lines
    from generativeaiexamples_tpu_torch.chains.factory import (
        get_retrieval_batcher,
        peek_collection_manager,
        peek_ingest_pipeline,
        peek_store,
    )
    from generativeaiexamples_tpu_torch.durability.metrics import durability_metrics_lines
    from generativeaiexamples_tpu_torch.engine.autoscale import pool_metrics_lines
    from generativeaiexamples_tpu_torch.engine.health import gray_metrics_lines
    from generativeaiexamples_tpu_torch.engine.server import rag_metrics_lines
    from generativeaiexamples_tpu_torch.ingest.pipeline import ingest_metrics_lines
    from generativeaiexamples_tpu_torch.obs.metrics import obs_metrics_lines
    from generativeaiexamples_tpu_torch.obs.slo import slo_metrics_lines
    from generativeaiexamples_tpu_torch.resilience.admission import admission_metrics_lines
    from generativeaiexamples_tpu_torch.resilience.metrics import resilience_metrics_lines
    from generativeaiexamples_tpu_torch.retrieval.fabric.metrics import aggregate_capacity_stats, fabric_metrics_lines

    batcher = get_retrieval_batcher()
    pipeline = peek_ingest_pipeline()
    store = peek_store()
    manager = peek_collection_manager()
    lines = (
        rag_metrics_lines(batcher.stats.snapshot() if batcher is not None else None)
        + ingest_metrics_lines(
            pipeline.stats.snapshot() if pipeline is not None else None,
            active_jobs=pipeline.active_jobs() if pipeline is not None else 0,
        )
        + store_metrics_lines(
            aggregate_capacity_stats(store, manager),
            manager.capacity_by_collection() if manager is not None else None,
        )
        + fabric_metrics_lines(store, manager)
        + resilience_metrics_lines()
        + admission_metrics_lines()
        # The chain server hosts no engine pool: the pool and gray-failure
        # families export their zeros, so one dashboard reads both servers.
        + pool_metrics_lines(None)
        + cache_metrics_lines()
        + obs_metrics_lines()
        + slo_metrics_lines()
        + durability_metrics_lines()
        + gray_metrics_lines(None)
    )
    return "\n".join(lines) + "\n"


def handle_metrics(req: "_Request") -> Response:
    return Response(200, metrics_text().encode(), content_type="text/plain")


def handle_generate(req: "_Request") -> Response:
    try:
        prompt = schema.Prompt.parse(req.json())
    except ValueError as exc:  # schema.ValidationError, bad JSON or UTF-8
        return json_response({"detail": str(exc)}, status=422)
    collection = _requested_collection(prompt.collection)
    if collection and prompt.use_knowledge_base:
        # Resolve the collection BEFORE streaming: a typo becomes a typed
        # 404, not a 200 that dies with an SSE error chunk.
        from generativeaiexamples_tpu_torch.chains.factory import peek_collection_manager

        manager = peek_collection_manager()
        if manager is None or not manager.exists(collection):
            return json_response({"detail": f"unknown collection {collection!r}"}, status=404)

    chat_history = [(m.role, m.content) for m in prompt.messages]
    last_user = next((c for r, c in reversed(chat_history) if r == "user"), None)
    # Remove the last user message from history; it becomes the query.
    for i in reversed(range(len(chat_history))):
        if chat_history[i][0] == "user":
            del chat_history[i]
            break
    llm_settings = {
        "temperature": prompt.temperature,
        "top_p": prompt.top_p,
        "max_tokens": prompt.max_tokens,
        "stop": prompt.stop,
    }
    if prompt.session_id:
        llm_settings["session_id"] = prompt.session_id

    degrade_log = DegradeLog()
    cache_log = CacheLog()
    ctx = _request_context(_request_deadline(req.headers), degrade_log, cache_log, req.trace)
    resp_id = str(uuid.uuid4())
    try:
        with get_tracer().start_as_current_span("generate"):
            example = req.example_cls()
            if prompt.use_knowledge_base and collection:
                gen = _collection_rag(example, collection, last_user or "", chat_history, llm_settings, req.device)
            else:
                chain = example.rag_chain if prompt.use_knowledge_base else example.llm_chain
                gen = chain(query=last_user or "", chat_history=chat_history, **llm_settings)
            return _generate_stream(req, _iterate_in_context(gen, ctx), resp_id, degrade_log, cache_log)
    finally:
        _annotate_trace(req.trace, degrade_log, cache_log)


def _collection_rag(example, collection: str, query: str, chat_history: list, llm_settings: dict,
                    device) -> Iterator[str]:
    """Named-collection RAG: retrieve from the collection's own store, then
    ground the LLM with a system context turn (the example's rag_chain is
    bound to the singleton)."""
    from generativeaiexamples_tpu_torch.core.configuration import get_config

    hits = _collection_search_sync(collection, query, get_config().retriever.top_k, device)
    context = "\n\n".join(h["content"] for h in hits)
    grounded = [("system", f"Answer using this context from the {collection!r} collection:\n{context}")]
    yield from example.llm_chain(query=query, chat_history=grounded + chat_history, **llm_settings)


def _generate_stream(req: "_Request", chunks: Iterator[str], resp_id: str, degrade_log: DegradeLog,
                     cache_log: CacheLog) -> Response:
    # Pull the FIRST chunk before committing the HTTP status: a deadline
    # or breaker refusal still becomes a typed 504/503 instead of a 200
    # that dies mid-stream.
    first: Optional[str] = None
    drained = False
    try:
        first = next(chunks)
    except StopIteration:
        drained = True
    except DeadlineExceeded:
        logger.warning("request deadline exceeded before first chunk")
        return json_response({"detail": "Request deadline exceeded."}, status=504)
    except CircuitOpenError as exc:
        logger.warning("refusing /generate: %s", exc)
        return json_response({"detail": f"Temporarily unavailable: {exc}"}, status=503,
                             headers={"Retry-After": str(max(1, round(exc.retry_after_s)))})
    except Exception:
        # Pre-stream failure with no typed mapping: the reference's
        # degraded-response idiom (200 + error chunk).
        logger.exception("error in /generate")
        req.start_stream({**_SSE_HEADERS, **_telemetry_headers(req)})
        req.write(_sse(_error_chunk(_ERROR_MESSAGE)))
        return Response(200, sent=True)

    # Retrieval (and any answer replay) happened before the first chunk,
    # so the cache disposition and the retrieval stages are final here.
    req.start_stream({**_SSE_HEADERS, **_cache_headers(cache_log), **_telemetry_headers(req)})
    try:
        if first is not None:
            req.write(_sse(_content_chunk(resp_id, first)))
        if not drained:
            for chunk in chunks:
                req.write(_sse(_content_chunk(resp_id, chunk)))
        req.write(_sse(_done_chunk(resp_id, degraded=degrade_log.stages(), cache_log=cache_log)))
    except (BrokenPipeError, ConnectionResetError):
        logger.info("client disconnected from /generate %s", req.request_id)
        chunks.close()  # stops the generation
    except Exception:
        # Mid-stream failure: the status is already on the wire, so
        # surface an SSE error chunk (GenerationError lands here).
        logger.exception("error in /generate")
        try:
            req.write(_sse(_error_chunk(_ERROR_MESSAGE)))
        except OSError:
            pass
    return Response(200, sent=True)


def _file_parts(content_type: str, body: bytes, names=("file",), named_only: bool = False) -> list:
    """The file fields (``names``) of a multipart/form-data body, in order:
    [(filename, bytes)]; ``named_only`` skips parts without a filename."""
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body
    )
    if not msg.is_multipart():
        return []
    out = []
    for part in msg.iter_parts():
        if part.get_param("name", header="content-disposition") in names:
            filename = part.get_filename() or ""
            if filename or not named_only:
                out.append((filename, part.get_payload(decode=True) or b""))
    return out


def _file_part(content_type: str, body: bytes) -> Optional[tuple[str, bytes]]:
    """The first ``file`` field of a multipart/form-data body: (filename,
    bytes), or None."""
    parts = _file_parts(content_type, body)
    return parts[0] if parts else None


def _save_part(filename: str, data: bytes) -> tuple[str, str]:
    """Write one uploaded file to a UNIQUE temp path, keeping its
    extension (loaders dispatch on it): two concurrent uploads of one
    name must not clobber each other.  Returns (temp_path, filename)."""
    filename = os.path.basename(filename or "upload.bin")
    upload_dir = os.environ.get(UPLOAD_DIR_ENV, DEFAULT_UPLOAD_DIR)
    os.makedirs(upload_dir, exist_ok=True)
    suffix = os.path.splitext(filename)[1][:16]
    fd, file_path = tempfile.mkstemp(dir=upload_dir, prefix="upload_", suffix=suffix)
    with os.fdopen(fd, "wb") as fh:
        fh.write(data)
    return file_path, filename


def handle_upload_document(req: "_Request") -> Response:
    part = _file_part(req.headers.get("Content-Type", ""), req.body())
    if part is None:
        return json_response({"detail": "no file field"}, status=422)
    file_path, filename = _save_part(*part)
    collection = _requested_collection(req.query.get("collection", ""))
    logger.info("saved upload %s (%d bytes)%s", filename, len(part[1]),
                f" -> collection {collection!r}" if collection else "")
    try:
        example = req.example_cls()
        if collection:
            _collection_ingest_sync(collection, file_path, filename, example, req.device)
        else:
            example.ingest_docs(file_path, filename)
    except CollectionQuotaExceeded as exc:
        logger.warning("quota refusal for %s: %s", filename, exc)
        return json_response({"detail": str(exc)}, status=413)
    except Exception as exc:
        logger.exception("ingest failed for %s", filename)
        return json_response({"detail": f"Failed to upload document. {exc}"}, status=500)
    finally:
        try:
            os.unlink(file_path)
        except OSError:
            pass
    return json_response({"message": f"File uploaded successfully: {filename}"})


def handle_bulk_upload(req: "_Request") -> Response:
    """``POST /documents/bulk``: multi-file upload into the staged ingest
    pipeline as a BACKGROUND job: 202 with a job id once the files are on
    disk; ``GET /documents/status?job_id=...`` tracks it.  Files of a
    standard pipeline (a ``parse_chunks`` hook) flow through the parse
    pool and shared embed dispatches; a named collection, or a plugin with
    its own ``ingest_docs``, ingests each file on the pool (a quota refusal
    fails only that file)."""
    from generativeaiexamples_tpu_torch.chains.factory import get_collection_manager, get_ingest_pipeline

    parts = _file_parts(req.headers.get("Content-Type", ""), req.body(), names=("file", "files"), named_only=True)
    files: list[tuple[str, str]] = []
    for filename, data in parts:
        files.append(_save_part(filename, data))
        logger.info("bulk upload staged %s (%d bytes)", files[-1][1], len(data))
    if not files:
        return json_response({"detail": "no file fields"}, status=422)
    collection = _requested_collection(req.query.get("collection", ""))
    try:
        example = req.example_cls()
        pipeline = get_ingest_pipeline(req.device)
        if collection:
            # Ensure the collection before the 202: a bad name fails the
            # submission, not the job.
            get_collection_manager(req.device).create(collection)

            def ingest_fn(path: str, name: str) -> None:
                _collection_ingest_sync(collection, path, name, example, req.device)

        else:
            ingest_fn = None if hasattr(example, "parse_chunks") else example.ingest_docs
        job_id = pipeline.submit(files, ingest_fn=ingest_fn)
    except Exception as exc:
        logger.exception("bulk ingest submission failed")
        for path, _ in files:
            try:
                os.unlink(path)
            except OSError:
                pass
        return json_response({"detail": f"Failed to start bulk ingestion. {exc}"}, status=500)
    return json_response(
        schema.BulkIngestResponse(job_id=job_id, files_received=len(files),
                                  message=f"Bulk ingestion started for {len(files)} files.").to_dict(),
        status=202,
    )


def handle_ingest_status(req: "_Request") -> Response:
    """``GET /documents/status``: bulk-ingest job progress (one job with
    ``?job_id=``, else every job, newest first)."""
    from generativeaiexamples_tpu_torch.chains.factory import peek_ingest_pipeline

    pipeline = peek_ingest_pipeline()
    job_id = req.query.get("job_id", "")
    if pipeline is None:
        if job_id:
            return json_response({"detail": f"unknown job {job_id!r}"}, status=404)
        return json_response(schema.IngestStatusResponse(jobs=[], active_jobs=0).to_dict())
    if job_id:
        snap = pipeline.status(job_id)
        if snap is None:
            return json_response({"detail": f"unknown job {job_id!r}"}, status=404)
        return json_response(schema.IngestJobStatus(**snap).to_dict())
    status = pipeline.status()
    return json_response(schema.IngestStatusResponse(
        jobs=[schema.IngestJobStatus(**j) for j in status["jobs"]], active_jobs=status["active_jobs"]).to_dict())


def handle_search(req: "_Request") -> Response:
    try:
        body = schema.DocumentSearch.parse(req.json())
    except ValueError as exc:
        return json_response({"detail": str(exc)}, status=422)
    collection = _requested_collection(body.collection)
    degrade_log = DegradeLog()
    cache_log = CacheLog()
    ctx = _request_context(_request_deadline(req.headers), degrade_log, cache_log, req.trace)
    try:
        example = req.example_cls()
        if collection:
            hits = ctx.run(_collection_search_sync, collection, body.query, body.top_k, req.device)
        else:
            hits = ctx.run(example.document_search, body.query, body.top_k)
        chunks = [
            schema.DocumentChunk(content=h.get("content", ""), filename=h.get("source", ""),
                                 score=float(h.get("score", 0.0)))
            for h in hits
        ]
        cached, tier = _cache_disposition(cache_log)
        return json_response(
            schema.DocumentSearchResponse(chunks=chunks, degraded=degrade_log.stages(), cached=cached,
                                          cache_tier=tier).to_dict(),
            headers=_cache_headers(cache_log),
        )
    except UnknownCollection as exc:
        return json_response({"detail": str(exc)}, status=404)
    except NotImplementedError:
        return json_response({"detail": "document_search not supported by this pipeline"}, status=501)
    except DeadlineExceeded:
        logger.warning("request deadline exceeded in /search")
        return json_response({"detail": "Request deadline exceeded."}, status=504)
    except CircuitOpenError as exc:
        logger.warning("refusing /search: %s", exc)
        return json_response({"detail": f"Temporarily unavailable: {exc}"}, status=503,
                             headers={"Retry-After": str(max(1, round(exc.retry_after_s)))})
    except Exception:
        logger.exception("error in /search")
        return json_response({"detail": "Error occurred while searching documents."}, status=500)
    finally:
        _annotate_trace(req.trace, degrade_log, cache_log)


def handle_get_documents(req: "_Request") -> Response:
    collection = _requested_collection(req.query.get("collection", ""))
    try:
        if collection:
            from generativeaiexamples_tpu_torch.chains.factory import get_collection_manager

            docs = sorted(get_collection_manager(req.device).get(collection).sources())
        else:
            docs = req.example_cls().get_documents()
        return json_response(schema.DocumentsResponse(documents=docs).to_dict())
    except UnknownCollection as exc:
        return json_response({"detail": str(exc)}, status=404)
    except NotImplementedError:
        return json_response({"detail": "get_documents not supported by this pipeline"}, status=501)
    except Exception:
        logger.exception("error in GET /documents")
        return json_response({"detail": "Error occurred while fetching documents."}, status=500)


def handle_delete_document(req: "_Request") -> Response:
    filename = req.query.get("filename", "")
    if not filename:
        return json_response({"detail": "filename query param required"}, status=422)
    collection = _requested_collection(req.query.get("collection", ""))
    try:
        if collection:
            from generativeaiexamples_tpu_torch.chains.factory import get_collection_manager

            ok = get_collection_manager(req.device).get(collection).delete_source(filename)
        else:
            ok = req.example_cls().delete_documents([filename])
        if not ok:
            return json_response({"detail": f"{filename} not found"}, status=404)
        return json_response({"message": f"Deleted {filename}"})
    except UnknownCollection as exc:
        return json_response({"detail": str(exc)}, status=404)
    except NotImplementedError:
        return json_response({"detail": "delete_documents not supported by this pipeline"}, status=501)
    except Exception:
        logger.exception("error in DELETE /documents")
        return json_response({"detail": "Error occurred while deleting document."}, status=500)


def handle_debug_requests(req: "_Request") -> Response:
    """``GET /debug/requests``: the flight recorder's traces, newest first."""
    status, body = debug_requests(req.query)
    return json_response(body, status=status)


def handle_debug_timeseries(req: "_Request") -> Response:
    """``GET /debug/timeseries?series=a,b*&window=5m``: the TSDB's history."""
    status, body = debug_timeseries(req.query)
    return json_response(body, status=status)


def handle_profiler_start(req: "_Request") -> Response:
    from generativeaiexamples_tpu_torch.obs.profiler import profiler_start

    status, body = profiler_start()
    return json_response(body, status=status)


def handle_profiler_stop(req: "_Request") -> Response:
    from generativeaiexamples_tpu_torch.obs.profiler import profiler_stop

    status, body = profiler_stop()
    return json_response(body, status=status)


ROUTES = {
    ("GET", "/health"): handle_health,
    ("GET", "/metrics"): handle_metrics,
    ("POST", "/generate"): handle_generate,
    ("POST", "/documents"): handle_upload_document,
    ("POST", "/documents/bulk"): handle_bulk_upload,
    ("GET", "/documents/status"): handle_ingest_status,
    ("GET", "/documents"): handle_get_documents,
    ("DELETE", "/documents"): handle_delete_document,
    ("POST", "/search"): handle_search,
    ("GET", "/debug/requests"): handle_debug_requests,
    ("GET", "/debug/timeseries"): handle_debug_timeseries,
}
# Served only when the profiler gate is open (``obs/profiler.py``).
PROFILER_ROUTES = {
    ("POST", "/debug/profiler/start"): handle_profiler_start,
    ("POST", "/debug/profiler/stop"): handle_profiler_stop,
}


class _Request:
    """One request as the handlers see it."""

    def __init__(self, http: "_Handler", method: str) -> None:
        url = urllib.parse.urlsplit(http.path)
        self.http = http
        self.method = method
        self.path = url.path
        self.query = {k: v[0] for k, v in urllib.parse.parse_qs(url.query, keep_blank_values=True).items()}
        self.headers = http.headers
        self.example_cls = http.server.example_cls
        self.device = http.server.device
        self.request_id = ""
        self.trace: Optional[RequestTrace] = None
        self._body: Optional[bytes] = None

    def body(self) -> bytes:
        if self._body is None:
            n = int(self.headers.get("Content-Length") or 0)
            if n > MAX_BODY_BYTES:
                raise _TooLarge(n)
            self._body = self.http.rfile.read(n) if n > 0 else b""
        return self._body

    def json(self) -> Any:
        """The body as JSON (ValueError when it is not)."""
        return json.loads(self.body().decode("utf-8"))

    def start_stream(self, headers: dict) -> None:
        self.http.send_response(200)
        for key, value in headers.items():
            self.http.send_header(key, value)
        self.http.end_headers()

    def write(self, data: bytes) -> None:
        self.http.wfile.write(data)
        self.http.wfile.flush()


class _TooLarge(Exception):
    pass


class _Handler(BaseHTTPRequestHandler):
    server: "ChainServer"

    def log_message(self, fmt, *args) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    def do_GET(self) -> None:  # noqa: N802
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self) -> None:  # noqa: N802
        self._dispatch("DELETE")

    def _send(self, resp: Response) -> None:
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for key, value in resp.headers.items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(resp.body)

    def _dispatch(self, method: str) -> None:
        """The per-request telemetry shell around the admission gate and
        the route's handler: request id (echoed, or from ``traceparent``,
        or new), a trace joined to an upstream span, and on finish the
        flight recorder and TSDB/SLO feeds."""
        req = _Request(self, method)
        req_id, parent_span = extract_trace_headers(self.headers)
        req.request_id = req_id or new_request_id()
        if _obs_enabled():
            req.trace = RequestTrace(request_id=req.request_id, route=req.path)
            if parent_span:
                req.trace.set_attr("parent_span_id", parent_span)
        routes = self.server.routes
        handler = routes.get((method, req.path))
        try:
            if handler is None:
                status = 405 if any(path == req.path for _, path in routes) else 404
                resp = json_response({"detail": "Method Not Allowed" if status == 405 else "Not Found"}, status)
            else:
                resp = _admitted(req, handler)
        except _TooLarge as exc:
            resp = json_response({"detail": f"request body of {exc.args[0]} bytes exceeds {MAX_BODY_BYTES}"}, 413)
        except Exception as exc:
            logger.exception("unhandled error in %s %s", method, req.path)
            if req.trace is not None:
                req.trace.mark_error(exc)
            resp = json_response({"detail": "Internal Server Error"}, 500)
        _finalize_trace(req.trace, resp.status)
        if resp.sent:
            return
        resp.headers[REQUEST_ID_HEADER] = req.request_id
        if req.trace is not None:
            resp.headers[SERVER_TIMING_HEADER] = req.trace.server_timing()
        try:
            self._send(resp)
        except (BrokenPipeError, ConnectionResetError):
            logger.info("client disconnected before the response to %s %s", method, req.path)


class ChainServer(ThreadingHTTPServer):
    """The chain server: one thread per connection, serving ``example_cls``
    (a fresh pipeline object per request, as the reference does) over the
    factory's singletons on ``device``."""

    daemon_threads = True
    # Listen backlog (http.server's default is 5): a burst of concurrent
    # clients must queue, not be reset.
    request_queue_size = 128

    def __init__(self, address, example_cls, device=None, routes=None) -> None:
        super().__init__(address, _Handler)
        self.example_cls = example_cls
        self.device = device
        self.routes = dict(ROUTES if routes is None else routes)


def create_app(example_cls: Any = None, host: str = "127.0.0.1", port: int = 0, device=None) -> ChainServer:
    """Build the chain server (``serve_forever`` serves; port 0 picks a
    free port, ``server.server_address``).

    ``example_cls`` overrides plugin discovery (``GAIE_EXAMPLE_PATH`` /
    ``GAIE_EXAMPLE_MODULE``, default the port's ``developer_rag``).  The
    factory's chat LLM, retriever (store, embedder, reranker, cache) and
    micro-batcher are built here from ``APP_*``, on ``device``: None is
    the card (without one this raises), ``"cpu"`` only when asked; so is
    what the example's ``prepare(device)`` builds (the multi-turn chain's
    memory store).  With ``durability.enabled`` building the store
    recovers it (snapshot + WAL tail) and the ingest pipeline is built to
    resume the journal's interrupted jobs, both before the first request.
    The ``/debug/profiler/*`` routes exist when ``GAIE_ENABLE_PROFILER`` is
    set."""
    from generativeaiexamples_tpu_torch.chains.factory import (
        get_chat_llm,
        get_ingest_pipeline,
        get_retrieval_batcher,
        get_retriever,
    )
    from generativeaiexamples_tpu_torch.core.configuration import get_config
    from generativeaiexamples_tpu_torch.obs.profiler import profiler_enabled

    example_cls = example_cls or discover_example()
    get_chat_llm(device)
    get_retriever(device)
    get_retrieval_batcher(device)
    prepare = getattr(example_cls, "prepare", None)
    if callable(prepare):
        prepare(device)
    if get_config().durability.enabled:
        get_ingest_pipeline(device)
    routes = {**ROUTES, **(PROFILER_ROUTES if profiler_enabled() else {})}
    return ChainServer((host, port), example_cls, device=device, routes=routes)
