"""OpenAI-compatible serving front over the port's scheduler or replica pool
(port of ``engine/server.py``).

Built on the standard library (``http.server.ThreadingHTTPServer``, SSE
written by hand), with the reference's routes and JSON:
``/v1/completions``, ``/v1/chat/completions``, ``/v1/embeddings``,
``/v1/ranking``, ``/v1/models``, ``/health``, ``/metrics``,
``/admin/{replicas,drain,scale}``, ``/debug/requests``,
``/debug/timeseries`` and, behind ``GAIE_ENABLE_PROFILER``,
``/debug/profiler/{start,stop}``.  One thread per connection; tokens cross
from the scheduler thread through a ``queue.Queue`` per request.  Every
request runs inside the engine's telemetry shell: it joins the caller's
``traceparent`` / ``X-Request-Id``, records a ``RequestTrace`` in the
flight recorder and feeds the fleet TSDB and SLO counters (``engine.*``).

A full admission queue answers 429 with ``Retry-After`` (before any SSE
byte); a non-streamed generation that dies mid-flight (a replica's
failover, a tick fault) answers a retryable 503, a streamed one ends with
``finish_reason: "error"``.

Run: ``python -m generativeaiexamples_tpu_torch.engine.server --model llama3-8b``
(``--matmul-kernel`` picks the projection path: ``xla``, the default, serves
the weights as loaded, or random bf16 ones, over the preset's bf16 KV cache;
``pallas_w8a8`` is the port's W8A8 route on an int8 cache; ``--kv-layout
paged`` serves from the paged KV pool, int8; ``--embedder`` picks the BERT
embedder behind ``/v1/embeddings``; ``--spec-decode`` speculates, by prompt
lookup or, with ``--draft-model``, with a draft model; ``--replicas N
--routing-policy prefix [--autoscale]`` serves through an
``engine.replica.EnginePool`` of N schedulers that share one weight tree,
each with its own KV cache, on the one device).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from generativeaiexamples_tpu_torch.core.logging import configure_logging, get_logger
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
from generativeaiexamples_tpu_torch.engine.scheduler import SERVING_DEFAULTS, Request, Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import decode_stream

logger = get_logger(__name__)

# A request that sees no token for this long is failed (a dead engine
# must not hold a connection forever).
TOKEN_TIMEOUT_S = 600.0
REQUEST_ID_HEADER = "X-Request-Id"


def _now() -> int:
    return int(time.time())


class _TokenBridge:
    """Scheduler-thread callbacks -> a per-request queue."""

    def __init__(self) -> None:
        self.queue: "queue.Queue[tuple[str, object]]" = queue.Queue()

    def on_token(self, tid: int) -> None:
        self.queue.put(("token", tid))

    def on_done(self, reason: str) -> None:
        self.queue.put(("done", reason))

    def get(self):
        try:
            return self.queue.get(timeout=TOKEN_TIMEOUT_S)
        except queue.Empty:
            return ("done", "error")


def _find_stop(text: str, stop: list[str]) -> Optional[int]:
    cuts = [text.find(s) for s in stop if s and text.find(s) >= 0]
    return min(cuts) if cuts else None


def retry_after_s(snap: dict) -> int:
    """The 429's ``Retry-After`` in seconds, from an engine's stats snapshot
    (a scheduler's or a pool's aggregate): queued requests x the smoothed
    tick time (token-normalized when speculating) is about how long the
    queue needs to drain; a paged engine also projects how long until the
    free list covers a typical admission, from the page-free rate; the
    larger of the two, clamped to [1, 30] (the reference's
    ``_overloaded_response``)."""
    retry_after = 1.0
    try:
        tick_ms = float(snap.get("tick_ms_norm_ewma", 0.0) or snap.get("tick_ms_ewma", 0.0))
        retry_after = 1.0 + float(snap.get("queued", 0)) * tick_ms / 1000.0
        if float(snap.get("kv_pages_total", 0)):
            deficit = float(snap.get("kv_pages_per_admit", 0)) - float(snap.get("kv_pages_free", 0))
            if deficit > 0:
                rate = float(snap.get("kv_page_free_rate", 0.0))
                retry_after = max(retry_after, 1.0 + deficit / max(rate, 0.5))
    except (TypeError, ValueError):
        pass
    return max(1, min(30, round(retry_after)))


def _aggregate_generation(bridge: _TokenBridge, piece, stop: list[str], scheduler, request_id: str):
    """Non-streaming path: collect the full completion text; a matched
    stop sequence cancels the request at once."""
    parts: list[str] = []
    emitted = ""
    n_tokens = 0
    finish = "stop"
    completed = False
    matched_stop = False
    try:
        while True:
            kind, value = bridge.get()
            if kind == "done":
                finish = value
                tail = piece(0, final=True)
                if tail:
                    parts.append(tail)
                completed = True
                break
            text_piece = piece(value)
            parts.append(text_piece)
            emitted += text_piece
            if not matched_stop:
                n_tokens += 1
            if stop and not matched_stop and _find_stop(emitted, stop) is not None:
                matched_stop = True
                scheduler.cancel(request_id)
    finally:
        if not completed:
            scheduler.cancel(request_id)
    text = "".join(parts)
    cut = _find_stop(text, stop)
    if cut is not None:
        text = text[:cut]
        finish = "stop"
    return text, n_tokens, finish


_NOT_A_POOL = {"error": {"message": "not a replica pool (started with --replicas 1)"}}


class _Handler(BaseHTTPRequestHandler):
    server: "EngineServer"

    def log_message(self, fmt, *args) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    # -- plumbing ---------------------------------------------------------

    def _start(self, status: int, content_type: str, length: Optional[int] = None, headers=None) -> None:
        self._status = status
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        if length is not None:
            self.send_header("Content-Length", str(length))
        self.send_header(REQUEST_ID_HEADER, self._request_id)
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()

    def _json(self, payload: dict, status: int = 200, headers=None) -> None:
        body = json.dumps(payload).encode()
        self._start(status, "application/json", len(body), headers)
        self.wfile.write(body)

    def _body(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"null")
            if not isinstance(body, dict):
                raise TypeError("request body must be a JSON object")
            return body
        except (ValueError, TypeError) as exc:
            self._json({"error": {"message": str(exc)}}, 422)
            return None

    def _overloaded(self) -> None:
        """429 for a full admission queue (every replica's, for a pool),
        with the backlog's ``Retry-After`` (:func:`retry_after_s`)."""
        try:
            retry = retry_after_s(self.server.scheduler.stats.snapshot())
        except Exception:
            retry = 1
        self._json({"error": {"message": "engine overloaded: admission queue full", "type": "overloaded_error",
                              "code": 429}}, 429, {"Retry-After": str(retry)})

    def _retryable_error(self) -> None:
        """Nothing of the generation was delivered, so the client may retry."""
        self._json(
            {"error": {"message": "generation failed mid-flight (replica failover or engine fault); safe to retry",
                       "type": "engine_error", "code": 503}},
            503,
        )

    def _stream(self, req: Request, bridge: _TokenBridge, piece, stop, make_chunk, preamble=None) -> None:
        """Shared SSE loop: stop-sequence truncation (slot freed early),
        the trailing decoder flush, and cancel-on-disconnect."""
        scheduler = self.server.scheduler
        completed = False
        try:
            self._start(200, "text/event-stream", headers={"Cache-Control": "no-cache"})

            def write(data: bytes) -> None:
                self.wfile.write(data)
                self.wfile.flush()

            if preamble is not None:
                write(preamble)
            emitted = ""
            stopped = False
            while True:
                kind, value = bridge.get()
                if kind == "done":
                    tail = piece(0, final=True)
                    if tail and not stopped:
                        write(make_chunk(tail, None))
                    finish = "stop" if (stopped or value == "cancelled") else value
                    write(make_chunk(None, finish))
                    write(b"data: [DONE]\n\n")
                    completed = True
                    break
                if stopped:
                    continue
                text = piece(value)
                if not text:
                    continue
                emitted += text
                cut = _find_stop(emitted, stop)
                if cut is not None:
                    overshoot = len(emitted) - cut
                    if len(text) > overshoot:
                        write(make_chunk(text[: len(text) - overshoot], None))
                    stopped = True
                    scheduler.cancel(req.id)
                    continue
                write(make_chunk(text, None))
        except (BrokenPipeError, ConnectionResetError):
            logger.info("client disconnected from %s", req.id)
        finally:
            if not completed:
                scheduler.cancel(req.id)

    def _sampling(self, body: dict, default_max: int) -> SamplingParams:
        return SamplingParams(
            temperature=float(body.get("temperature", 0.2)),
            top_p=float(body.get("top_p", 0.7)),
            top_k=int(body.get("top_k", 0)),
            max_tokens=int(body.get("max_tokens", default_max)),
        )

    @staticmethod
    def _stops(body: dict) -> list[str]:
        stop = body.get("stop") or []
        return [stop] if isinstance(stop, str) else list(stop)

    # -- the telemetry shell ------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def _dispatch(self, method: str) -> None:
        """The engine's telemetry shell around a route: the request id
        (the caller's ``X-Request-Id`` or ``traceparent``, else new), a
        ``RequestTrace`` joined to the upstream span, and on finish the
        flight recorder and the ``engine.*`` TSDB/SLO feeds, so
        ``/debug/requests`` on the chain server and here line up."""
        from generativeaiexamples_tpu_torch.core.tracing import extract_trace_headers
        from generativeaiexamples_tpu_torch.obs.debug import feed_fleet_telemetry, obs_enabled
        from generativeaiexamples_tpu_torch.obs.recorder import get_flight_recorder
        from generativeaiexamples_tpu_torch.obs.trace import RequestTrace, new_request_id

        url = urllib.parse.urlsplit(self.path)
        route = url.path
        self._query = {k: v[0] for k, v in urllib.parse.parse_qs(url.query, keep_blank_values=True).items()}
        req_id, parent_span = extract_trace_headers(self.headers)
        self._request_id = req_id or new_request_id()
        self._status: Optional[int] = None
        trace = None
        if obs_enabled():
            trace = RequestTrace(request_id=self._request_id, route=route)
            if parent_span:
                trace.set_attr("parent_span_id", parent_span)
            if req_id:
                trace.set_attr("propagated", True)
        handler = self.server.routes.get((method, route))
        try:
            if handler is None:
                self._json({"error": {"message": f"no route {route}"}}, 404)
            else:
                handler(self)
        except Exception as exc:
            logger.exception("unhandled error in %s %s", method, route)
            if trace is not None:
                trace.mark_error(exc)
            if self._status is None:
                self._json({"error": {"message": "Internal Server Error"}}, 500)
            else:
                self._status = 500
        if trace is not None:
            snap = trace.finish(status=self._status)
            get_flight_recorder().record(snap)
            try:
                feed_fleet_telemetry(snap, prefix="engine")
            except Exception:  # telemetry must never fail a request
                logger.exception("engine fleet telemetry feed failed")

    # -- routes -----------------------------------------------------------

    def _models(self) -> None:
        self._json({
            "object": "list",
            "data": [{"id": self.server.model_name, "object": "model", "created": _now(),
                      "owned_by": "generativeaiexamples-tpu-torch"}],
        })

    def _health(self) -> None:
        """Liveness that checks the engine: a dead tick thread or an
        unhealthy replica reads ``degraded`` with 503; a firing SLO
        fast-burn alert reads ``degraded`` at 200 (the process serves)."""
        from generativeaiexamples_tpu_torch.obs.slo import slo_health

        engine = self.server.scheduler
        ok = bool(engine.healthy())
        slo = slo_health()
        degraded = (not ok) or bool(slo.get("degraded"))
        body = {"message": "Service is degraded." if degraded else "Service is up.",
                "status": "degraded" if degraded else "ok", "slo": slo}
        if hasattr(engine, "replica_states"):
            body["replicas"] = engine.replica_states()
        self._json(body, 200 if ok else 503)

    def _metrics(self) -> None:
        srv = self.server
        body = metrics_text(srv.scheduler, srv.embedder, srv.autoscaler).encode()
        self._start(200, "text/plain", len(body))
        self.wfile.write(body)

    def _admin_replicas(self) -> None:
        engine = self.server.scheduler
        if not hasattr(engine, "replicas"):
            self._json(_NOT_A_POOL, 501)
            return
        self._json({"replicas": engine.snapshot()["replicas"]})

    def _admin_drain(self) -> None:
        """``POST /admin/drain?replica=i``: stop placing on replica ``i``,
        migrate its queued requests, let in-flight ones finish, detach."""
        engine = self.server.scheduler
        if not hasattr(engine, "drain"):
            self._json(_NOT_A_POOL, 501)
            return
        try:
            idx = int(self._query["replica"])
        except (KeyError, ValueError):
            self._json({"error": {"message": "replica=<int> query parameter required"}}, 422)
            return
        try:
            state = engine.drain(idx)
        except ValueError as exc:
            self._json({"error": {"message": str(exc)}}, 404)
            return
        self._json({"replica": idx, "state": state})

    def _admin_scale(self) -> None:
        """``POST /admin/scale?replicas=n``: drive the pool to ``n`` healthy
        replicas (scale-down drains the least loaded; scale-up builds
        through the pool's ``scheduler_factory``)."""
        engine = self.server.scheduler
        if not hasattr(engine, "scale_to"):
            self._json({"error": {"message": "not a replica pool (started with --replicas 1 and no --autoscale)"}},
                       501)
            return
        try:
            n = int(self._query["replicas"])
            if n < 1:
                raise ValueError
        except (KeyError, ValueError):
            self._json({"error": {"message": "replicas=<int >= 1> query parameter required"}}, 422)
            return
        try:
            result = engine.scale_to(n)
        except RuntimeError as exc:  # no scheduler_factory to grow with
            self._json({"error": {"message": str(exc)}}, 409)
            return
        self._json(result)

    def _debug_requests(self) -> None:
        from generativeaiexamples_tpu_torch.obs.debug import debug_requests

        status, body = debug_requests(self._query)
        self._json(body, status)

    def _debug_timeseries(self) -> None:
        from generativeaiexamples_tpu_torch.obs.debug import debug_timeseries

        status, body = debug_timeseries(self._query)
        self._json(body, status)

    def _profiler_start(self) -> None:
        from generativeaiexamples_tpu_torch.obs.profiler import profiler_start

        status, body = profiler_start()
        self._json(body, status)

    def _profiler_stop(self) -> None:
        from generativeaiexamples_tpu_torch.obs.profiler import profiler_stop

        status, body = profiler_stop()
        self._json(body, status)

    def _chat(self) -> None:
        body = self._body()
        if body is None:
            return
        try:
            messages = [(m["role"], m["content"]) for m in body["messages"]]
        except (KeyError, TypeError) as exc:
            self._json({"error": {"message": str(exc)}}, 422)
            return
        srv = self.server
        stream = bool(body.get("stream", False))
        prompt_ids = srv.tokenizer.apply_chat_template(messages)
        bridge = _TokenBridge()
        req = Request(
            token_ids=list(prompt_ids),
            sampling=self._sampling(body, 1024),
            on_token=bridge.on_token,
            on_done=bridge.on_done,
            eos_id=srv.tokenizer.eos_id,
            id=f"chatcmpl-{uuid.uuid4().hex[:24]}",
            session_id=str(body.get("session_id") or body.get("user") or ""),
            # A stream must stay single-sourced; a whole answer may be hedged.
            hedgeable=not stream,
        )
        if not srv.scheduler.submit(req):
            self._overloaded()
            return
        piece = decode_stream(srv.tokenizer)
        stop = self._stops(body)
        if stream:

            def delta_chunk(delta: dict, finish: Optional[str]) -> bytes:
                payload = {
                    "id": req.id, "object": "chat.completion.chunk", "created": _now(),
                    "model": srv.model_name,
                    "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
                }
                return f"data: {json.dumps(payload)}\n\n".encode()

            def chunk(text: Optional[str], finish: Optional[str]) -> bytes:
                return delta_chunk({} if text is None else {"content": text}, finish)

            self._stream(req, bridge, piece, stop, chunk, preamble=delta_chunk({"role": "assistant"}, None))
            return
        text, n_tokens, finish = _aggregate_generation(bridge, piece, stop, srv.scheduler, req.id)
        if finish == "error":
            self._retryable_error()
            return
        self._json({
            "id": req.id, "object": "chat.completion", "created": _now(), "model": srv.model_name,
            "choices": [{"index": 0, "message": {"role": "assistant", "content": text},
                         "finish_reason": finish}],
            "usage": {"prompt_tokens": len(prompt_ids), "completion_tokens": n_tokens,
                      "total_tokens": len(prompt_ids) + n_tokens},
        })

    def _completions(self) -> None:
        body = self._body()
        if body is None:
            return
        srv = self.server
        prompt = body.get("prompt")
        if isinstance(prompt, list) and len(prompt) == 1:
            prompt = prompt[0]
        if isinstance(prompt, str):
            prompt_ids = srv.tokenizer.encode(prompt, add_bos=True)
        elif isinstance(prompt, list) and prompt and all(isinstance(t, int) for t in prompt):
            prompt_ids = list(prompt)
        else:
            self._json({"error": {"message": "prompt must be a string or a token-id list; "
                                             "multi-prompt batches are not supported"}}, 422)
            return
        stream = bool(body.get("stream", False))
        bridge = _TokenBridge()
        req = Request(
            token_ids=list(prompt_ids),
            sampling=self._sampling(body, 16),
            on_token=bridge.on_token,
            on_done=bridge.on_done,
            eos_id=srv.tokenizer.eos_id,
            id=f"cmpl-{uuid.uuid4().hex[:24]}",
            session_id=str(body.get("session_id") or body.get("user") or ""),
            hedgeable=not stream,
        )
        if not srv.scheduler.submit(req):
            self._overloaded()
            return
        piece = decode_stream(srv.tokenizer)
        stop = self._stops(body)
        if stream:

            def chunk(text: Optional[str], finish: Optional[str]) -> bytes:
                payload = {
                    "id": req.id, "object": "text_completion", "created": _now(),
                    "model": srv.model_name,
                    "choices": [{"index": 0, "text": text or "", "finish_reason": finish}],
                }
                return f"data: {json.dumps(payload)}\n\n".encode()

            self._stream(req, bridge, piece, stop, chunk)
            return
        text, n_tokens, finish = _aggregate_generation(bridge, piece, stop, srv.scheduler, req.id)
        if finish == "error":
            self._retryable_error()
            return
        self._json({
            "id": req.id, "object": "text_completion", "created": _now(), "model": srv.model_name,
            "choices": [{"index": 0, "text": text, "finish_reason": finish}],
            "usage": {"prompt_tokens": len(prompt_ids), "completion_tokens": n_tokens,
                      "total_tokens": len(prompt_ids) + n_tokens},
        })

    def _embeddings(self) -> None:
        body = self._body()
        if body is None:
            return
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not isinstance(inputs, list) or not all(isinstance(t, str) for t in inputs):
            self._json({"error": {"message": "input must be a string or a list of strings"}}, 422)
            return
        embedder = self.server.embedder
        if embedder is None:
            self._json({"error": {"message": "no embedder configured"}}, 501)
            return
        if body.get("input_type", "passage") == "query":
            # One query goes through embed_query, so that concurrent
            # requests coalesce in a BatchedEmbedder; several are already a
            # batch.
            if len(inputs) == 1:
                vectors = [embedder.embed_query(inputs[0])]
            elif hasattr(embedder, "embed_queries"):
                vectors = embedder.embed_queries(inputs)
            else:
                vectors = [embedder.embed_query(t) for t in inputs]
        else:
            vectors = embedder.embed_documents(inputs)
        self._json({
            "object": "list", "model": body.get("model", "arctic-embed-l"),
            "data": [{"object": "embedding", "index": i, "embedding": v} for i, v in enumerate(vectors)],
            "usage": {"prompt_tokens": 0, "total_tokens": 0},
        })

    def _ranking(self) -> None:
        """NeMo-Retriever-style reranking: {query: {text}, passages: [{text}]}."""
        body = self._body()
        if body is None:
            return
        try:
            query = body["query"]["text"] if isinstance(body.get("query"), dict) else body["query"]
            passages = [p["text"] if isinstance(p, dict) else p for p in body["passages"]]
            if not isinstance(query, str) or not all(isinstance(p, str) for p in passages):
                raise TypeError("query and passages must be text")
        except (KeyError, TypeError) as exc:
            self._json({"error": {"message": str(exc)}}, 422)
            return
        reranker = self.server.reranker
        if reranker is None:
            self._json({"error": {"message": "no reranker configured"}}, 501)
            return
        scores = reranker.score(query, passages)
        order = sorted(range(len(scores)), key=lambda i: -scores[i])
        self._json({"rankings": [{"index": i, "logit": scores[i]} for i in order]})


def rag_metrics_lines(snap: Optional[dict]) -> list[str]:
    """Prometheus lines for the embedding micro-batcher (rag_* series; a
    copy of the JAX package's ``server/app.py::rag_metrics_lines``).

    ``snap`` is a ``MicroBatcher.stats.snapshot()``, or None when batching
    is off: the series still export, at zero.  Mean batch size =
    ``rag_embed_batch_size_sum / _count``; a count that grows slower than
    ``rag_requests_total`` is the batching win.
    """
    s = snap or {}
    return [
        "# TYPE rag_requests_total counter",
        f"rag_requests_total {s.get('requests_total', 0)}",
        "# TYPE rag_batches_total counter",
        f"rag_batches_total {s.get('batches_total', 0)}",
        "# TYPE rag_embed_batch_size summary",
        f"rag_embed_batch_size_sum {s.get('batch_size_sum', 0)}",
        f"rag_embed_batch_size_count {s.get('batches_total', 0)}",
        "# TYPE rag_embed_batch_size_max gauge",
        f"rag_embed_batch_size_max {s.get('batch_size_max', 0)}",
        "# TYPE rag_queue_wait_ms summary",
        f"rag_queue_wait_ms_sum {s.get('queue_wait_ms_sum', 0.0)}",
        f"rag_queue_wait_ms_count {s.get('requests_total', 0)}",
        "# TYPE rag_errors_total counter",
        f"rag_errors_total {s.get('errors_total', 0)}",
    ]


def metrics_text(engine, embedder=None, autoscaler=None) -> str:
    """Prometheus exposition of the engine (a ``Scheduler``, or an
    ``EnginePool``'s aggregate with the per-replica ``engine_replica_*``
    and router families), in the reference's order: the engine's own
    series, the embedding micro-batcher's ``rag_*`` (at zero without one,
    the port's rule), store capacity and fabric families, the pool's sizes,
    resilience, admission, cache, stage latency, the tick histogram, SLO,
    durability and the gray-failure families.  Besides the reference's,
    the engine exports ``engine_ttft_p50_ms`` and ``engine_tick_ms_ewma``."""
    from generativeaiexamples_tpu_torch.cache.metrics import cache_metrics_lines
    from generativeaiexamples_tpu_torch.chains.factory import peek_collection_manager, peek_store
    from generativeaiexamples_tpu_torch.durability.metrics import durability_metrics_lines
    from generativeaiexamples_tpu_torch.engine.autoscale import pool_metrics_lines
    from generativeaiexamples_tpu_torch.engine.health import gray_metrics_lines
    from generativeaiexamples_tpu_torch.obs.metrics import engine_tick_metrics_lines, obs_metrics_lines
    from generativeaiexamples_tpu_torch.obs.slo import slo_metrics_lines
    from generativeaiexamples_tpu_torch.resilience.admission import admission_metrics_lines
    from generativeaiexamples_tpu_torch.resilience.metrics import resilience_metrics_lines
    from generativeaiexamples_tpu_torch.retrieval.fabric.metrics import (
        aggregate_capacity_stats,
        fabric_metrics_lines,
        store_metrics_lines,
    )

    snap = engine.stats.snapshot()
    series = [
        ("engine_requests_total", "counter", snap["requests_total"]),
        ("engine_tokens_total", "counter", snap["tokens_total"]),
        ("engine_ttft_avg_ms", "gauge", f"{snap['ttft_avg_ms']:.2f}"),
        ("engine_ttft_p50_ms", "gauge", f"{snap['ttft_p50_ms']:.2f}"),
        ("engine_active_slots", "gauge", snap["active_slots"]),
        ("engine_queued_requests", "gauge", snap["queued"]),
        # The 429 path: for a pool, client-visible refusals only (every
        # replica's queue full), not attempts a sibling absorbed.
        ("engine_rejected_total", "counter", snap["rejected_total"]),
        ("engine_prefix_hits_total", "counter", snap["prefix_hits"]),
        ("engine_prefix_tokens_reused_total", "counter", snap["prefix_tokens_reused"]),
        ("engine_shared_prefix_hits_total", "counter", snap["shared_prefix_hits"]),
        ("engine_prefill_chunks_total", "counter", snap["prefill_chunks"]),
        # Speculation (from zero whether or not the engine speculates):
        # acceptance = accepted / proposed; the gauges are the adaptive
        # controller's state.
        ("engine_spec_rounds_total", "counter", snap["spec_rounds"]),
        ("engine_spec_tokens_total", "counter", snap["spec_tokens"]),
        ("engine_spec_proposed_total", "counter", snap["spec_proposed"]),
        ("engine_spec_accepted_total", "counter", snap["spec_accepted"]),
        ("engine_spec_fallbacks_total", "counter", snap["spec_fallbacks"]),
        ("engine_spec_acceptance_ewma", "gauge", snap["spec_acceptance_ewma"]),
        ("engine_spec_gamma", "gauge", snap["spec_gamma"]),
        ("engine_tick_ms_ewma", "gauge", snap["tick_ms_ewma"]),
        # Paged KV pool (0 under the contiguous cache): parked = pages held
        # by parked prefix segments, shared = refcount > 1 (COW-armed).
        ("engine_kv_pages_total", "gauge", snap["kv_pages_total"]),
        ("engine_kv_pages_free", "gauge", snap["kv_pages_free"]),
        ("engine_kv_pages_parked", "gauge", snap["kv_pages_parked"]),
        ("engine_kv_pages_shared", "gauge", snap["kv_pages_shared"]),
        ("engine_kv_page_utilization", "gauge", snap["kv_page_utilization"]),
        ("engine_kv_cow_breaks_total", "counter", snap["kv_cow_breaks"]),
        ("engine_kv_page_evictions_total", "counter", snap["kv_page_evictions"]),
    ]
    lines = []
    for name, kind, value in series:
        lines += [f"# TYPE {name} {kind}", f"{name} {value}"]
    # The live projection path, every known value exported (1 on the live one).
    replicas = getattr(engine, "replicas", None)
    active = getattr(engine, "matmul_kernel", None) or next(
        (r.scheduler.matmul_kernel for r in replicas or () if getattr(r.scheduler, "matmul_kernel", None)), "xla")
    lines.append("# TYPE engine_matmul_kernel gauge")
    for kernel in ("xla", "pallas_w8a8"):
        lines.append(f'engine_matmul_kernel{{kernel="{kernel}"}} {1 if kernel == active else 0}')
    rows = snap.get("replicas")
    if rows is not None:
        for name, key in (("engine_router_failovers_total", "router_failovers_total"),
                          ("engine_router_requeued_total", "router_requeued_total"),
                          ("engine_router_session_evictions_total", "session_evictions_total")):
            lines += [f"# TYPE {name} counter", f"{name} {snap.get(key, 0)}"]
        for name, kind, key in (("engine_replica_healthy", "gauge", "healthy"),
                                ("engine_replica_queued", "gauge", "queued"),
                                ("engine_replica_active_slots", "gauge", "active_slots"),
                                ("engine_replica_requests_total", "counter", "requests_total"),
                                ("engine_replica_rejected_total", "counter", "rejected_total"),
                                ("engine_replica_prefix_hits_total", "counter", "prefix_hits"),
                                ("engine_replica_shared_prefix_hits_total", "counter", "shared_prefix_hits")):
            lines.append(f"# TYPE {name} {kind}")
            lines += [f'{name}{{replica="{row["replica"]}"}} {row[key]}' for row in rows]
    batcher = getattr(embedder, "batcher", None)
    lines += rag_metrics_lines(batcher.stats.snapshot() if batcher is not None else None)
    # Peek-only: a scrape builds no store or collection manager.
    store, manager = peek_store(), peek_collection_manager()
    lines += store_metrics_lines(aggregate_capacity_stats(store, manager),
                                 manager.capacity_by_collection() if manager is not None else None)
    lines += fabric_metrics_lines(store, manager)
    lines += pool_metrics_lines(engine, autoscaler)
    lines += resilience_metrics_lines()
    lines += admission_metrics_lines()
    lines += cache_metrics_lines()
    lines += obs_metrics_lines()
    lines += engine_tick_metrics_lines()
    lines += slo_metrics_lines()
    lines += durability_metrics_lines()
    lines += gray_metrics_lines(engine)
    return "\n".join(lines) + "\n"


# (method, path) -> handler method of ``_Handler``.
ROUTES = {
    ("GET", "/v1/models"): _Handler._models,
    ("GET", "/health"): _Handler._health,
    ("GET", "/metrics"): _Handler._metrics,
    ("GET", "/admin/replicas"): _Handler._admin_replicas,
    ("POST", "/admin/drain"): _Handler._admin_drain,
    ("POST", "/admin/scale"): _Handler._admin_scale,
    ("GET", "/debug/requests"): _Handler._debug_requests,
    ("GET", "/debug/timeseries"): _Handler._debug_timeseries,
    ("POST", "/v1/chat/completions"): _Handler._chat,
    ("POST", "/v1/completions"): _Handler._completions,
    ("POST", "/v1/embeddings"): _Handler._embeddings,
    ("POST", "/v1/ranking"): _Handler._ranking,
}
# Served only when the profiler gate is open (``obs/profiler.py``).
PROFILER_ROUTES = {
    ("POST", "/debug/profiler/start"): _Handler._profiler_start,
    ("POST", "/debug/profiler/stop"): _Handler._profiler_stop,
}


class EngineServer(ThreadingHTTPServer):
    """HTTP server bound to one engine (``scheduler``: a ``Scheduler`` or an
    ``EnginePool``); ``serve_forever`` serves."""

    daemon_threads = True
    # Listen backlog (http.server's default is 5): a burst of concurrent
    # clients must queue, not be reset; aiohttp, the reference's front,
    # listens with 128.
    request_queue_size = 128

    def __init__(self, address, scheduler, tokenizer, model_name: str, embedder=None, reranker=None,
                 enable_profiler: bool = False) -> None:
        super().__init__(address, _Handler)
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.embedder = embedder
        self.reranker = reranker
        # The autoscaler over a pool, when ``build_server`` runs one.
        self.autoscaler = None
        self.routes = {**ROUTES, **(PROFILER_ROUTES if enable_profiler else {})}


def create_engine_app(
    scheduler, tokenizer, model_name: str = "llama3-8b", host: str = "127.0.0.1", port: int = 0, *,
    embedder=None, reranker=None, enable_profiler: Optional[bool] = None,
) -> EngineServer:
    """Bind the OpenAI-compatible front over one engine: a ``Scheduler`` or
    an ``engine.replica.EnginePool`` (both expose ``submit`` / ``cancel`` /
    ``stats.snapshot()`` / ``healthy``; the pool also serves ``/admin/*``,
    which answer 501 over a bare scheduler).  It runs on the device it was
    built for (``Scheduler`` defaults to CUDA).  ``embedder`` serves
    ``/v1/embeddings`` and ``reranker`` ``/v1/ranking`` (501 without one);
    the profiler routes exist when ``enable_profiler`` (default: the
    ``GAIE_ENABLE_PROFILER`` gate).  Port 0 picks a free port
    (``server.server_address``)."""
    from generativeaiexamples_tpu_torch.obs.profiler import profiler_enabled

    enable = profiler_enabled() if enable_profiler is None else bool(enable_profiler)
    return EngineServer((host, port), scheduler, tokenizer, model_name, embedder, reranker, enable)


def drain_engine(engine, timeout: float = 15.0) -> None:
    """Graceful retirement at shutdown: drain every pool replica (queued
    requests migrate while survivors exist, in-flight generations finish),
    wait up to ``timeout`` for them to detach, then stop the tick threads.
    A bare ``Scheduler`` just stops."""
    if hasattr(engine, "drain"):
        from generativeaiexamples_tpu_torch.engine.replica import DETACHED, UNHEALTHY

        for i in range(len(engine.replicas)):
            try:
                engine.drain(i)
            except Exception:
                logger.exception("shutdown drain of replica %d failed", i)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(s["state"] in (DETACHED, UNHEALTHY) for s in engine.replica_states()):
                break
            time.sleep(0.05)
    try:
        engine.stop()
    except Exception:
        logger.exception("engine stop failed during shutdown")


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    """The engine server's command line (``GAIE_*`` environment defaults
    for the speculation flags, as in the reference)."""
    parser = argparse.ArgumentParser(description="PyTorch/CUDA model-serving engine")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model", default="llama3-8b",
                        help="model preset or HF id: the Llama-3 family (llama3-8b, llama3-70b, llama3.2-1b), "
                             "mixtral-8x7b, gemma-2b, gemma-7b, starcoder2-3b (e.g. google/gemma-7b, "
                             "bigcode/starcoder2-3b, mistralai/Mixtral-8x7B-Instruct-v0.1), or a tiny preset "
                             "for --device cpu (llama-tiny, llama-moe-tiny, gemma-tiny, starcoder2-tiny)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--max-batch", type=int, default=SERVING_DEFAULTS["max_batch"])
    parser.add_argument("--max-len", type=int, default=SERVING_DEFAULTS["max_len"])
    parser.add_argument("--decode-chunk-size", type=int, default=SERVING_DEFAULTS["decode_chunk_size"])
    parser.add_argument("--prefill-chunk-tokens", type=int, default=SERVING_DEFAULTS["prefill_chunk_tokens"])
    parser.add_argument("--prefix-cache", default=SERVING_DEFAULTS["prefix_cache"],
                        choices=["shared", "session", "off"])
    parser.add_argument("--matmul-kernel", default=os.environ.get("GAIE_MATMUL_KERNEL", ""),
                        choices=["", "xla", "pallas_w8a8"],
                        help="projection path: 'xla' serves the weights as loaded (float, or random bf16 from "
                             "--seed) over the preset's KV dtype; 'pallas_w8a8' quantizes them to int8, blocks them "
                             "once for the W8A8 kernel and serves an int8 KV cache. Empty falls back to "
                             "[llm].matmul_kernel in config (default xla)")
    parser.add_argument("--kv-layout", default=SERVING_DEFAULTS["kv_layout"], choices=["contiguous", "paged"],
                        help="KV cache layout: one max_len row per slot, or pages of a shared pool (int8 KV)")
    parser.add_argument("--kv-page-size", type=int, default=64, help="tokens per KV page (a power of two)")
    parser.add_argument("--kv-pool-pages", type=int, default=None,
                        help="pages in the paged pool (default and floor: max_batch * pages per slot + 1)")
    parser.add_argument("--draft-model", default=os.environ.get("GAIE_DRAFT_MODEL", ""),
                        help="draft model preset for speculative decoding (empty: none); without a checkpoint, "
                             "random from --seed; on xla it keeps its preset's KV dtype and float weights, on "
                             "pallas_w8a8 it is W8A8 with int8 KV")
    parser.add_argument("--spec-ngram", action="store_true", default=os.environ.get("GAIE_SPEC_NGRAM", "") == "1",
                        help="prompt-lookup speculation: drafts from the request's own prompt and output (no draft "
                             "model); excludes --draft-model")
    parser.add_argument("--spec-decode", action="store_true", default=os.environ.get("GAIE_SPEC_DECODE", "") == "1",
                        help="speculative decoding in the scheduler: the --draft-model (or [llm].draft_model) "
                             "proposes and the target verifies; without one, prompt lookup")
    gamma = os.environ.get("GAIE_SPEC_GAMMA")
    parser.add_argument("--gamma", "--spec-gamma", dest="gamma", type=int, default=int(gamma) if gamma else None,
                        help="largest speculation lookahead, draft tokens per round (default [llm].spec_gamma, "
                             "else 4; the adaptive controller only shrinks below it)")
    parser.add_argument("--draft-checkpoint", default=os.environ.get("GAIE_DRAFT_CHECKPOINT", ""),
                        help="HF weights directory for the draft model (default: $GAIE_WEIGHTS_DIR/<draft model>)")
    parser.add_argument("--embedder", default="tiny", choices=["tiny", "arctic", "none"],
                        help="BERT embedder behind /v1/embeddings: bert-tiny (random, seed 0), arctic-embed-l "
                             "(the --embedder-model checkpoint when one is provisioned, else random, seed 0), or none")
    parser.add_argument("--embedder-model", default="snowflake/arctic-embed-l",
                        help="HF id used to look up the embedder's checkpoint under $GAIE_WEIGHTS_DIR "
                             "(with --embedder arctic)")
    parser.add_argument("--embed-max-batch", type=int, default=32,
                        help="concurrent single-query /v1/embeddings requests that share one forward (0/1: off)")
    parser.add_argument("--embed-max-wait-ms", type=float, default=3.0,
                        help="how long a query waits for batch-mates before its batch runs anyway")
    parser.add_argument("--seed", type=int, default=SERVING_DEFAULTS["seed"])
    from generativeaiexamples_tpu_torch.engine.router import POLICIES

    parser.add_argument("--replicas", type=int, default=int(os.environ.get("GAIE_REPLICAS", "1")),
                        help="scheduler replicas behind the request router (engine.replica.EnginePool); on one card "
                             "they share the device and one weight tree, each with its own KV cache. 1: a single "
                             "scheduler")
    parser.add_argument("--routing-policy", default=os.environ.get("GAIE_ROUTING_POLICY", "prefix"),
                        choices=list(POLICIES),
                        help="replica placement: 'prefix' (longest cached-prefix match through router-side radix "
                             "mirrors, else least-loaded), 'session' (sticky by conversation id), 'least_loaded', "
                             "'round_robin'. Only meaningful with --replicas > 1")
    parser.add_argument("--autoscale", action="store_true", default=os.environ.get("GAIE_AUTOSCALE", "") == "1",
                        help="run the SLO-driven autoscaler over the replica pool (knobs in the [autoscale] config "
                             "section; its enabled key turns it on too); implies the pool even with --replicas 1")
    parser.add_argument("-v", "--verbose", action="count", default=None)
    return parser.parse_args(argv)


def resolve_matmul_kernel(args: argparse.Namespace) -> str:
    """The projection path as the reference resolves it: the flag (whose
    default is ``GAIE_MATMUL_KERNEL``), then ``[llm].matmul_kernel``, then
    ``xla``."""
    from generativeaiexamples_tpu_torch.core.configuration import get_config

    return args.matmul_kernel or str(getattr(get_config().llm, "matmul_kernel", "") or "xla")


def serving_config(preset: str, matmul_kernel: str, kv_layout: str = "contiguous"):
    """The preset's config as served: its own KV dtype on ``xla`` and the
    contiguous layout (the reference's default, bf16), int8 on the port's
    ``pallas_w8a8`` route; the paged pool stores int8 pages, so paged
    overrides the preset's KV dtype, as the reference does."""
    import dataclasses

    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.PRESETS[preset]()
    if matmul_kernel == "pallas_w8a8" and cfg.kv_dtype != "int8":
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    if kv_layout == "paged" and cfg.kv_dtype != "int8":
        logger.info("kv_layout=paged requires int8 KV; overriding kv_dtype=%s", cfg.kv_dtype)
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    return cfg


def spec_scheduler_kwargs(args: argparse.Namespace, cfg, device, matmul_kernel: Optional[str] = None) -> dict:
    """The ``Scheduler`` speculation kwargs from the command line, with the
    ``[llm]`` config (``spec_decode``, ``draft_model``, ``spec_gamma``)
    as fallbacks; explicit flags win.  ``--gamma`` and ``--spec-gamma``
    (the reference's two names) set one value.  ``--spec-decode`` without a draft
    model means prompt lookup.  The draft loads from ``--draft-checkpoint``
    or ``$GAIE_WEIGHTS_DIR/<draft model>`` (its preset's geometry), else is
    random from ``--seed``; on ``xla`` it keeps its preset's KV dtype and
    float weights (the reference's bf16 draft), on ``pallas_w8a8`` it is
    W8A8 with int8 KV (``matmul_kernel`` None: :func:`resolve_matmul_kernel`).
    The draft cache is contiguous on either layout.  Empty when nothing
    speculates."""
    from generativeaiexamples_tpu_torch.core.configuration import get_config

    llm_cfg = get_config().llm
    spec_decode = args.spec_decode or bool(getattr(llm_cfg, "spec_decode", False))
    draft_model = args.draft_model or str(getattr(llm_cfg, "draft_model", "") or "")
    gamma = args.gamma if args.gamma is not None else int(getattr(llm_cfg, "spec_gamma", 0) or 0) or 4
    if args.spec_ngram and draft_model:
        raise ValueError("--spec-ngram and --draft-model are mutually exclusive")
    if args.spec_ngram or (spec_decode and not draft_model):
        return {"spec_mode": "ngram", "gamma": gamma}
    if not draft_model:
        return {}
    import dataclasses

    from generativeaiexamples_tpu_torch.engine.weights import resolve_model_preset, weights_dir_for
    from generativeaiexamples_tpu_torch.models import llama

    matmul_kernel = matmul_kernel or resolve_matmul_kernel(args)
    dcfg = llama.PRESETS[resolve_model_preset(draft_model)]()
    if matmul_kernel == "pallas_w8a8":
        dcfg = dataclasses.replace(dcfg, kv_dtype="int8")
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError(f"draft {draft_model!r} has vocab {dcfg.vocab_size}, the model {cfg.vocab_size}")
    dparams = load_serving_params(dcfg, args.draft_checkpoint or weights_dir_for(draft_model), device, args.seed,
                                  what=f"draft {draft_model}", matmul_kernel=matmul_kernel, pack=True)
    return {"draft_cfg": dcfg, "draft_params": dparams, "gamma": gamma}


def load_serving_params(cfg, ckpt_dir: Optional[str], device, seed: int, what: str, matmul_kernel: str = "xla",
                        pack: bool = False):
    """Serving params: the HF checkpoint in ``ckpt_dir`` (geometry from
    ``cfg``, the preset's, as in the reference), or random weights from
    ``seed`` when there is none, laid out on ``device`` for
    ``matmul_kernel``: on ``xla`` as loaded (random: float in the compute
    dtype; ``pack`` fuses qkv and gate/up, as the reference's draft is);
    on ``pallas_w8a8`` quantized, packed and blocked for the W8A8 kernel
    (random: int8)."""
    import torch

    from generativeaiexamples_tpu_torch.engine.decode import prepare_params, w8a8_params
    from generativeaiexamples_tpu_torch.engine.weights import load_hf_causal_lm

    w8a8 = matmul_kernel == "pallas_w8a8"
    with torch.inference_mode():
        if ckpt_dir:
            logger.info("loading %s weights from %s", what, ckpt_dir)
            params = load_hf_causal_lm(cfg, ckpt_dir, device=device)
            gen = None
        else:
            logger.warning("no checkpoint for %s under $GAIE_WEIGHTS_DIR; serving random %s weights (seed %d)",
                           what, "int8" if w8a8 else "float", seed)
            params = None
            gen = torch.Generator(device=device).manual_seed(seed)
        if w8a8:
            return w8a8_params(cfg, params, device=device, generator=gen)
        return prepare_params(cfg, params, device=device, pack=pack, matmul_kernel="xla", generator=gen)


def build_server(argv: Optional[list[str]] = None) -> EngineServer:
    """Parse the command line and build the engine and its HTTP front; the
    caller starts ``server.scheduler`` and serves.

    With ``--replicas N`` (N > 1) or ``--autoscale`` (or
    ``[autoscale].enabled``) the engine is an ``EnginePool`` of N
    schedulers over one weight tree, each with its own KV cache, with a
    ``scheduler_factory`` that builds more alike (``/admin/scale``, the
    autoscaler); the autoscaler, when asked for, runs from here
    (``server.autoscaler``).  On a card the kernels are built before the
    pool's stall monitor can watch a first tick wait on ``nvcc``."""
    import dataclasses

    import torch

    from generativeaiexamples_tpu_torch.core.configuration import get_config
    from generativeaiexamples_tpu_torch.core.device import resolve_device
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.engine.weights import resolve_model_preset, weights_dir_for

    args = parse_args(argv)
    configure_logging(args.verbose)

    device = resolve_device(args.device)
    preset = resolve_model_preset(args.model)
    matmul_kernel = resolve_matmul_kernel(args)
    cfg = serving_config(preset, matmul_kernel, args.kv_layout)
    if cfg.n_experts > 1:
        # Serving routes droplessly, as HF Mixtral does; capacity dropping
        # is a training trade-off.
        cfg = dataclasses.replace(cfg, moe_dropless=True)
    params = load_serving_params(cfg, weights_dir_for(args.model), device, args.seed, what=args.model,
                                 matmul_kernel=matmul_kernel)
    spec = spec_scheduler_kwargs(args, cfg, device, matmul_kernel)

    def make_scheduler() -> Scheduler:
        # Every replica, the pool's later ones too, closes over the same
        # params (laid out once above, so none is copied) and draft.
        return Scheduler(
            cfg, params, device=device, max_batch=args.max_batch, max_len=args.max_len,
            decode_chunk_size=args.decode_chunk_size, seed=args.seed,
            prefill_chunk_tokens=args.prefill_chunk_tokens or None, prefix_cache=args.prefix_cache,
            kv_layout=args.kv_layout, kv_page_size=args.kv_page_size, kv_pool_pages=args.kv_pool_pages,
            matmul_kernel=matmul_kernel, **spec,
        )

    autoscale = args.autoscale or bool(get_config().autoscale.enabled)
    if args.replicas > 1 or autoscale:
        from generativeaiexamples_tpu_torch.engine.replica import EnginePool

        if device.type == "cuda":
            from generativeaiexamples_tpu_torch.ops import _cuda

            _cuda.build()
        engine = EnginePool([make_scheduler() for _ in range(max(1, args.replicas))], policy=args.routing_policy,
                            scheduler_factory=make_scheduler)
    else:
        engine = make_scheduler()
    embedder = None
    if args.embedder != "none":
        from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
        from generativeaiexamples_tpu_torch.engine.weights import bert_config_from_hf, load_hf_bert
        from generativeaiexamples_tpu_torch.models import bert

        # Only --embedder arctic looks up a checkpoint: tiny stays a fast
        # random dev embedder even when one is provisioned (the reference's rule).
        embed_ckpt = weights_dir_for(args.embedder_model) if args.embedder == "arctic" else None
        if embed_ckpt:
            logger.info("loading embedder weights from %s", embed_ckpt)
            bcfg = bert_config_from_hf(embed_ckpt)
            with torch.inference_mode():
                embed_params = load_hf_bert(bcfg, embed_ckpt, device=device)
            embedder = GPUEmbedder(bcfg, embed_params, tokenizer=get_tokenizer(embed_ckpt), device=device)
        else:
            bcfg = bert.arctic_embed_l() if args.embedder == "arctic" else bert.bert_tiny()
            embedder = GPUEmbedder(bcfg, device=device)
        if args.embed_max_batch > 1:
            from generativeaiexamples_tpu_torch.engine.microbatch import BatchedEmbedder

            embedder = BatchedEmbedder(embedder, max_batch=args.embed_max_batch, max_wait_ms=args.embed_max_wait_ms)
    tokenizer = get_tokenizer(args.model)
    server = create_engine_app(engine, tokenizer, args.model, args.host, args.port, embedder=embedder)
    if autoscale:
        from generativeaiexamples_tpu_torch.engine.autoscale import Autoscaler

        server.autoscaler = Autoscaler(engine)
        server.autoscaler.start()
    speculation = spec.get("spec_mode") or ("draft" if spec else "off")
    matmul = getattr(engine, "matmul_kernel", None) or engine.replicas[0].scheduler.matmul_kernel
    logger.info("engine server on %s:%d (model %s, device %s, matmul %s, kv %s %s, tokenizer %s, embedder %s, "
                "speculation %s, replicas %d, routing %s, autoscale %s)", args.host, server.server_address[1], preset,
                device, matmul, cfg.kv_dtype, args.kv_layout, type(tokenizer).__name__, args.embedder, speculation,
                len(getattr(engine, "replicas", [engine])), args.routing_policy, autoscale)
    return server


def main(argv: Optional[list[str]] = None) -> None:
    """``python -m generativeaiexamples_tpu_torch.engine.server``."""
    server = build_server(argv)
    engine = server.scheduler
    engine.start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if server.autoscaler is not None:
            server.autoscaler.stop()
        drain_engine(engine)
        if hasattr(server.embedder, "close"):
            server.embedder.close()


if __name__ == "__main__":
    main()
