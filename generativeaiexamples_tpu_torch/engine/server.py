"""OpenAI-compatible serving front over the port's scheduler (port of the
single-engine part of ``engine/server.py``).

Built on the standard library (``http.server.ThreadingHTTPServer``, SSE
written by hand), with the reference's routes and JSON:
``/v1/completions``, ``/v1/chat/completions``, ``/v1/embeddings``,
``/v1/ranking``, ``/v1/models``, ``/health`` and ``/metrics``.  One thread
per connection; tokens cross from the scheduler thread through a
``queue.Queue`` per request.

Run: ``python -m generativeaiexamples_tpu_torch.engine.server --model llama3-8b``
(``--kv-layout paged`` serves from the paged KV pool; ``--embedder`` picks
the BERT embedder behind ``/v1/embeddings``).
"""

from __future__ import annotations

import argparse
import json
import queue
import time
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


class _Handler(BaseHTTPRequestHandler):
    server: "EngineServer"

    def log_message(self, fmt, *args) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    # -- plumbing ---------------------------------------------------------

    def _json(self, payload: dict, status: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
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

    def _retryable_error(self) -> None:
        self._json(
            {"error": {"message": "generation failed mid-flight (engine fault); safe to retry",
                       "type": "engine_error", "code": 503}},
            503,
        )

    def _stream(self, req: Request, bridge: _TokenBridge, piece, stop, make_chunk, preamble=None) -> None:
        """Shared SSE loop: stop-sequence truncation (slot freed early),
        the trailing decoder flush, and cancel-on-disconnect."""
        scheduler = self.server.scheduler
        completed = False
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

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

    # -- routes -----------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802
        route = self.path.split("?", 1)[0]
        if route == "/v1/models":
            self._json({
                "object": "list",
                "data": [{"id": self.server.model_name, "object": "model", "created": _now(),
                          "owned_by": "generativeaiexamples-tpu-torch"}],
            })
        elif route == "/health":
            ok = bool(self.server.scheduler.healthy())
            self._json(
                {"message": "Service is up." if ok else "Service is degraded.",
                 "status": "ok" if ok else "degraded"},
                200 if ok else 503,
            )
        elif route == "/metrics":
            body = metrics_text(self.server.scheduler, self.server.embedder).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json({"error": {"message": f"no route {route}"}}, 404)

    def do_POST(self) -> None:  # noqa: N802
        route = self.path.split("?", 1)[0]
        if route == "/v1/chat/completions":
            self._chat()
        elif route == "/v1/completions":
            self._completions()
        elif route == "/v1/embeddings":
            self._embeddings()
        elif route == "/v1/ranking":
            self._ranking()
        else:
            self._json({"error": {"message": f"no route {route}"}}, 404)

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
        )
        srv.scheduler.submit(req)
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
        )
        srv.scheduler.submit(req)
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


def metrics_text(scheduler, embedder=None) -> str:
    """Prometheus exposition of the scheduler's own stats and the embedding
    micro-batcher's ``rag_*`` series."""
    snap = scheduler.stats.snapshot()
    series = [
        ("engine_requests_total", "counter", snap["requests_total"]),
        ("engine_tokens_total", "counter", snap["tokens_total"]),
        ("engine_ttft_avg_ms", "gauge", f"{snap['ttft_avg_ms']:.2f}"),
        ("engine_ttft_p50_ms", "gauge", f"{snap['ttft_p50_ms']:.2f}"),
        ("engine_active_slots", "gauge", snap["active_slots"]),
        ("engine_queued_requests", "gauge", snap["queued"]),
        ("engine_prefix_hits_total", "counter", snap["prefix_hits"]),
        ("engine_prefix_tokens_reused_total", "counter", snap["prefix_tokens_reused"]),
        ("engine_shared_prefix_hits_total", "counter", snap["shared_prefix_hits"]),
        ("engine_prefill_chunks_total", "counter", snap["prefill_chunks"]),
        ("engine_tick_ms_ewma", "gauge", snap["tick_ms_ewma"]),
        # Paged KV pool (0 under the contiguous cache): parked = pages held
        # by parked prefix segments, shared = refcount > 1 (COW-armed).
        ("engine_kv_pages_total", "gauge", snap["kv_pages_total"]),
        ("engine_kv_pages_free", "gauge", snap["kv_pages_free"]),
        ("engine_kv_pages_parked", "gauge", snap["kv_pages_parked"]),
        ("engine_kv_pages_shared", "gauge", snap["kv_pages_shared"]),
        ("engine_kv_cow_breaks_total", "counter", snap["kv_cow_breaks"]),
        ("engine_kv_page_evictions_total", "counter", snap["kv_page_evictions"]),
    ]
    lines = []
    for name, kind, value in series:
        lines += [f"# TYPE {name} {kind}", f"{name} {value}"]
    lines.append("# TYPE engine_matmul_kernel gauge")
    lines.append(f'engine_matmul_kernel{{kernel="{scheduler.matmul_kernel}"}} 1')
    batcher = getattr(embedder, "batcher", None)
    lines += rag_metrics_lines(batcher.stats.snapshot() if batcher is not None else None)
    return "\n".join(lines) + "\n"


class EngineServer(ThreadingHTTPServer):
    """HTTP server bound to one scheduler; ``serve_forever`` serves."""

    daemon_threads = True
    # Listen backlog (http.server's default is 5): a burst of concurrent
    # clients must queue, not be reset; aiohttp, the reference's front,
    # listens with 128.
    request_queue_size = 128

    def __init__(self, address, scheduler, tokenizer, model_name: str, embedder=None, reranker=None) -> None:
        super().__init__(address, _Handler)
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.embedder = embedder
        self.reranker = reranker


def create_engine_app(
    scheduler, tokenizer, model_name: str = "llama3-8b", host: str = "127.0.0.1", port: int = 0, *,
    embedder=None, reranker=None,
) -> EngineServer:
    """Bind the OpenAI-compatible front over ``scheduler`` (which runs on
    the device it was built for; ``Scheduler`` defaults to CUDA), with
    ``embedder`` behind ``/v1/embeddings`` and ``reranker`` behind
    ``/v1/ranking`` (501 without one).  Port 0 picks a free port
    (``server.server_address``)."""
    return EngineServer((host, port), scheduler, tokenizer, model_name, embedder, reranker)


def drain_engine(engine, timeout: float = 15.0) -> None:
    """Stop the scheduler's tick thread (single engine: nothing to migrate)."""
    try:
        engine.stop()
    except Exception:
        logger.exception("engine stop failed during shutdown")


def build_server(argv: Optional[list[str]] = None) -> EngineServer:
    """Parse the command line and build the engine and its HTTP front; the
    caller starts ``server.scheduler`` and serves."""
    import dataclasses

    import torch

    from generativeaiexamples_tpu_torch.core.device import resolve_device
    from generativeaiexamples_tpu_torch.engine.decode import prepare_params
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.engine.weights import resolve_model_preset
    from generativeaiexamples_tpu_torch.models import llama

    parser = argparse.ArgumentParser(description="PyTorch/CUDA model-serving engine")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model", default="llama3-8b", help="model preset or HF id")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--max-batch", type=int, default=SERVING_DEFAULTS["max_batch"])
    parser.add_argument("--max-len", type=int, default=SERVING_DEFAULTS["max_len"])
    parser.add_argument("--decode-chunk-size", type=int, default=SERVING_DEFAULTS["decode_chunk_size"])
    parser.add_argument("--prefill-chunk-tokens", type=int, default=SERVING_DEFAULTS["prefill_chunk_tokens"])
    parser.add_argument("--prefix-cache", default=SERVING_DEFAULTS["prefix_cache"],
                        choices=["shared", "session", "off"])
    parser.add_argument("--kv-layout", default=SERVING_DEFAULTS["kv_layout"], choices=["contiguous", "paged"],
                        help="KV cache layout: one max_len row per slot, or pages of a shared pool")
    parser.add_argument("--kv-page-size", type=int, default=64, help="tokens per KV page (a power of two)")
    parser.add_argument("--kv-pool-pages", type=int, default=None,
                        help="pages in the paged pool (default and floor: max_batch * pages per slot + 1)")
    parser.add_argument("--embedder", default="tiny", choices=["tiny", "arctic", "none"],
                        help="BERT embedder behind /v1/embeddings (random weights, seed 0): bert-tiny, "
                             "arctic-embed-l, or none")
    parser.add_argument("--embed-max-batch", type=int, default=32,
                        help="concurrent single-query /v1/embeddings requests that share one forward (0/1: off)")
    parser.add_argument("--embed-max-wait-ms", type=float, default=3.0,
                        help="how long a query waits for batch-mates before its batch runs anyway")
    parser.add_argument("--seed", type=int, default=SERVING_DEFAULTS["seed"])
    parser.add_argument("-v", "--verbose", action="count", default=None)
    args = parser.parse_args(argv)
    configure_logging(args.verbose)

    device = resolve_device(args.device)
    preset = resolve_model_preset(args.model)
    cfg = dataclasses.replace(llama.PRESETS[preset](), kv_dtype="int8")
    logger.warning("no checkpoint loading in the port yet: serving random int8 weights (seed %d)", args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = prepare_params(cfg, None, device=device, generator=gen)
    engine = Scheduler(
        cfg, params, device=device, max_batch=args.max_batch, max_len=args.max_len,
        decode_chunk_size=args.decode_chunk_size, seed=args.seed,
        prefill_chunk_tokens=args.prefill_chunk_tokens or None, prefix_cache=args.prefix_cache,
        kv_layout=args.kv_layout, kv_page_size=args.kv_page_size, kv_pool_pages=args.kv_pool_pages,
    )
    embedder = None
    if args.embedder != "none":
        from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
        from generativeaiexamples_tpu_torch.models import bert

        bcfg = bert.arctic_embed_l() if args.embedder == "arctic" else bert.bert_tiny()
        embedder = GPUEmbedder(bcfg, device=device)
        if args.embed_max_batch > 1:
            from generativeaiexamples_tpu_torch.engine.microbatch import BatchedEmbedder

            embedder = BatchedEmbedder(embedder, max_batch=args.embed_max_batch, max_wait_ms=args.embed_max_wait_ms)
    server = create_engine_app(engine, get_tokenizer(args.model), args.model, args.host, args.port, embedder=embedder)
    logger.info("engine server on %s:%d (model %s, device %s, kv %s, embedder %s)", args.host,
                server.server_address[1], preset, device, args.kv_layout, args.embedder)
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
        drain_engine(engine)
        if hasattr(server.embedder, "close"):
            server.embedder.close()


if __name__ == "__main__":
    main()
