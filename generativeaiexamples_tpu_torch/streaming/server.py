"""Streaming chain server: ``/storeStreamingText`` + intent-routed
``/generate`` (port of ``streaming/server.py``).

The ASR front end (or the file-replay harness) POSTs transcript fragments;
questions are answered through :class:`streaming.chains.StreamingChains`
with the chain server's SSE framing (``server.app._sse`` /
``_content_chunk`` / ``_done_chunk``).  The reference serves on aiohttp;
the port serves on ``http.server``, as the rest of the port does (the card
machine has no aiohttp): one thread per connection, HTTP/1.0 responses,
the SSE body streamed until the connection closes.

  python -m generativeaiexamples_tpu_torch.streaming.server --port 8082
"""

from __future__ import annotations

import json
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.server import schema
from generativeaiexamples_tpu_torch.server.app import _content_chunk, _done_chunk, _sse
from generativeaiexamples_tpu_torch.streaming.accumulator import TextAccumulator
from generativeaiexamples_tpu_torch.streaming.chains import StreamingChains
from generativeaiexamples_tpu_torch.streaming.timestamps import TimestampDatabase

logger = get_logger(__name__)


class _Handler(BaseHTTPRequestHandler):
    server: "StreamingServer"

    def log_message(self, fmt, *args) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, payload: dict, status: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body_json(self):
        """The body as JSON (None when there is none); ValueError when it is
        not JSON."""
        raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        return json.loads(raw) if raw else None

    def do_GET(self) -> None:  # noqa: N802
        if urllib.parse.urlsplit(self.path).path == "/health":
            self._json({"message": "Service is up."})
        else:
            self._json({"message": "Not Found"}, 404)

    def do_POST(self) -> None:  # noqa: N802
        route = urllib.parse.urlsplit(self.path).path
        handler = {"/storeStreamingText": self._store, "/flush": self._flush, "/generate": self._generate}.get(route)
        try:
            body = self._body_json()
        except ValueError:
            self._json({"message": "request body must be JSON"}, 400)
            return
        if handler is None:
            self._json({"message": "Not Found"}, 404)
            return
        handler(body if isinstance(body, dict) else {})

    def _store(self, body: dict) -> None:
        """``{"text": ..., "source": ...}``: a transcript fragment."""
        text = schema.sanitize(str(body.get("text", "")))
        source = schema.sanitize(str(body.get("source", "stream")))
        if not text.strip():
            self._json({"message": "empty text"}, 400)
            return
        flushed = self.server.accumulator.update(text, source)
        self._json({"message": "stored", "chunks_flushed": flushed})

    def _flush(self, body: dict) -> None:
        """End of stream: force a source's pending partial chunk out."""
        flushed = self.server.accumulator.flush(str(body.get("source", "stream")))
        self._json({"message": "flushed", "chunks_flushed": flushed})

    def _generate(self, body: dict) -> None:
        """Intent-routed answer, streamed as the chain server's SSE chunks."""
        try:
            prompt = schema.Prompt.parse(body)
        except ValueError as exc:  # schema.ValidationError
            self._json({"detail": str(exc)}, 422)
            return
        question = prompt.messages[-1].content if prompt.messages else ""
        resp_id = str(uuid.uuid4())
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            for piece in self.server.chains.answer(question, temperature=prompt.temperature, top_p=prompt.top_p,
                                                   max_tokens=prompt.max_tokens):
                self.wfile.write(_sse(_content_chunk(resp_id, piece)))
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            logger.info("client disconnected from /generate")
            return
        except Exception:
            logger.exception("streaming generate failed")
        self.wfile.write(_sse(_done_chunk(resp_id)))
        self.wfile.flush()


class StreamingServer(ThreadingHTTPServer):
    """The streaming chain server over one :class:`StreamingChains` and its
    :class:`TextAccumulator` (whose sink is ``chains.store_chunk``)."""

    daemon_threads = True
    request_queue_size = 128

    def __init__(self, address, chains: StreamingChains) -> None:
        super().__init__(address, _Handler)
        self.chains = chains
        self.accumulator = TextAccumulator(chains.store_chunk)


def create_streaming_app(chains: Optional[StreamingChains] = None, host: str = "127.0.0.1", port: int = 0,
                         device=None) -> StreamingServer:
    """Bind the streaming server (``serve_forever`` serves; port 0 picks a
    free port).  Without ``chains``, the configured chat LLM, embedder and
    store from ``chains.factory`` on ``device`` (the card by default) over
    an in-memory timestamp database."""
    if chains is None:
        from generativeaiexamples_tpu_torch.chains.factory import get_chat_llm, get_embedder, get_store

        chains = StreamingChains(get_chat_llm(device), get_embedder(device), get_store(device), TimestampDatabase())
    return StreamingServer((host, port), chains)


def main(argv: Optional[list] = None) -> None:
    """``python -m generativeaiexamples_tpu_torch.streaming.server``."""
    import argparse

    from generativeaiexamples_tpu_torch.core.logging import configure_logging

    parser = argparse.ArgumentParser(description="streaming RAG chain server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8082)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="count", default=None)
    args = parser.parse_args(argv)
    configure_logging(args.verbose)
    server = create_streaming_app(host=args.host, port=args.port, device=args.device)
    logger.info("streaming chain server on %s:%d", args.host, server.server_address[1])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
