"""HTTP over ``http.client`` (the layer ``urllib.request`` is built on) for
the port's clients of external services: one JSON POST for the engines'
clients (``engine/embedder_client.py``, ``chains/llm.py::OpenAIChatLLM``)
and one request of any method for the Elasticsearch store
(``retrieval/elastic_compat.py``).

The reference's clients run on httpx and requests, which the card machine
does not have.  ``http.client`` keeps httpx's split of the two timeouts: a dead host
fails within ``connect_timeout``, and each read of a live one within
``read_timeout`` (``urllib.request`` applies one timeout to both).
"""

from __future__ import annotations

import contextlib
import http.client
import json
import urllib.parse
from typing import Iterator, Mapping, Optional


class HTTPStatusError(OSError):
    """The server answered with a 4xx or 5xx status."""

    def __init__(self, status: int, body: bytes) -> None:
        super().__init__(f"HTTP {status}: {body[:200]!r}")
        self.status = status


@contextlib.contextmanager
def post_json(
    url: str, payload, headers: Mapping[str, str], *, connect_timeout: float, read_timeout: float
) -> Iterator[http.client.HTTPResponse]:
    """POST ``payload`` as JSON and yield the response (its status < 400;
    otherwise :class:`HTTPStatusError`).  The connection closes on exit."""
    parts = urllib.parse.urlsplit(url)
    conn_cls = http.client.HTTPSConnection if parts.scheme == "https" else http.client.HTTPConnection
    conn = conn_cls(parts.hostname, parts.port, timeout=connect_timeout)
    try:
        conn.connect()
        conn.sock.settimeout(read_timeout)
        path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        conn.request("POST", path, json.dumps(payload).encode(), {"Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        if resp.status >= 400:
            raise HTTPStatusError(resp.status, resp.read(4096))
        yield resp
    finally:
        conn.close()


def request(
    method: str, url: str, body: Optional[bytes] = None, headers: Optional[Mapping[str, str]] = None, *,
    timeout: float,
) -> tuple[int, bytes]:
    """One request of any method; returns ``(status, body)`` whatever the
    status (the caller decides what is an error).  ``timeout`` bounds the
    connect and each read."""
    parts = urllib.parse.urlsplit(url)
    conn_cls = http.client.HTTPSConnection if parts.scheme == "https" else http.client.HTTPConnection
    conn = conn_cls(parts.hostname, parts.port, timeout=timeout)
    try:
        path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        conn.request(method, path, body, dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()
