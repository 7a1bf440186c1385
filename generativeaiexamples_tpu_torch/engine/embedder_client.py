"""HTTP client for an external /v1/embeddings service (port of the JAX
package's ``engine/embedder_client.py``; the factory's ``openai`` embedder
engine).

Point it at any OpenAI-compatible embeddings endpoint, including the
port's own engine server.  Connect and read timeouts are split (a dead
host fails in ``connect_timeout`` seconds, not a whole read budget);
every request runs through a :class:`RetryPolicy` (jittered backoff,
retry budget, 4xx never retried); the request deadline in scope caps
both timeouts.  Built on ``core/httpclient.py`` (the reference's httpx is
not on the card machine).
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

from generativeaiexamples_tpu_torch.core.httpclient import HTTPStatusError, post_json
from generativeaiexamples_tpu_torch.core.tracing import inject_trace_headers
from generativeaiexamples_tpu_torch.resilience.deadline import current_deadline
from generativeaiexamples_tpu_torch.resilience.faults import inject
from generativeaiexamples_tpu_torch.resilience.retry import RetryPolicy


def _retryable_http(exc: BaseException) -> bool:
    """Transport errors and 5xx are transient; 4xx is the caller's bug."""
    if isinstance(exc, HTTPStatusError):
        return exc.status >= 500
    return isinstance(exc, Exception)


class HTTPEmbedder:
    def __init__(
        self,
        server_url: str,
        model: str,
        dimensions: int,
        api_key: str = "none",
        timeout: float = 60.0,
        connect_timeout: float = 5.0,
        retry: Optional[RetryPolicy] = None,
    ) -> None:
        base = server_url.rstrip("/")
        if not base.startswith("http"):
            base = f"http://{base}"
        if not base.endswith("/v1"):
            base = f"{base}/v1"
        self.base_url = base
        self.model = model
        self.dimensions = dimensions
        self.api_key = api_key
        self.read_timeout = float(timeout)
        self.connect_timeout = float(connect_timeout)
        self.retry = retry if retry is not None else RetryPolicy(name="http-embedder", retryable=_retryable_http)

    def _post_once(self, texts: Sequence[str], input_type: str) -> list[list[float]]:
        inject("embedder")
        connect, read = self.connect_timeout, self.read_timeout
        deadline = current_deadline()
        if deadline is not None and not deadline.is_unlimited:
            connect, read = deadline.cap_timeout(connect), deadline.cap_timeout(read)
        # W3C trace propagation: the engine-side trace joins this request's id.
        headers = inject_trace_headers({"Authorization": f"Bearer {self.api_key}"})
        payload = {"model": self.model, "input": list(texts), "input_type": input_type}
        with post_json(
            f"{self.base_url}/embeddings", payload, headers, connect_timeout=connect, read_timeout=read
        ) as resp:
            data = json.loads(resp.read())["data"]
        data.sort(key=lambda d: d.get("index", 0))
        return [d["embedding"] for d in data]

    def _embed(self, texts: Sequence[str], input_type: str) -> list[list[float]]:
        return self.retry.call(lambda: self._post_once(texts, input_type), deadline=current_deadline())

    def embed_documents(self, texts: Sequence[str]) -> list[list[float]]:
        if not texts:
            return []
        return self._embed(texts, "passage")

    def embed_query(self, text: str) -> list[float]:
        return self._embed([text], "query")[0]

    def embed_queries(self, texts: Sequence[str]) -> list[list[float]]:
        if not texts:
            return []
        return self._embed(texts, "query")
