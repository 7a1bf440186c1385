"""The port's chain server (``http.server``) against the JAX package's
(aiohttp) on the CPU.

Both run the same pipeline from the same ``APP_*`` overlay: the ``echo``
LLM, the ``hash`` embedder at dimension 64, the exact ``tpu`` store (the
JAX ``TPUVectorStore`` on the CPU, the port's ``GPUVectorStore(device=
"cpu")``), the result cache and the micro-batcher on, and the byte
tokenizer pinned on both sides.  Every case sends the same requests to
both servers, in the same order, and holds the port to the reference:
status codes, ``/search`` chunks (same order, scores within
``SCORE_TOL``), the SSE bytes of ``/generate`` with the uuid ``id``
masked (``[DONE]`` chunk included), the document listing, ``/health``,
and the ``rag_*`` and admission counters of ``/metrics``.
"""

import asyncio
import json
import os
import re
import threading
import urllib.error
import urllib.request

import pytest
from aiohttp.test_utils import TestClient, TestServer

from generativeaiexamples_tpu.chains import factory as jfactory
from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.engine import tokenizer as jtokenizer
from generativeaiexamples_tpu.resilience import breaker as jbreaker
from generativeaiexamples_tpu.server import app as japp
from generativeaiexamples_tpu_torch.chains import factory as tfactory
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.resilience import breaker as tbreaker
from generativeaiexamples_tpu_torch.server import app as tapp

# Scores of the same hash vectors in the two stores: f32 sums of 64
# products in different orders.
SCORE_TOL = 1e-6
UUID_RE = re.compile(rb'"id":"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"')
BOUNDARY = "gaieBoundary7MA4YWxk"

DOCS = {
    "facts.txt": "TPU v5e chips have 16 GiB of HBM.\n\nThe H100 has 80 GB of HBM3 at 3.35 TB/s.\n\n"
                 "Bananas are yellow; café au lait is brown — ünïcödé text survives.",
    "notes.md": "# Notes\n\n## Retrieval\nThe exact store scans every row.\n\n## Caching\nExact and semantic tiers.",
    "table.csv": "name,colour\nbanana,yellow\ncherry,red\n",
}
QUERIES = ["how much HBM does the H100 have", "what colour are bananas", "café", "semantic cache tiers"]


def _multipart(name: str, content: bytes) -> tuple[bytes, dict]:
    body = (
        f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="file"; filename="{name}"\r\n'
        f"Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + content + f"\r\n--{BOUNDARY}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={BOUNDARY}"}


class _Jax:
    """The reference app behind aiohttp's test client."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(japp.create_app()), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def request(self, method, path, body=None, headers=None):
        async def go():
            data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
            hdrs = {"Content-Type": "application/json", **(headers or {})}
            resp = await self.client.request(method, path, data=data, headers=hdrs)
            return resp.status, resp.headers, await resp.read()

        return self.loop.run_until_complete(go())

    def close(self) -> None:
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


class _Torch:
    """The port's server on a thread, driven over real HTTP."""

    def __init__(self) -> None:
        self.server = tapp.create_app(device="cpu")
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def request(self, method, path, body=None, headers=None):
        data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
        req = urllib.request.Request(self.base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.headers, resp.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.headers, exc.read()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _reset_both() -> None:
    for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
        configuration.reset_config_cache()
        factory.reset_factories()


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    for key, value in (("APP_LLM_MODELENGINE", "echo"), ("APP_EMBEDDINGS_MODELENGINE", "hash"),
                       ("APP_EMBEDDINGS_DIMENSIONS", "64"), ("APP_VECTORSTORE_NAME", "tpu"),
                       ("APP_RETRIEVER_SCORETHRESHOLD", "-1.0"), ("GAIE_UPLOAD_DIR", str(tmp_path / "up")),
                       # No latency objectives: the JAX side's first search
                       # compiles, and /health must not turn on timing.
                       ("APP_SLO_LATENCYP95MS", "")):
        monkeypatch.setenv(key, value)
    # The splitter's tokenizer: the port has only the byte tokenizer.
    monkeypatch.setattr(jtokenizer, "get_tokenizer", lambda *a, **k: jtokenizer.ByteTokenizer())
    yield monkeypatch
    _reset_both()


@pytest.fixture
def servers(env):
    _reset_both()
    jax_server, port_server = _Jax(), _Torch()
    yield jax_server, port_server
    port_server.close()
    jax_server.close()


def _both(servers, method, path, body=None, headers=None):
    return [s.request(method, path, body, headers) for s in servers]


def _upload_all(servers):
    for name, text in DOCS.items():
        body, headers = _multipart(name, text.encode())
        (js, _, jb), (ts, _, tb) = _both(servers, "POST", "/documents", body, headers)
        assert js == ts == 200, (jb, tb)
        assert json.loads(jb) == json.loads(tb)


def _same_search(servers, query, top_k=4):
    (js, jh, jb), (ts, th, tb) = _both(servers, "POST", "/search", {"query": query, "top_k": top_k})
    assert js == ts == 200, (jb, tb)
    j, t = json.loads(jb), json.loads(tb)
    assert [(c["content"], c["filename"]) for c in t["chunks"]] == [(c["content"], c["filename"]) for c in j["chunks"]]
    for a, b in zip(j["chunks"], t["chunks"]):
        assert abs(a["score"] - b["score"]) <= SCORE_TOL
    assert {k: t[k] for k in ("degraded", "cached", "cache_tier")} == {k: j[k] for k in ("degraded", "cached", "cache_tier")}
    assert (jh["X-Cache"], jh.get("X-Cache-Tier")) == (th["X-Cache"], th.get("X-Cache-Tier"))
    return j


def _same_sse(servers, body, headers=None):
    (js, jh, jb), (ts, th, tb) = _both(servers, "POST", "/generate", body, headers)
    assert js == ts == 200
    assert th["Content-Type"].startswith("text/event-stream")
    assert UUID_RE.sub(b'"id":"ID"', tb) == UUID_RE.sub(b'"id":"ID"', jb)
    assert (jh.get("X-Cache"), jh.get("X-Cache-Tier")) == (th.get("X-Cache"), th.get("X-Cache-Tier"))
    return [json.loads(line[6:]) for line in tb.decode().splitlines() if line.startswith("data: ")]


def _families(text: bytes, prefixes) -> dict:
    """The counters of ``/metrics`` under ``prefixes`` (timings left out)."""
    return {line.split(" ")[0]: line.split(" ")[1] for line in text.decode().splitlines()
            if line.startswith(prefixes) and "_ms_sum" not in line}


def test_documents_search_generate_and_metrics_match_reference(servers):
    _upload_all(servers)
    (js, _, jb), (ts, _, tb) = _both(servers, "GET", "/documents")
    assert js == ts == 200 and json.loads(tb) == json.loads(jb)
    assert sorted(json.loads(tb)["documents"]) == sorted(DOCS)
    for q in QUERIES:
        assert _same_search(servers, q)["chunks"]
    _same_search(servers, QUERIES[0], top_k=2)  # an exact-tier hit at another k
    for kb in (True, False):
        for content in ("what colour are bananas", "ünïcödé <b>café</b> ☕ — 日本語?"):
            chunks = _same_sse(servers, {"messages": [{"role": "user", "content": content}],
                                         "use_knowledge_base": kb, "max_tokens": 64})
            assert chunks[-1]["choices"][0]["finish_reason"] == "[DONE]" and len(chunks) > 2
    # History, a system turn, and a stop sequence cutting the echo.
    _same_sse(servers, {"messages": [{"role": "system", "content": "be brief"},
                                     {"role": "user", "content": "first"},
                                     {"role": "assistant", "content": "ok"},
                                     {"role": "user", "content": "second question here"}],
                        "use_knowledge_base": True, "stop": ["question"], "temperature": 0})
    # A repeated query: its retrieval is an exact-tier hit on both sides.
    assert _same_sse(servers, {"messages": [{"role": "user", "content": "what colour are bananas"}],
                               "use_knowledge_base": True})[-1]["cache_tier"] == "exact"

    (js, _, jb), (ts, _, tb) = _both(servers, "DELETE", "/documents?filename=facts.txt")
    assert js == ts == 200 and json.loads(tb) == json.loads(jb)
    (js, _, jb), (ts, _, tb) = _both(servers, "GET", "/documents")
    assert json.loads(tb) == json.loads(jb) and "facts.txt" not in json.loads(tb)["documents"]
    hits = _same_search(servers, "HBM3 bandwidth of the H100")["chunks"]
    assert hits and all(c["filename"] != "facts.txt" for c in hits)
    # A missing file: the reference's pipeline reports success (0 chunks
    # removed), and so does the port.
    (js, _, _), (ts, _, _) = _both(servers, "DELETE", "/documents?filename=ghost.txt")
    assert js == ts
    (js, _, jb), (ts, _, tb) = _both(servers, "DELETE", "/documents")
    assert js == ts == 422

    (js, _, jb), (ts, _, tb) = _both(servers, "GET", "/health")
    assert js == ts == 200 and json.loads(tb) == json.loads(jb)
    (js, _, jb), (ts, _, tb) = _both(servers, "GET", "/metrics")
    assert js == ts == 200
    prefixes = ("rag_requests_total", "rag_batches_total", "rag_embed_batch_size", "rag_queue_wait_ms_count",
                "rag_errors_total", "rag_store_rows", "rag_admission_", "rag_retries_total",
                "rag_degraded_total", "rag_breaker_", "rag_cache_")
    got, want = _families(tb, prefixes), _families(jb, prefixes)
    assert got == want
    assert got["rag_store_rows"] == want["rag_store_rows"] != "0"
    assert got['rag_admission_admitted_total{class="interactive"}'] != "0"
    assert got['rag_admission_admitted_total{class="ingest"}'] == str(len(DOCS))


@pytest.mark.parametrize("path,body", [
    ("/generate", {"messages": []}),
    ("/generate", {"messages": [{"role": "hacker", "content": "x"}], "use_knowledge_base": False}),
    ("/generate", {"messages": [{"role": "user", "content": "x"}], "use_knowledge_base": False, "max_tokens": 99999}),
    ("/generate", {"messages": [{"role": "user", "content": "x"}], "use_knowledge_base": 2}),
    ("/generate", {"messages": [{"role": "user", "content": 5}], "use_knowledge_base": False}),
    ("/generate", {"messages": "hello", "use_knowledge_base": False}),
    ("/generate", {"messages": [], "use_knowledge_base": False, "temperature": 1.5}),
    ("/generate", {"messages": [], "use_knowledge_base": False, "top_p": 0.05}),
    ("/generate", {"messages": [], "use_knowledge_base": False, "max_tokens": 5.5}),
    ("/generate", {"messages": [], "use_knowledge_base": False, "stop": "x"}),
    ("/generate", [1, 2]),
    ("/generate", b"{not json"),
    ("/search", {"query": "x", "top_k": 26}),
    ("/search", {"query": 5}),
    ("/search", b""),
])
def test_bad_bodies_are_422_on_both(servers, path, body):
    (js, _, jb), (ts, _, tb) = _both(servers, "POST", path, body)
    assert js == ts == 422, (jb, tb)
    assert json.loads(tb)["detail"]


def test_lax_coercions_and_unknown_routes_match_reference(servers):
    _upload_all(servers)
    _same_sse(servers, {"messages": [{"role": "USER", "content": "<i>bananas</i>"}], "use_knowledge_base": "yes",
                        "temperature": "0.5", "max_tokens": "3", "top_p": 1, "extra": "ignored"})
    _same_search(servers, "bananas", top_k="2")
    for method, path in (("GET", "/nowhere"), ("POST", "/health"), ("GET", "/generate")):
        (js, _, _), (ts, _, _) = _both(servers, method, path)
        assert js == ts and js in (404, 405)


def test_deadline_is_504_on_both(env, servers):
    _upload_all(servers)
    env.setenv("GAIE_FAULTS", "embedder:latency=50")
    for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
        configuration.reset_config_cache()
    from generativeaiexamples_tpu.resilience import faults as jfaults
    from generativeaiexamples_tpu_torch.resilience import faults as tfaults

    jfaults.reset_faults()
    tfaults.reset_faults()
    body = {"messages": [{"role": "user", "content": "a fresh question"}], "use_knowledge_base": True}
    (js, _, jb), (ts, _, tb) = _both(servers, "POST", "/generate", body, {"X-Request-Deadline-Ms": "5"})
    assert js == ts == 504 and json.loads(tb) == json.loads(jb)
    # 0 means no deadline: the slow embedder is waited for.
    body["messages"][0]["content"] = "another fresh question"
    _same_sse(servers, body, {"X-Request-Deadline-Ms": "0"})


def test_open_llm_breaker_is_503_with_retry_after_on_both(servers):
    _upload_all(servers)
    for get_breaker in (jbreaker.get_breaker, tbreaker.get_breaker):
        breaker = get_breaker("llm")
        for _ in range(100):
            if breaker.state == "open":
                break
            breaker.record_failure()
        assert breaker.state == "open"
    body = {"messages": [{"role": "user", "content": "bananas"}], "use_knowledge_base": True}
    (js, jh, jb), (ts, th, tb) = _both(servers, "POST", "/generate", body)
    assert js == ts == 503
    # The breakers' remaining cool-down, rounded: the two requests run a
    # moment apart, so a rounding edge may fall between them.
    reset_s = tconfiguration.get_config().resilience.breaker_reset_s
    assert 1 <= int(th["Retry-After"]) <= reset_s and abs(int(th["Retry-After"]) - int(jh["Retry-After"])) <= 1
    assert json.loads(tb)["detail"].startswith("Temporarily unavailable")


def test_store_fault_without_fallback_answers_llm_only_on_both(env, servers):
    _upload_all(servers)
    env.setenv("GAIE_FAULTS", "store:error=1")
    from generativeaiexamples_tpu.resilience import faults as jfaults
    from generativeaiexamples_tpu_torch.resilience import faults as tfaults

    for configuration in (jconfiguration, tconfiguration):
        configuration.reset_config_cache()
    jfaults.reset_faults()
    tfaults.reset_faults()
    # No host-side fallback: the ladder's last rung is the LLM alone.
    for store in (jfactory.get_store(), tfactory.get_store()):
        env.setattr(store, "search_fallback", None)
    chunks = _same_sse(servers, {"messages": [{"role": "user", "content": "a question nobody asked"}],
                                 "use_knowledge_base": True})
    assert chunks[-1]["degraded"] == ["retrieval"]
    (js, _, jb), (ts, _, tb) = _both(servers, "GET", "/metrics")
    prefixes = ("rag_degraded_total", "rag_breaker_", "rag_errors_total")
    assert _families(tb, prefixes) == _families(jb, prefixes)


def test_named_collection_is_501(servers):
    """A documented difference: the reference serves named collections from
    its retrieval fabric, which is not ported."""
    port = servers[1]
    for method, path, body in (("POST", "/search", {"query": "x", "collection": "tenant-a"}),
                               ("GET", "/documents?collection=tenant-a", None),
                               ("DELETE", "/documents?filename=a.txt&collection=tenant-a", None),
                               ("POST", "/generate", {"messages": [{"role": "user", "content": "x"}],
                                                      "use_knowledge_base": True, "collection": "tenant-a"})):
        status, _, raw = port.request(method, path, body)
        assert status == 501 and "item 8" in json.loads(raw)["detail"]
    status, _, _ = port.request("POST", "/search", {"query": "x", "collection": "default"})
    assert status == 200


def test_multipart_part_keeps_its_bytes():
    content = b"line one\r\n\r\n--not-a-boundary\r\n\x00\xff\xfe binary\nlast"
    body, headers = _multipart("data.bin", content)
    assert tapp._file_part(headers["Content-Type"], body) == ("data.bin", content)
    assert tapp._file_part("text/plain", b"no parts") is None
    other = body.replace(b'name="file"', b'name="other"')
    assert tapp._file_part(headers["Content-Type"], other) is None


def test_upload_is_unlinked_and_traced(servers, tmp_path):
    port = servers[1]
    body, headers = _multipart("facts.txt", DOCS["facts.txt"].encode())
    status, resp_headers, _ = port.request("POST", "/documents", body,
                                           {**headers, "X-Request-Id": "a" * 32, "X-Traffic-Class": "batch"})
    assert status == 200 and resp_headers["X-Request-Id"] == "a" * 32
    assert "total;dur=" in resp_headers["Server-Timing"]
    assert os.listdir(tmp_path / "up") == []
    _, _, raw = port.request("GET", "/metrics")
    assert _families(raw, ("rag_admission_admitted_total",))['rag_admission_admitted_total{class="batch"}'] == "1"
