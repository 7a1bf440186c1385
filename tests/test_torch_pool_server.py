"""The port's engine front over a replica pool and over a bare scheduler,
on the CPU (tiny Llama): the 429 path with ``Retry-After`` on both
completion routes, streamed or not; ``/admin/{replicas,drain,scale}``
(501 over a bare scheduler); ``/health`` degraded on a dead replica; the
retryable 503 and the streamed ``finish_reason: "error"`` when a replica
dies mid-generation; the telemetry shell (``/debug/requests`` under the
caller's ``X-Request-Id`` or ``traceparent``, ``/debug/timeseries``'s
engine series); the profiler gate; and the ``# TYPE`` families of
``/metrics`` against the JAX engine's (bare and pooled) and the chain
server's against the JAX chain server's.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from generativeaiexamples_tpu_torch.engine.decode import w8a8_params
from generativeaiexamples_tpu_torch.engine.replica import DETACHED, DRAINING, UNHEALTHY, EnginePool
from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
from generativeaiexamples_tpu_torch.engine.server import create_engine_app, metrics_text, rag_metrics_lines
from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.obs import reset_obs

CFG = llama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
KW = dict(max_batch=2, max_len=128, decode_chunk_size=2, prefill_chunk_tokens=8)
WAIT_S = 60
# Families the port's engine exports beyond the reference's: its TTFT
# median, its tick EWMA, and the micro-batcher's rag_* at zero without one.
PORT_EXTRAS = {"engine_ttft_p50_ms", "engine_tick_ms_ewma"} | {
    line.split()[2] for line in rag_metrics_lines(None) if line.startswith("# TYPE")}


@pytest.fixture(scope="module")
def params():
    return w8a8_params(CFG, None, device="cpu", generator=torch.Generator().manual_seed(3))


def _sched(params, **kw):
    return Scheduler(CFG, params, device="cpu", **{**KW, **kw})


class _Front:
    """An engine front on a free port over ``engine`` (started here)."""

    def __init__(self, engine, start=True, **kw):
        self.engine = engine
        self.server = create_engine_app(engine, ByteTokenizer(), model_name="llama-tiny", **kw)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        if start:
            engine.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def request(self, method, path, body=None, headers=None):
        data = json.dumps(body).encode() if body is not None else (b"" if method == "POST" else None)
        req = urllib.request.Request(self.base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
                return resp.status, resp.headers, resp.read().decode()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.headers, exc.read().decode()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.engine.stop()
        self.thread.join(timeout=WAIT_S)


def _completion(stream, chat=False):
    if chat:
        return "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 2,
                                        "stream": stream}
    return "/v1/completions", {"prompt": "x", "max_tokens": 2, "stream": stream}


def _types(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


def test_full_pool_answers_429_with_retry_after_before_any_sse_byte(params):
    front = _Front(EnginePool([_sched(params, max_queue=0) for _ in range(2)], health_interval=None), start=False)
    try:
        for chat in (False, True):
            for stream in (False, True):
                path, body = _completion(stream, chat)
                status, headers, raw = front.request("POST", path, body)
                assert status == 429 and headers["Content-Type"] == "application/json"
                assert json.loads(raw)["error"]["type"] == "overloaded_error"
                assert 1 <= int(headers["Retry-After"]) <= 30
        snap = front.engine.stats.snapshot()
        assert snap["rejected_total"] == 4
        # Every replica refused each one; the pool counts the client's 429s.
        assert [r["rejected_total"] for r in snap["replicas"]] == [4, 4]
        _, _, metrics = front.request("GET", "/metrics")
        assert "engine_rejected_total 4" in metrics.splitlines()
        assert 'engine_replica_rejected_total{replica="1"} 4' in metrics.splitlines()
    finally:
        front.close()


def test_bare_scheduler_429_and_admin_routes_501(params):
    front = _Front(_sched(params, max_queue=0), start=False)
    try:
        status, headers, _ = front.request("POST", *_completion(False))
        assert status == 429 and headers["Retry-After"] == "1"
        for method, path in (("GET", "/admin/replicas"), ("POST", "/admin/drain?replica=0"),
                             ("POST", "/admin/scale?replicas=2")):
            assert front.request(method, path)[0] == 501
    finally:
        front.close()


def test_admin_replicas_drain_and_scale(params):
    pool = EnginePool([_sched(params) for _ in range(2)], policy="least_loaded", health_interval=None,
                      scheduler_factory=lambda: _sched(params))
    front = _Front(pool)
    try:
        status, _, raw = front.request("GET", "/admin/replicas")
        assert status == 200 and [r["replica"] for r in json.loads(raw)["replicas"]] == [0, 1]
        assert front.request("POST", "/admin/drain")[0] == 422
        assert front.request("POST", "/admin/drain?replica=9")[0] == 404
        status, _, raw = front.request("POST", "/admin/drain?replica=0")
        assert status == 200 and json.loads(raw)["state"] in (DRAINING, DETACHED)
        assert pool.healthy()  # draining never degrades /health
        for bad in ("/admin/scale", "/admin/scale?replicas=zero", "/admin/scale?replicas=0"):
            assert front.request("POST", bad)[0] == 422
        status, _, raw = front.request("POST", "/admin/scale?replicas=2")
        assert status == 200 and json.loads(raw) == {"size": 2, "added": [2], "drained": []}
        status, _, raw = front.request("POST", "/v1/completions", {"prompt": "hello", "max_tokens": 3,
                                                                   "temperature": 0})
        assert status == 200 and json.loads(raw)["usage"]["completion_tokens"] == 3
        assert pool.snapshot()["replicas"][0]["requests_total"] == 0
    finally:
        front.close()


def _kill(replica):
    replica.scheduler.request_stop()
    replica.scheduler._thread.join(timeout=WAIT_S)
    assert not replica.thread_alive()


def test_health_degrades_when_a_replica_dies(params):
    pool = EnginePool([_sched(params) for _ in range(2)], health_interval=None)
    front = _Front(pool)
    try:
        status, _, raw = front.request("GET", "/health")
        assert status == 200 and json.loads(raw)["status"] == "ok"
        _kill(pool.replicas[0])
        pool.check_replicas()
        status, _, raw = front.request("GET", "/health")
        body = json.loads(raw)
        assert status == 503 and body["status"] == "degraded"
        assert {r["replica"]: r["state"] for r in body["replicas"]}[0] == UNHEALTHY
    finally:
        front.close()


@pytest.mark.parametrize("stream", [False, True])
def test_mid_flight_death_is_retryable(params, stream):
    """A generation whose replica dies after its first token: a non-streamed
    one answers 503 (nothing was delivered), a streamed one ends with
    ``finish_reason: "error"``."""
    pool = EnginePool([_sched(params) for _ in range(2)], health_interval=None)
    front = _Front(pool)
    out = {}
    try:
        worker = threading.Thread(target=lambda: out.update(r=front.request(
            "POST", "/v1/completions", {"prompt": "a long one", "max_tokens": 100, "temperature": 0,
                                        "stream": stream})))
        worker.start()
        deadline = time.monotonic() + WAIT_S
        placement = None
        while time.monotonic() < deadline and placement is None:
            placement = next((p for p in list(pool._placements.values()) if p.tokens > 0), None)
            time.sleep(0.005)
        assert placement is not None
        _kill(pool.replicas[placement.replica])
        pool.check_replicas()
        worker.join(timeout=WAIT_S)
        status, _, raw = out["r"]
    finally:
        front.close()
    if stream:
        events = [json.loads(line[6:]) for line in raw.splitlines() if line.startswith("data: {")]
        assert status == 200 and events[-1]["choices"][0]["finish_reason"] == "error"
        assert raw.rstrip().endswith("data: [DONE]")
    else:
        body = json.loads(raw)
        assert status == 503 and body["error"]["type"] == "engine_error" and "retry" in body["error"]["message"]


def test_debug_requests_join_the_callers_request_id(params):
    reset_obs()
    front = _Front(_sched(params))
    try:
        status, headers, _ = front.request("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 2},
                                           {"X-Request-Id": "req-from-chain-7"})
        assert status == 200 and headers["X-Request-Id"] == "req-from-chain-7"
        trace_id, span = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
        status, headers, _ = front.request("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 2, "stream": True},
                                           {"traceparent": f"00-{trace_id}-{span}-01"})
        assert status == 200 and headers["X-Request-Id"] == trace_id
        status, _, raw = front.request("GET", "/debug/requests?limit=10")
        records = {r["request_id"]: r for r in json.loads(raw)["requests"]}
        assert records["req-from-chain-7"]["route"] == "/v1/completions"
        assert records["req-from-chain-7"]["status"] == 200 and records["req-from-chain-7"]["attrs"]["propagated"]
        assert records[trace_id]["attrs"]["parent_span_id"] == span
        assert front.request("GET", "/debug/requests?limit=x")[0] == 422
        time.sleep(0.3)  # one telemetry feed interval of the tick loop
        status, _, raw = front.request("GET", "/debug/timeseries?series=engine.*&window=5m")
        series = json.loads(raw)["series"]
        assert status == 200 and {"engine.tick_ms", "engine.queued", "engine.requests./v1/completions"} <= set(series)
        assert front.request("GET", "/debug/timeseries?window=bogus")[0] == 422
    finally:
        front.close()
        reset_obs()


def test_profiler_routes_follow_the_gate(params, monkeypatch, tmp_path):
    closed = _Front(_sched(params), start=False)
    try:
        assert closed.request("POST", "/debug/profiler/start")[0] == 404
    finally:
        closed.close()
    monkeypatch.setenv("GAIE_ENABLE_PROFILER", "1")
    monkeypatch.setenv("GAIE_PROFILER_DIR", str(tmp_path / "prof"))
    front = _Front(_sched(params), start=False)
    try:
        assert front.request("POST", "/debug/profiler/stop")[0] == 409
        assert front.request("POST", "/debug/profiler/start")[0] == 200
        assert front.request("POST", "/debug/profiler/start")[0] == 409
        status, _, raw = front.request("POST", "/debug/profiler/stop")
        assert status == 200 and json.loads(raw)["status"] == "stopped"
    finally:
        front.close()


def _jax_metrics(engine) -> str:
    from generativeaiexamples_tpu.engine import server as jserver
    from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer as JByteTokenizer

    class _Req:
        app = jserver.create_engine_app(engine, JByteTokenizer(), model_name="llama-tiny")

    return asyncio.run(jserver.handle_metrics(_Req())).text


def test_metrics_families_equal_the_reference_engine(params):
    """The ``# TYPE`` families of the engine's ``/metrics``, bare and over
    a 2-replica pool, against the JAX engine's over the same shapes; the
    port's documented extras aside, equal."""
    from generativeaiexamples_tpu.engine import replica as jreplica
    from generativeaiexamples_tpu.engine import scheduler as jsched
    from generativeaiexamples_tpu.models import llama as jllama

    jcfg = jllama.llama_tiny(dtype="float32", max_seq_len=128)
    jscheds = [jsched.Scheduler(jcfg, max_batch=2, max_len=128) for _ in range(2)]
    jbare = _types(_jax_metrics(jscheds[0]))
    jpooled = _types(_jax_metrics(jreplica.EnginePool(jscheds, health_interval=None)))
    bare = _types(metrics_text(_sched(params)))
    pooled = _types(metrics_text(EnginePool([_sched(params) for _ in range(2)], health_interval=None)))
    assert bare - PORT_EXTRAS == jbare and pooled - PORT_EXTRAS == jpooled
    assert PORT_EXTRAS <= bare and jpooled - jbare == pooled - bare
    assert {"engine_replica_queued", "engine_pool_size", "engine_replica_score", "rag_hedge_requests_total"} <= pooled


def test_chain_server_metrics_gain_the_pool_and_gray_families(monkeypatch):
    """The chain server exports the pool and gray-failure families at zero,
    and its ``# TYPE`` families equal the JAX chain server's."""
    from generativeaiexamples_tpu.server import app as japp
    from generativeaiexamples_tpu_torch.engine.autoscale import pool_metrics_lines
    from generativeaiexamples_tpu_torch.engine.health import gray_metrics_lines
    from generativeaiexamples_tpu_torch.server import app as tapp

    text = tapp.metrics_text()
    lines = text.splitlines()
    for line in pool_metrics_lines(None) + gray_metrics_lines(None):
        assert line in lines
    assert "engine_pool_size 0" in lines and "engine_replica_ejections_total 0" in lines
    assert _types(text) == _types(asyncio.run(japp.handle_metrics(None)).text)
