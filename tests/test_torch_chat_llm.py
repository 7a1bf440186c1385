"""The port's chat-LLM connectors against the JAX package's on the CPU.

``GPUChatLLM`` streams from the port's ``Scheduler`` over a tiny W8A8
Llama (the JAX package's int8 weights carried over by
``engine/weights.py::params_from_numpy``); the reference is ``TPUChatLLM``
with an injected JAX ``LlamaGenerator`` over the same weights (append
buffer and exact sampling on, as the port always runs).  Greedy token
streams must be equal exactly.  The text differs only where the port
renders an id past the byte vocabulary as ``<|id|>`` (the reference
renders nothing; ``engine/tokenizer.py``).  Also held to the reference:
``_apply_stop`` on generated strings, ``guarded_stream``'s breaker
outcomes, ``OpenAIChatLLM`` and ``HTTPEmbedder`` against one scripted
HTTP server (payloads, retries before the first byte, 4xx not retried).
"""

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu.chains import llm as jllm
from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import embedder_client as jclient
from generativeaiexamples_tpu.engine.generator import LlamaGenerator
from generativeaiexamples_tpu.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.resilience import breaker as jbreaker
from generativeaiexamples_tpu.resilience import deadline as jdeadline
from generativeaiexamples_tpu.resilience import metrics as jmetrics
from generativeaiexamples_tpu_torch.chains import factory as tfactory
from generativeaiexamples_tpu_torch.chains import llm as tllm
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.engine import embedder_client as tclient
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.resilience import breaker as tbreaker
from generativeaiexamples_tpu_torch.resilience import deadline as tdeadline
from generativeaiexamples_tpu_torch.resilience import metrics as tmetrics

MAX_LEN = 256
JCFG = jllama.llama_tiny(dtype="float32", max_seq_len=MAX_LEN, kv_dtype="int8")
TCFG = tllama.llama_tiny(dtype="float32", max_seq_len=MAX_LEN, kv_dtype="int8")
MARKER = re.compile(r"<\|\d+\|>")

CONVERSATIONS = [
    [("system", "be brief"), ("user", "hello there, ünïcödé")],
    [("user", "first"), ("assistant", "ok"), ("user", "a second question?")],
]


@pytest.fixture(scope="module")
def jax_params():
    raw = jdecode.init_random_int8_params(JCFG, jax.random.PRNGKey(0))
    packed = jdecode.prepare_params(JCFG, raw, None, pack=True)
    return jdecode.prepare_params(JCFG, packed, None, matmul_kernel="pallas_w8a8")


class _Recorder:
    """Wraps a JAX generator, keeping the token ids it streams."""

    def __init__(self, generator) -> None:
        self.generator = generator
        self.tokens: list[int] = []

    def generate(self, prompts, params, eos_id=None, stream_cb=None):
        def cb(i, t):
            self.tokens.append(int(t))
            stream_cb(i, t)

        return self.generator.generate(prompts, params, eos_id=eos_id, stream_cb=cb)


def _port_llm(jax_params, **kw) -> tuple:
    tparams = params_from_numpy(jax.tree.map(np.asarray, jax_params), TCFG, "cpu")
    sched = tsched.Scheduler(TCFG, tparams, device="cpu", **{**dict(
        max_batch=4, max_len=MAX_LEN, decode_chunk_size=2, prefill_chunk_tokens=None), **kw})
    tokens: list[int] = []
    submit = sched.submit

    def recording_submit(req):
        on_token = req.on_token
        req.on_token = lambda t: (tokens.append(int(t)), on_token(t))
        submit(req)

    sched.submit = recording_submit
    return tllm.GPUChatLLM(scheduler=sched), tokens


def test_greedy_stream_equals_jax_generator(monkeypatch, jax_params):
    monkeypatch.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    monkeypatch.setenv("GAIE_EXACT_SAMPLING", "1")
    recorder = _Recorder(LlamaGenerator(JCFG, jax_params, max_batch=1, max_len=MAX_LEN,
                                        matmul_kernel="pallas_w8a8", decode_chunk_size=2))
    ref = jllm.TPUChatLLM(generator=recorder, tokenizer=ByteTokenizer())
    port, port_tokens = _port_llm(jax_params)
    try:
        for messages in CONVERSATIONS:
            recorder.tokens.clear()
            port_tokens.clear()
            want = "".join(ref.stream(messages, temperature=0.0, max_tokens=16))
            got = "".join(port.stream(messages, temperature=0.0, max_tokens=16))
            assert port_tokens == recorder.tokens and len(port_tokens) == 16
            assert MARKER.sub("", got) == want
            assert got.count("<|") == sum(t >= 259 for t in port_tokens)
    finally:
        port.close()
    assert not port.scheduler._thread


@settings(max_examples=200, deadline=None)
@given(
    st.lists(st.text(alphabet="abéxy ", max_size=6), max_size=8),
    st.lists(st.text(alphabet="abxy", min_size=1, max_size=3), max_size=3),
)
def test_apply_stop_matches_reference(chunks, stop):
    assert list(tllm._apply_stop(iter(chunks), stop)) == list(jllm._apply_stop(iter(chunks), stop))


def _reset_breakers():
    jbreaker.reset_breakers()
    tbreaker.reset_breakers()


def test_overlong_prompt_raises_generation_error(jax_params):
    """The scheduler would keep only the prompt's tail: the port refuses
    it, as the reference's generator does, and both breakers count it."""
    _reset_breakers()
    port, tokens = _port_llm(jax_params, max_len=128)
    try:
        messages = [("system", "x" * 200), ("user", "question")]
        with pytest.raises(tllm.GenerationError, match="longer than the engine admits"):
            list(tllm.guarded_stream(port, messages, temperature=0.0, max_tokens=4))
        assert tokens == [] and port.scheduler.stats.snapshot()["requests_total"] == 0
        gen = LlamaGenerator(JCFG, jax_params, max_batch=1, max_len=128, matmul_kernel="pallas_w8a8")
        ref = jllm.TPUChatLLM(generator=gen, tokenizer=ByteTokenizer())
        with pytest.raises(jllm.GenerationError):
            list(jllm.guarded_stream(ref, messages, temperature=0.0, max_tokens=4))
        for get_breaker in (jbreaker.get_breaker, tbreaker.get_breaker):
            assert list(get_breaker("llm")._window) == [True]
        # One token shorter than the limit is admitted whole.
        limit = port.scheduler.max_prompt_len
        fits = [("user", "y" * (limit - len(port.tokenizer.apply_chat_template([("user", "")]))))]
        assert len(port.tokenizer.apply_chat_template(fits)) == limit
        assert "".join(port.stream(fits, temperature=0.0, max_tokens=2))
    finally:
        port.close()
        _reset_breakers()


class _TickDeath(BaseException):
    """Escapes the tick loop's ``except Exception``: the thread ends."""


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_failures_raise_instead_of_ending_early(jax_params):
    port, _ = _port_llm(jax_params)
    port.POLL_S = 0.05
    sched = port.scheduler
    try:
        def failing_decode(*args):
            raise RuntimeError("injected decode failure")

        # A tick that fails fails its live requests ("error").
        sched._decode_dispatch = failing_decode
        with pytest.raises(tllm.GenerationError, match="failed in the engine"):
            list(port.stream([("user", "hi")], temperature=0.0, max_tokens=4))
        assert sched.healthy()

        def dying_decode(*args):
            raise _TickDeath()

        # A tick thread that dies leaves its requests without an end: the
        # stream notices the dead thread.
        sched._decode_dispatch = dying_decode
        with pytest.raises(tllm.GenerationError, match="not running"):
            list(port.stream([("user", "hi")], temperature=0.0, max_tokens=4))
        assert not sched.healthy()
    finally:
        port.close()


class _FakeLLM:
    def __init__(self, outcome):
        self.outcome = outcome

    def stream(self, messages, **kw):
        def gen():
            yield "a"
            if self.outcome is not None:
                raise self.outcome

        return gen()


def test_guarded_stream_breaker_outcomes_match_reference():
    _reset_breakers()
    pkgs = ((jllm, jbreaker, jdeadline), (tllm, tbreaker, tdeadline))
    for _, breaker, _ in pkgs:
        breaker.get_breaker("llm", window=4, min_calls=2, failure_threshold=0.5, reset_timeout_s=60.0)
    trail = {0: [], 1: []}
    steps = ["ok", "deadline", "generation", "value", "ok", "generation", "value", "ok"]
    for step in steps:
        for i, (llm, breaker, deadline) in enumerate(pkgs):
            outcome = {"ok": None, "deadline": deadline.DeadlineExceeded("late"),
                       "generation": llm.GenerationError("dead"), "value": ValueError("boom")}[step]
            try:
                out = list(llm.guarded_stream(_FakeLLM(outcome), [("user", "q")]))
                result = f"ok {out}"
            except Exception as exc:
                result = type(exc).__name__
            b = breaker.get_breaker("llm")
            trail[i].append((step, result, b.state, list(b._window), b.open_total))
    assert trail[1] == trail[0]
    assert trail[0][-1][1] == "CircuitOpenError"  # the breaker opened on the way
    _reset_breakers()


def test_factory_builds_the_chat_llm_from_config(monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith("APP_"):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_LLM_MODELNAME", "llama-tiny")
    tconfiguration.reset_config_cache()
    tfactory.reset_factories()
    try:
        assert tconfiguration.get_config().llm.model_engine == "tpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tfactory.get_chat_llm()
        llm = tfactory.get_chat_llm("cpu")
        assert isinstance(llm, tllm.GPUChatLLM) and tfactory.peek_chat_llm() is llm
        sched = llm.scheduler
        assert (sched.max_batch, sched.max_len, sched.decode_chunk_size, sched.prefill_chunk_tokens,
                sched.prefix_cache, sched.kv_layout, sched.device.type) == (
                    32, min(2048, tllama.llama_tiny().max_seq_len), 8, None, "shared", "contiguous", "cpu")
        assert "".join(llm.stream([("user", "hi")], temperature=0.0, max_tokens=3))
        tfactory.reset_factories()
        assert sched._thread is None and tfactory.peek_chat_llm() is None
        monkeypatch.setenv("APP_LLM_MODELENGINE", "echo")
        tconfiguration.reset_config_cache()
        assert isinstance(tfactory.get_chat_llm(), tllm.EchoChatLLM)
        tfactory.reset_factories()
        monkeypatch.setenv("APP_LLM_MODELENGINE", "openai")
        monkeypatch.setenv("APP_LLM_SERVERURL", "engine:9000")
        tconfiguration.reset_config_cache()
        assert tfactory.get_chat_llm().base_url == "http://engine:9000/v1"
        tfactory.reset_factories()
        monkeypatch.setenv("APP_LLM_MODELENGINE", "tpu")
        monkeypatch.setenv("GAIE_WEIGHTS_DIR", str(tmp_path))
        (tmp_path / "llama-tiny").mkdir()
        tconfiguration.reset_config_cache()
        with pytest.raises(NotImplementedError, match="item 5"):
            tfactory.get_chat_llm("cpu")
        # The ingest, collection and memory-store factories build on the
        # CPU when asked; shutdown_durability touches only what was built.
        assert tfactory.get_memory_store("cpu").device.type == "cpu"
        assert tfactory.get_collection_manager("cpu").list() == ["default"]
        assert tfactory.get_ingest_pipeline("cpu").journal is None
        tfactory.shutdown_durability()
    finally:
        tfactory.reset_factories()
        tconfiguration.reset_config_cache()


# -- HTTP clients against one scripted server --------------------------------


class _Script(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, replies):
        super().__init__(("127.0.0.1", 0), _ScriptHandler)
        self.replies = list(replies)
        self.requests: list[dict] = []

    def __enter__(self):
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
        self.server_close()


class _ScriptHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.server.requests.append({"path": self.path, "body": body, "auth": self.headers.get("Authorization")})
        status, ctype, payload = self.server.replies.pop(0)
        data = payload.encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def _sse(*pieces):
    events = [json.dumps({"choices": [{"delta": {"content": p}}]}) for p in pieces]
    return "".join(f"data: {e}\n\n" for e in events + ["[DONE]"])


def _run_chat(pkg, metrics, replies, **kw):
    metrics.reset_resilience()
    with _Script(replies) as srv:
        client = pkg.OpenAIChatLLM(f"http://127.0.0.1:{srv.server_address[1]}/v1", "m", api_key="k")
        try:
            out = list(client.stream([("system", "s"), ("user", "é?")], **kw))
        except pkg.GenerationError as exc:
            out = f"GenerationError {type(exc.__cause__).__name__ if exc.__cause__ else ''}"
        return out, srv.requests, metrics.resilience_snapshot()["retries_total"]


@pytest.mark.parametrize("replies,kw", [
    ([(200, "text/event-stream", _sse("Hel", "lo, ", "wörld"))], dict(stop=["x"], session_id="s1")),
    ([(503, "application/json", "{}"), (200, "text/event-stream", _sse("after", " retry"))], {}),
    ([(400, "application/json", "{}")], {}),
])
def test_openai_chat_llm_matches_reference(replies, kw):
    got, got_reqs, got_retries = _run_chat(tllm, tmetrics, replies, **kw)
    want, want_reqs, want_retries = _run_chat(jllm, jmetrics, replies, **kw)
    assert (got_retries, [r["body"] for r in got_reqs]) == (want_retries, [r["body"] for r in want_reqs])
    assert [r["auth"] for r in got_reqs] == ["Bearer k"] * len(got_reqs)
    if isinstance(want, list):
        assert got == want
    else:
        assert got.startswith("GenerationError") and want.startswith("GenerationError")
        assert len(got_reqs) == 1  # a 4xx is not retried


def _run_embed(mod, metrics, replies):
    metrics.reset_resilience()
    with _Script(replies) as srv:
        emb = mod.HTTPEmbedder(f"127.0.0.1:{srv.server_address[1]}", "arctic", 3)
        try:
            out = (emb.embed_documents(["a", "b"]), emb.embed_query("q"), emb.embed_queries([]))
        except Exception as exc:
            out = type(exc).__name__
        return out, srv.requests, metrics.resilience_snapshot()["retries_total"]


def test_factory_builds_the_http_embedder(monkeypatch):
    """The ``openai`` embedder engine (it raised before the HTTP client was
    ported) builds ``HTTPEmbedder`` as the reference's factory does."""
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "openai")
    monkeypatch.setenv("APP_EMBEDDINGS_SERVERURL", "embedder:8001")
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", "32")
    from generativeaiexamples_tpu.chains import factory as jfactory

    try:
        for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
            configuration.reset_config_cache()
            factory.reset_factories()
        port = tfactory.get_embedder("cpu")
        ref = jfactory.get_embedder()
        assert isinstance(port, tclient.HTTPEmbedder)
        assert (port.base_url, port.model, port.dimensions) == (ref.base_url, ref.model, ref.dimensions) == (
            "http://embedder:8001/v1", "Snowflake/snowflake-arctic-embed-l", 32)
    finally:
        for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
            factory.reset_factories()
            configuration.reset_config_cache()


def test_http_embedder_matches_reference():
    docs = json.dumps({"data": [{"index": 1, "embedding": [0.0, 1.0, 0.5]}, {"index": 0, "embedding": [1.0, 0.0, 0.25]}]})
    query = json.dumps({"data": [{"index": 0, "embedding": [0.5, 0.5, 0.5]}]})
    replies = [(500, "application/json", "{}"), (200, "application/json", docs), (200, "application/json", query)]
    got, got_reqs, got_retries = _run_embed(tclient, tmetrics, replies)
    want, want_reqs, want_retries = _run_embed(jclient, jmetrics, replies)
    assert got == want == ([[1.0, 0.0, 0.25], [0.0, 1.0, 0.5]], [0.5, 0.5, 0.5], [])
    assert [(r["path"], r["body"]) for r in got_reqs] == [(r["path"], r["body"]) for r in want_reqs]
    assert got_retries == want_retries == 1
    got, got_reqs, _ = _run_embed(tclient, tmetrics, [(404, "application/json", "{}")])
    want, want_reqs, _ = _run_embed(jclient, jmetrics, [(404, "application/json", "{}")])
    assert got == "HTTPStatusError" and want == "HTTPStatusError" and len(got_reqs) == len(want_reqs) == 1
    jconfiguration.reset_config_cache()
