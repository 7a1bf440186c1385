"""The port's HTTP front (``engine/server.py``) over a tiny CPU scheduler:
health, models, metrics, plain and streaming completions, and chat.  The
completion's text must be the scheduler's own greedy tokens for the same
prompt.  A server built from the command line with ``--kv-layout paged``
serves a completion and exports the KV pool series.  ``/v1/embeddings``
and ``/v1/ranking`` (bert-tiny embedder behind the micro-batcher, and a
bert-tiny reranker) answer what direct calls give, concurrent queries
coalesce in the ``rag_*`` series, and a front without them answers 501."""

import json
import queue
import threading
import urllib.request

import pytest
import torch

from generativeaiexamples_tpu_torch.engine.decode import w8a8_params
from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
from generativeaiexamples_tpu_torch.engine.microbatch import BatchedEmbedder
from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.server import build_server, create_engine_app
from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.models import bert, llama

CFG = llama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
PROMPT = "hello port"


@pytest.fixture(scope="module")
def served():
    gen = torch.Generator().manual_seed(1)
    params = w8a8_params(CFG, None, device="cpu", generator=gen)
    sched = Scheduler(
        CFG, params, device="cpu", max_batch=4, max_len=128, decode_chunk_size=2,
        prefill_chunk_tokens=8, prefix_cache="off",
    )
    sched.start()
    server = create_engine_app(sched, ByteTokenizer(), model_name="llama-tiny")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield sched, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=10)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read().decode()


def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read().decode()


def _greedy_text(sched, ids, max_tokens):
    tokens, done = [], queue.Queue()
    sched.submit(Request(
        token_ids=list(ids), sampling=SamplingParams(temperature=0.0, max_tokens=max_tokens),
        on_token=tokens.append, on_done=done.put, eos_id=ByteTokenizer().eos_id,
    ))
    done.get(timeout=120)
    return ByteTokenizer().decode(tokens), tokens


def test_health_models_metrics(served):
    _, base = served
    status, body = _get(base + "/health")
    assert status == 200 and json.loads(body)["status"] == "ok"
    status, body = _get(base + "/v1/models")
    assert json.loads(body)["data"][0]["id"] == "llama-tiny"
    status, body = _get(base + "/metrics")
    assert status == 200 and "engine_requests_total" in body
    assert 'engine_matmul_kernel{kernel="pallas_w8a8"} 1' in body


def test_completions_plain_and_stream_match_scheduler(served):
    sched, base = served
    ids = ByteTokenizer().encode(PROMPT)
    want, toks = _greedy_text(sched, ids, 8)
    status, body = _post(base + "/v1/completions", {"prompt": PROMPT, "max_tokens": 8, "temperature": 0})
    out = json.loads(body)
    assert status == 200 and out["choices"][0]["text"] == want
    assert out["usage"]["prompt_tokens"] == len(ids)
    assert out["usage"]["completion_tokens"] == len(toks)
    status, body = _post(
        base + "/v1/completions", {"prompt": PROMPT, "max_tokens": 8, "temperature": 0, "stream": True}
    )
    events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert "".join(c["choices"][0]["text"] for c in chunks) == want
    assert chunks[-1]["choices"][0]["finish_reason"] in ("length", "stop")


def test_chat_completions(served):
    sched, base = served
    messages = [{"role": "user", "content": "hi"}]
    ids = ByteTokenizer().apply_chat_template([("user", "hi")])
    want, _ = _greedy_text(sched, ids, 6)
    status, body = _post(base + "/v1/chat/completions", {"messages": messages, "max_tokens": 6, "temperature": 0})
    out = json.loads(body)
    assert status == 200 and out["choices"][0]["message"]["content"] == want
    status, body = _post(
        base + "/v1/chat/completions",
        {"messages": messages, "max_tokens": 6, "temperature": 0, "stream": True},
    )
    events = [json.loads(line[6:]) for line in body.splitlines() if line.startswith("data: {")]
    assert events[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert "".join(e["choices"][0]["delta"].get("content", "") for e in events) == want


def test_bad_request_is_422(served):
    _, base = served
    req = urllib.request.Request(base + "/v1/completions", b"{}", {"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 422


KV_SERIES = (
    "engine_kv_pages_total", "engine_kv_pages_free", "engine_kv_pages_parked", "engine_kv_pages_shared",
    "engine_kv_cow_breaks_total", "engine_kv_page_evictions_total",
)


def _metric(body, name):
    return float(next(line.split()[1] for line in body.splitlines() if line.startswith(name + " ")))


def test_contiguous_metrics_read_zero_kv_pages(served):
    _, base = served
    _, body = _get(base + "/metrics")
    for name in KV_SERIES:
        assert _metric(body, name) == 0, name


def test_paged_server_from_the_command_line():
    server = build_server([
        "--device", "cpu", "--model", "llama-tiny", "--host", "127.0.0.1", "--port", "0",
        "--max-batch", "2", "--max-len", "128", "--decode-chunk-size", "2", "--prefill-chunk-tokens", "8",
        "--kv-layout", "paged", "--kv-page-size", "16", "--kv-pool-pages", "40", "--matmul-kernel", "pallas_w8a8",
    ])
    sched = server.scheduler
    assert sched.kv_layout == "paged" and sched.kv_page_size == 16 and sched._pool.total_pages == 40
    sched.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, body = _post(base + "/v1/completions", {"prompt": PROMPT * 4, "max_tokens": 6, "temperature": 0})
        out = json.loads(body)
        assert status == 200 and out["usage"]["completion_tokens"] == 6 and out["choices"][0]["text"]
        _, body = _get(base + "/metrics")
        assert _metric(body, "engine_kv_pages_total") == 40
        # The history (41 prompt tokens and 5 of the 6 sampled, the last
        # never fed back) parked as a segment of three 16-token pages.
        assert _metric(body, "engine_kv_pages_parked") == 3
        assert _metric(body, "engine_kv_pages_free") == 40 - 1 - 3
        for name in KV_SERIES:
            assert f"# TYPE {name} " in body
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=10)


@pytest.fixture(scope="module")
def rag_served(served):
    """A second front over the same scheduler, with an embedder behind the
    micro-batcher and a reranker."""
    sched, _ = served
    inner = GPUEmbedder(bert.bert_tiny(dtype="float32"), batch_size=8, max_length=64, device="cpu")
    embedder = BatchedEmbedder(inner, max_batch=8, max_wait_ms=200.0)
    reranker = GPUReranker(bert.bert_tiny(dtype="float32"), batch_size=4, max_length=64, device="cpu")
    server = create_engine_app(sched, ByteTokenizer(), model_name="llama-tiny", embedder=embedder, reranker=reranker)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield inner, reranker, embedder, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        embedder.close()
        thread.join(timeout=10)


def _vectors(body):
    out = json.loads(body)
    assert out["object"] == "list" and [d["index"] for d in out["data"]] == list(range(len(out["data"])))
    return [d["embedding"] for d in out["data"]]


@pytest.mark.parametrize("input_type", ["query", "passage"])
@pytest.mark.parametrize("shape", ["string", "list"])
def test_embeddings_route(rag_served, input_type, shape):
    inner, _, _, base = rag_served
    texts = ["what is a tpu"] if shape == "string" else ["first text", "second, longer text", "third"]
    status, body = _post(base + "/v1/embeddings", {"input": texts[0] if shape == "string" else texts,
                                                    "input_type": input_type})
    assert status == 200
    want = inner.embed_queries(texts) if input_type == "query" else inner.embed_documents(texts)
    torch.testing.assert_close(torch.tensor(_vectors(body)), torch.tensor(want), atol=1e-5, rtol=1e-5)


def test_concurrent_query_embeddings_coalesce(rag_served):
    """32 clients at once: none is turned away (the listen backlog queues
    the burst), and their queries share forwards."""
    inner, _, embedder, base = rag_served
    before = embedder.batcher.stats.snapshot()
    texts = [f"query number {i}" for i in range(32)]
    out = {}

    def one(t):
        out[t] = _vectors(_post(base + "/v1/embeddings", {"input": t, "input_type": "query"})[1])[0]

    threads = [threading.Thread(target=one, args=(t,)) for t in texts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and len(out) == 32
    for t in texts:
        torch.testing.assert_close(torch.tensor(out[t]), torch.tensor(inner.embed_query(t)), atol=1e-5, rtol=1e-4)
    _, body = _get(base + "/metrics")
    assert _metric(body, "rag_requests_total") == before["requests_total"] + 32
    assert _metric(body, "rag_batches_total") - before["batches_total"] < 32
    assert _metric(body, "rag_embed_batch_size_sum") == before["batch_size_sum"] + 32
    assert _metric(body, "rag_embed_batch_size_count") == _metric(body, "rag_batches_total")
    assert _metric(body, "rag_errors_total") == 0


def test_ranking_route(rag_served):
    _, reranker, _, base = rag_served
    passages = ["tpus are accelerators", "bananas", "a tensor processing unit", "the weather"]
    for query, sent in (("what is a tpu", [{"text": p} for p in passages]), ({"text": "what is a tpu"}, passages)):
        status, body = _post(base + "/v1/ranking", {"query": query, "passages": sent})
        assert status == 200
        ranks = json.loads(body)["rankings"]
        scores = reranker.score("what is a tpu", passages)
        assert [r["index"] for r in ranks] == sorted(range(4), key=lambda i: -scores[i])
        torch.testing.assert_close(torch.tensor([r["logit"] for r in ranks]),
                                   torch.tensor(sorted(scores, reverse=True)))


def _status(base, route, body):
    req = urllib.request.Request(base + route, json.dumps(body).encode(), {"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    return exc.value.code


def test_embeddings_and_ranking_errors(served, rag_served):
    _, bare = served
    base = rag_served[3]
    assert _status(bare, "/v1/embeddings", {"input": "x"}) == 501
    assert _status(bare, "/v1/ranking", {"query": "q", "passages": ["p"]}) == 501
    for body in ({}, {"input": 5}, {"input": ["a", 3]}):
        assert _status(base, "/v1/embeddings", body) == 422
    for body in ({"query": "q"}, {"passages": ["p"]}, {"query": "q", "passages": [{"no": "text"}]},
                 {"query": 3, "passages": ["p"]}):
        assert _status(base, "/v1/ranking", body) == 422


def test_rag_series_export_zero_without_batcher(served):
    _, base = served
    _, body = _get(base + "/metrics")
    for name in ("rag_requests_total", "rag_batches_total", "rag_embed_batch_size_sum", "rag_embed_batch_size_count",
                 "rag_embed_batch_size_max", "rag_queue_wait_ms_sum", "rag_queue_wait_ms_count", "rag_errors_total"):
        assert _metric(body, name) == 0, name


@pytest.mark.parametrize("flags,want", [
    ([], ("bert-tiny", 32, 3.0)),
    (["--embedder", "tiny", "--embed-max-batch", "8", "--embed-max-wait-ms", "5"], ("bert-tiny", 8, 5.0)),
    (["--embed-max-batch", "1"], ("bert-tiny", None, None)),
    (["--embedder", "none"], None),
])
def test_embedder_flags_of_build_server(flags, want):
    server = build_server(["--device", "cpu", "--model", "llama-tiny", "--host", "127.0.0.1", "--port", "0",
                           "--max-batch", "2", "--max-len", "128", *flags])
    try:
        embedder = server.embedder
        if want is None:
            assert embedder is None
            return
        preset, max_batch, wait = want
        batcher = getattr(embedder, "batcher", None)
        assert (batcher.max_batch, batcher.max_wait_ms) == (max_batch, wait) if batcher else max_batch is None
        inner = embedder._inner if batcher else embedder
        assert isinstance(inner, GPUEmbedder) and inner.cfg == bert.PRESETS[preset]()
        assert inner.device == torch.device("cpu") and len(embedder.embed_query("hi")) == 64
    finally:
        server.server_close()
        if hasattr(server.embedder, "close"):
            server.embedder.close()


@pytest.mark.parametrize("model", ["gemma-tiny", "starcoder2-tiny", "llama-moe-tiny"])
def test_build_server_serves_each_family_as_the_jax_scheduler(model, tmp_path, monkeypatch):
    """``--model gemma-tiny`` / ``starcoder2-tiny`` / ``llama-moe-tiny`` on the
    CPU: a checkpoint of the JAX package's random params (written in HF's
    names by ``chip_smoke.write_family_checkpoint``) provisioned under
    ``$GAIE_WEIGHTS_DIR`` is served, the MoE tree routed droplessly as
    ``build_server`` sets it, with the greedy stream the JAX scheduler
    emits on the same checkpoint."""
    import jax
    import numpy as np

    from chip_smoke import write_family_checkpoint
    from generativeaiexamples_tpu.engine import decode as jdecode
    from generativeaiexamples_tpu.engine import scheduler as jsched
    from generativeaiexamples_tpu.engine import weights as jweights
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy

    moe = {"moe_dropless": True} if "moe" in model else {}
    jcfg = jllama.PRESETS[model](dtype="float32", max_seq_len=128, kv_dtype="int8", **moe)
    tcfg = llama.PRESETS[model](dtype="float32", max_seq_len=128, kv_dtype="int8", **moe)
    raw = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    path = str(tmp_path / model)
    write_family_checkpoint(torch, path, tcfg, params_from_numpy(jax.tree.map(np.asarray, raw), tcfg, "cpu"))
    monkeypatch.setenv("GAIE_WEIGHTS_DIR", str(tmp_path))
    preset = llama.PRESETS[model]
    monkeypatch.setitem(llama.PRESETS, model, lambda **kw: preset(**{"dtype": "float32", **kw}))
    server = build_server([
        "--device", "cpu", "--model", model, "--host", "127.0.0.1", "--port", "0", "--max-batch", "2",
        "--max-len", "128", "--decode-chunk-size", "2", "--prefill-chunk-tokens", "8", "--embedder", "none",
        "--matmul-kernel", "pallas_w8a8",
    ])
    sched = server.scheduler
    assert sched.cfg.moe_dropless == bool(moe) and sched.cfg.dtype == "float32"
    sched.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, body = _post(f"http://127.0.0.1:{server.server_address[1]}/v1/completions",
                             {"prompt": PROMPT * 3, "max_tokens": 6, "temperature": 0})
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=10)
    assert status == 200

    monkeypatch.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    monkeypatch.setenv("GAIE_EXACT_SAMPLING", "1")
    jp = jdecode.prepare_params(jcfg, jweights.load_hf_causal_lm(jcfg, path), None, quantize=True, pack=True,
                                matmul_kernel="pallas_w8a8")
    ref = jsched.Scheduler(jcfg, jp, matmul_kernel="pallas_w8a8", max_batch=2, max_len=128, decode_chunk_size=2,
                           prefill_chunk_tokens=8, prefix_cache="shared")
    tokens: list[int] = []
    done: "queue.Queue[str]" = queue.Queue()
    ref.start()
    try:
        ref.submit(jsched.Request(token_ids=ByteTokenizer().encode(PROMPT * 3),
                                  sampling=jsched.SamplingParams(temperature=0.0, max_tokens=6),
                                  on_token=tokens.append, on_done=done.put, eos_id=ByteTokenizer().eos_id))
        done.get(timeout=180)
    finally:
        ref.stop()
    assert tokens and json.loads(body)["choices"][0]["text"] == ByteTokenizer().decode(tokens)


def test_matmul_kernel_resolves_as_the_reference(monkeypatch):
    """``--matmul-kernel``, then ``GAIE_MATMUL_KERNEL``, then
    ``[llm].matmul_kernel``, then ``xla``: the JAX server's order."""
    from generativeaiexamples_tpu_torch.core import configuration
    from generativeaiexamples_tpu_torch.engine.server import parse_args, resolve_matmul_kernel

    monkeypatch.delenv("GAIE_MATMUL_KERNEL", raising=False)
    monkeypatch.delenv("APP_LLM_MATMULKERNEL", raising=False)
    configuration.reset_config_cache()
    try:
        assert resolve_matmul_kernel(parse_args([])) == "xla"
        assert resolve_matmul_kernel(parse_args(["--matmul-kernel", "pallas_w8a8"])) == "pallas_w8a8"
        monkeypatch.setenv("APP_LLM_MATMULKERNEL", "pallas_w8a8")
        configuration.reset_config_cache()
        assert resolve_matmul_kernel(parse_args([])) == "pallas_w8a8"
        assert resolve_matmul_kernel(parse_args(["--matmul-kernel", "xla"])) == "xla"
        monkeypatch.setenv("GAIE_MATMUL_KERNEL", "xla")
        assert resolve_matmul_kernel(parse_args([])) == "xla"
        with pytest.raises(SystemExit):
            parse_args(["--matmul-kernel", "w8a8"])
    finally:
        monkeypatch.undo()
        configuration.reset_config_cache()


def _one_completion(server, prompt, max_tokens=6):
    sched = server.scheduler
    sched.start()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, body = _post(f"http://127.0.0.1:{server.server_address[1]}/v1/completions",
                             {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0})
        _, metrics = _get(f"http://127.0.0.1:{server.server_address[1]}/metrics")
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=10)
    return status, json.loads(body), metrics


XLA_ARGV = ["--device", "cpu", "--model", "llama-tiny", "--host", "127.0.0.1", "--port", "0", "--max-batch", "2",
            "--max-len", "128", "--decode-chunk-size", "2", "--prefill-chunk-tokens", "8", "--embedder", "none"]


def test_default_server_serves_float_weights_over_the_preset_cache(monkeypatch):
    """No flag: the ``xla`` path, random float weights from ``--seed`` (no
    blocked leaf), the preset's bf16 cache; ``/metrics`` names it."""
    monkeypatch.delenv("GAIE_MATMUL_KERNEL", raising=False)
    server = build_server(XLA_ARGV)
    sched = server.scheduler
    assert sched.matmul_kernel == "xla" and sched.cfg.kv_dtype == "bfloat16"
    assert len(sched._cache) == 2 and sched._cache[0].dtype == torch.bfloat16
    assert sched.params["layers"]["wq"].dtype == torch.bfloat16  # unpacked, as the reference's scheduler
    status, out, metrics = _one_completion(server, PROMPT)
    assert status == 200 and out["usage"]["completion_tokens"] >= 1
    assert 'engine_matmul_kernel{kernel="xla"} 1' in metrics


def test_paged_server_on_xla_serves_int8_pages(monkeypatch, caplog):
    monkeypatch.delenv("GAIE_MATMUL_KERNEL", raising=False)
    with caplog.at_level("INFO"):
        server = build_server(XLA_ARGV + ["--kv-layout", "paged", "--kv-page-size", "16"])
    assert "kv_layout=paged requires int8 KV; overriding kv_dtype=bfloat16" in caplog.text
    sched = server.scheduler
    assert sched.matmul_kernel == "xla" and sched._pool is not None and sched._cache[0].dtype == torch.int8
    status, out, metrics = _one_completion(server, PROMPT)
    assert status == 200 and out["usage"]["completion_tokens"] >= 1 and "engine_kv_pages_total" in metrics


def test_float_draft_on_xla_from_the_command_line(monkeypatch):
    """``--draft-model`` on ``xla``: the draft keeps its preset's KV dtype
    and float weights (the reference's bf16 draft), and the server
    speculates with it."""
    monkeypatch.delenv("GAIE_MATMUL_KERNEL", raising=False)
    monkeypatch.delenv("GAIE_WEIGHTS_DIR", raising=False)
    server = build_server(XLA_ARGV + ["--spec-decode", "--draft-model", "llama-tiny", "--gamma", "2"])
    sched = server.scheduler
    assert sched.draft_cfg.kv_dtype == "bfloat16" and len(sched._dcache) == 2
    assert sched.draft_params["layers"]["wqkv"].dtype == torch.bfloat16
    status, out, _ = _one_completion(server, PROMPT)
    assert status == 200 and out["usage"]["completion_tokens"] >= 1
    assert sched.stats.snapshot()["spec_rounds"] > 0
