"""The port's HTTP front (``engine/server.py``) over a tiny CPU scheduler:
health, models, metrics, plain and streaming completions, and chat.  The
completion's text must be the scheduler's own greedy tokens for the same
prompt.  A server built from the command line with ``--kv-layout paged``
serves a completion and exports the KV pool series."""

import json
import queue
import threading
import urllib.request

import pytest
import torch

from generativeaiexamples_tpu_torch.engine.decode import prepare_params
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.server import build_server, create_engine_app
from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.models import llama

CFG = llama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
PROMPT = "hello port"


@pytest.fixture(scope="module")
def served():
    gen = torch.Generator().manual_seed(1)
    params = prepare_params(CFG, None, device="cpu", generator=gen)
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
    assert 'engine_matmul_kernel{kernel="w8a8"} 1' in body


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
        "--kv-layout", "paged", "--kv-page-size", "16", "--kv-pool-pages", "40",
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
