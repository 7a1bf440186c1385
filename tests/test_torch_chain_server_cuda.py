"""The chain server on the card at a small size: the gates of
``chip_smoke.py``'s ``chain`` phase, and the kernels of the path.

A small Llama (head dim 128, W8A8, random from a seed) serves behind
``GPUChatLLM`` on the card; the ``hash`` embedder and the exact store
(on the card) do the retrieval.  The retrieved context must reach the
prompt, the streamed answer must be the engine's own greedy ids and text
for the same prompt ids, no rung of the degradation ladder may serve, and
K1, K2 and K4 must have launched.

These skip without a card (the decision is made inside the fixture).  On a
machine with one:

    python -m pytest --noconftest tests/test_torch_chain_server_cuda.py -q
"""

import os
import threading

import pytest
import torch

from chip_smoke import _generate, _search, _upload
from generativeaiexamples_tpu_torch.chains import developer_rag
from generativeaiexamples_tpu_torch.chains import factory
from generativeaiexamples_tpu_torch.chains.llm import GPUChatLLM
from generativeaiexamples_tpu_torch.core.configuration import get_config, reset_config_cache
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import decode_stream
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import _cuda
from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk
from generativeaiexamples_tpu_torch.server.app import create_app
from generativeaiexamples_tpu_torch.server.schema import sanitize

pytestmark = pytest.mark.cuda

DOCS = [f"document {i}: the {w} keeps {i * 7 % 13} rows of {w} data on the card." for i, w in
        enumerate(["cache", "store", "engine", "kernel", "router", "index", "stream", "batch"])]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def served(dev, monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    for key, value in (("APP_LLM_MODELENGINE", "echo"), ("APP_EMBEDDINGS_MODELENGINE", "hash"),
                       ("APP_EMBEDDINGS_DIMENSIONS", "64"), ("APP_RETRIEVER_SCORETHRESHOLD", "-1.0"),
                       ("GAIE_UPLOAD_DIR", str(tmp_path))):
        monkeypatch.setenv(key, value)
    reset_config_cache()
    factory.reset_factories()
    cfg = llama.LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=8, n_kv_heads=2, head_dim=128,
                            d_ff=1024, max_seq_len=1024, rope_theta=10000.0, kv_dtype="int8")
    sched = Scheduler(cfg, None, device=dev, max_batch=4, max_len=1024, decode_chunk_size=4,
                      prefill_chunk_tokens=None, seed=3)
    llm = GPUChatLLM(scheduler=sched)
    monkeypatch.setattr(developer_rag, "get_chat_llm", lambda: llm)
    received = []
    stream = GPUChatLLM.stream
    monkeypatch.setattr(GPUChatLLM, "stream", lambda self, messages, **kw: (
        received.append(list(messages)), stream(self, messages, **kw))[1])
    server = create_app()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", llm, received
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    llm.close()
    factory.reset_factories()
    reset_config_cache()


def test_chain_server_on_the_card(served):
    base, llm, received = served
    for i, text in enumerate(DOCS):
        _upload(base, f"doc{i}.txt", text)
    retriever = factory.get_retriever()
    assert retriever.store.device.type == "cuda"
    _cuda.reset_launch_counts()
    query = "which document keeps the kernel rows?"
    hits = _search(base, query, retriever.top_k)
    assert len(hits) == retriever.top_k
    llm.scheduler.prefix_cache = "off"
    streamed, submit = [], llm.scheduler.submit

    def recording_submit(req):
        on_token = req.on_token
        req.on_token = lambda t: (streamed.append(int(t)), on_token(t))
        submit(req)

    llm.scheduler.submit = recording_submit
    res = _generate(base, query, max_tokens=16)
    llm.scheduler.submit = submit
    context = retriever.build_context([ScoredChunk(Chunk(text=h["content"], source=h["filename"]), h["score"])
                                       for h in hits])
    messages = received[-1]
    assert messages[0] == ("system", get_config().prompts.rag_template.format(context=context))
    assert messages[-1] == ("user", query) and res["done"]["cache_tier"] == "exact" and not res["done"]["degraded"]
    tokens, done = [], threading.Event()
    ids = llm.tokenizer.apply_chat_template(messages)
    llm.scheduler.submit(Request(token_ids=list(ids), sampling=SamplingParams(temperature=0.0, max_tokens=16),
                                 on_token=tokens.append, on_done=lambda _: done.set(), eos_id=llm.tokenizer.eos_id))
    assert done.wait(120)
    piece = decode_stream(llm.tokenizer)
    direct = [p for p in [piece(t) for t in tokens] + [piece(0, final=True)] if p]
    assert streamed == tokens and len(tokens) == 16
    assert res["pieces"] == [sanitize(p) for p in direct]
    off = _generate(base, "a short question", kb=False, max_tokens=8)
    assert off["status"] == 200 and off["pieces"] and not off["done"]["degraded"]
    assert all(_cuda.LAUNCHES[k] > 0 for k in ("qmm", "decode_attention", "flash_attention")), _cuda.LAUNCHES
    assert _cuda.LAUNCHES["paged_decode_attention"] == 0
