"""The bulk-ingest pipeline, durable recovery and the profiler routes on the
card at a small size.

A small BERT (bert-tiny at width 64, random from a seed) embeds on the
card through ``GPUEmbedder``; the exact store lives on the card behind the
write-ahead log.  A bulk job lands every good file once and fails the bad
ones alone; the store recovered from the WAL, and then from the final
snapshot, is on the card and searches bit for bit as before; a device
failure fails the job; a profiler session started and stopped on request
threads records the CUDA kernels another thread launches.

These skip without a card (the decision is made inside the fixture).  On a
machine with one:

    python -m pytest --noconftest tests/test_torch_ingest_cuda.py -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from generativeaiexamples_tpu_torch.chains import factory
from generativeaiexamples_tpu_torch.core.configuration import reset_config_cache
from generativeaiexamples_tpu_torch.durability.store import DurableVectorStore

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["cache", "store", "engine", "kernel", "router", "index", "stream", "batch", "token", "layer"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def durable(dev, monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    for key, value in (("APP_LLM_MODELENGINE", "echo"), ("APP_EMBEDDINGS_MODELENGINE", "tpu"),
                       ("APP_EMBEDDINGS_DIMENSIONS", "64"), ("APP_RETRIEVER_SCORETHRESHOLD", "-1.0"),
                       ("APP_DURABILITY_ENABLED", "true"), ("GAIE_DURABILITY_DIR", str(tmp_path / "durable"))):
        monkeypatch.setenv(key, value)
    reset_config_cache()
    factory.reset_factories()
    yield tmp_path
    factory.reset_factories()
    reset_config_cache()


def _files(tmp_path, n):
    out = []
    for i in range(n):
        p = tmp_path / f"doc{i}.txt"
        p.write_text(" ".join(WORDS[(i + j) % len(WORDS)] for j in range(300 + 40 * i)))
        out.append((str(p), p.name))
    (tmp_path / "bad.xyz").write_text("no loader")
    return out + [(str(tmp_path / "bad.xyz"), "bad.xyz")]


def _ranks(store, queries):
    return [[(h.chunk.id, h.score) for h in r] for r in store.search_batch(queries, 5)]


def test_bulk_job_and_recovery_on_the_card(durable):
    pipeline = factory.get_ingest_pipeline()
    snap = pipeline.wait(pipeline.submit(_files(durable, 12)), timeout=300)
    store = factory.get_store()
    assert isinstance(store, DurableVectorStore) and store.inner.device.type == "cuda"
    assert snap["status"] == "partial" and snap["files_done"] == 12 and snap["files_failed"] == 1
    assert len(store) == snap["chunks_ingested"] > 12
    queries = factory.get_embedder().embed_queries(["kernel cache", "router stream", "token layer index"])
    sources = sorted(store.sources())
    assert store.delete_source("doc3.txt") > 0
    before, rows = _ranks(store, queries), len(store)
    # A reset closes the WAL without a final snapshot: the next build replays it.
    factory.reset_factories()
    recovered = factory.get_store()
    assert recovered.last_recovery["replayed_records"] > 0 and not recovered.last_recovery["snapshot_restored"]
    assert recovered.inner.device.type == "cuda" and len(recovered) == rows
    assert recovered.last_recovery["device"].startswith("cuda")
    assert _ranks(recovered, queries) == before
    # The graceful path cuts a final snapshot: nothing replays after it.
    factory.shutdown_durability()
    factory.reset_factories()
    again = factory.get_store()
    assert again.last_recovery["snapshot_restored"] and again.last_recovery["replayed_records"] == 0
    assert again.inner.device.type == "cuda" and _ranks(again, queries) == before
    assert sorted(again.sources()) == [s for s in sources if s != "doc3.txt"]


def test_a_device_failure_fails_the_job(durable):
    pipeline = factory.get_ingest_pipeline()
    embed = pipeline._embed_fn

    def exhausting(texts):
        torch.empty(1 << 46, dtype=torch.uint8, device="cuda")  # 64 TiB: out of device memory
        return embed(texts)

    pipeline._embed_fn = exhausting
    snap = pipeline.wait(pipeline.submit(_files(durable, 3)[:3]), timeout=300)
    assert snap["status"] == "failed" and snap["files_failed"] == 3
    assert all("OutOfMemoryError" in e for e in snap["errors"])


_PROFILE = r"""
import json, sys, threading, torch
from generativeaiexamples_tpu_torch.obs import profiler
out = {}
t = threading.Thread(target=lambda: out.update(start=profiler.profiler_start()))
t.start(); t.join()
def work():
    a = torch.randn(512, 512, device="cuda")
    for _ in range(4):
        a = a @ a
    torch.cuda.synchronize()
w = threading.Thread(target=work); w.start(); w.join()
t = threading.Thread(target=lambda: out.update(stop=profiler.profiler_stop()))
t.start(); t.join()
events = json.load(open(out["stop"][1]["trace"]))["traceEvents"]
print(json.dumps([out["start"][0], out["stop"][0], sum(e.get("cat") == "kernel" for e in events)]))
"""


def test_profiler_records_kernels_of_another_thread(dev, tmp_path):
    """A fresh process, as a server is: the session starts on one thread,
    the kernels launch on another, it stops on a third."""
    env = dict(os.environ, GAIE_PROFILER_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _PROFILE], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    start, stop, kernels = json.loads(out.stdout.strip().splitlines()[-1])
    assert start == stop == 200 and kernels >= 4
