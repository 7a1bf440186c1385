"""The port's bulk-ingest pipeline (``ingest/pipeline.py``) against the JAX
package's on the CPU.

The same files, loaders, splitter settings and hash embedder (dimension
64) go through both pipelines into each package's memory store: the same
chunks with the same vectors land, the job status snapshots agree with
job ids and rates masked, a poisoned file (one that does not parse, one
whose embedding fails, one over a quota) fails alone, direct mode runs
the custom ingest, and ``ingest_metrics_lines`` agree.  A device failure
in the embed dispatcher fails the port's job as a whole (a deliberate
difference: the reference would retry it file by file).
"""

import threading

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JHashEmbedder
from generativeaiexamples_tpu.ingest import loaders as jloaders
from generativeaiexamples_tpu.ingest import pipeline as jpipeline
from generativeaiexamples_tpu.ingest.splitters import RecursiveCharacterSplitter as JSplitter
from generativeaiexamples_tpu.retrieval.base import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.memory import MemoryVectorStore as JMemoryVectorStore
from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder
from generativeaiexamples_tpu_torch.ingest import loaders as tloaders
from generativeaiexamples_tpu_torch.ingest import pipeline as tpipeline
from generativeaiexamples_tpu_torch.ingest.splitters import RecursiveCharacterSplitter
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore

DIM = 64
JAX = dict(pipeline=jpipeline, loaders=jloaders, Splitter=JSplitter, Chunk=JChunk, Store=JMemoryVectorStore,
           Hash=JHashEmbedder)
PORT = dict(pipeline=tpipeline, loaders=tloaders, Splitter=RecursiveCharacterSplitter, Chunk=Chunk,
            Store=MemoryVectorStore, Hash=HashEmbedder)
SIDES = {"jax": JAX, "port": PORT}


def _write_docs(tmp_path, n=7):
    """Text, markdown, CSV and JSON files of a few hundred bytes each, plus
    an unsupported extension and a .json file that is not JSON."""
    rng = np.random.default_rng(0)
    words = ["cache", "vector", "search", "engine", "token", "layer", "kernel", "batch", "ünïcödé", "store"]
    files = []
    for i in range(n):
        text = " ".join(rng.choice(words, 60 + 10 * i))
        ext = (".txt", ".md", ".csv")[i % 3]
        p = tmp_path / f"doc{i}{ext}"
        p.write_text(text if ext != ".csv" else "name,text\n" + "\n".join(f"r{j},{text[j:j + 30]}" for j in range(5)))
        files.append((str(p), p.name))
    (tmp_path / "data.json").write_text('{"title": "json doc", "body": "kernel batch store"}')
    files.append((str(tmp_path / "data.json"), "data.json"))
    return files


def _poison(tmp_path):
    (tmp_path / "bad.xyz").write_text("unsupported extension")
    (tmp_path / "broken.json").write_text("{not json")
    return [(str(tmp_path / "bad.xyz"), "bad.xyz"), (str(tmp_path / "broken.json"), "broken.json")]


def _pipeline(side, store, embed_fn=None, **kw):
    splitter = side["Splitter"](chunk_size=120, chunk_overlap=20)

    def parse(path, name):
        return [side["Chunk"](text=t, source=name) for t in splitter.split(side["loaders"].load_document(path))]

    kw.setdefault("parse_workers", 1)
    kw.setdefault("embed_batch_chunks", 16)
    kw.setdefault("append_batch_chunks", 8)
    return side["pipeline"].IngestPipeline(parse_fn=parse, embed_fn=embed_fn or side["Hash"](DIM).embed_documents,
                                           append_fn=store.add, **kw)


def _run(side, files, **kw):
    store = side["Store"](DIM)
    pipe = _pipeline(side, store, **kw)
    try:
        snap = pipe.wait(pipe.submit(files), timeout=60)
        stats, listing = pipe.stats.snapshot(), pipe.status()
    finally:
        pipe.close()
    return store, snap, stats, listing


def _mask(snap):
    snap = dict(snap)
    snap.pop("job_id")
    snap.pop("docs_per_sec")
    snap["errors"] = sorted(snap["errors"])
    return snap


def _counts(stats):
    """The counters that do not depend on how the dispatcher's idle flush
    happened to cut the batches."""
    return {k: stats[k] for k in ("jobs_total", "docs_total", "doc_failures_total", "chunks_total")}


def _corpus(store):
    return sorted((c.source, c.text, v.tobytes()) for c, v in zip(store._chunks, store._vecs))


def test_same_files_land_the_same_chunks_and_vectors(tmp_path):
    files = _write_docs(tmp_path)
    (jstore, jsnap, jstats, jlist), (tstore, tsnap, tstats, tlist) = _run(JAX, files), _run(PORT, files)
    assert _corpus(tstore) == _corpus(jstore) and len(tstore) > len(files)
    assert _mask(tsnap) == _mask(jsnap) and tsnap["status"] == "done"
    assert _counts(tstats) == _counts(jstats) and tstats["embed_batches_total"] < len(files)
    assert [_mask(j) for j in tlist["jobs"]] == [_mask(j) for j in jlist["jobs"]] and tlist["active_jobs"] == 0


@pytest.mark.parametrize("workers", [1, 3])
def test_a_poisoned_file_fails_alone(tmp_path, workers):
    """Two files that do not load, and one whose embedding raises: each
    fails alone, its batch-mates land, the job ends 'partial'."""
    files = _write_docs(tmp_path) + _poison(tmp_path)
    out = {}
    for name, side in SIDES.items():
        embedder = side["Hash"](DIM)

        def embed(texts, embedder=embedder):
            if any("json doc" in t for t in texts):
                raise ValueError("poisoned embedding")
            return embedder.embed_documents(texts)

        store, snap, stats, _ = _run(side, files, embed_fn=embed, parse_workers=workers)
        out[name] = (_corpus(store), _mask(snap), _counts(stats))
    assert out["port"] == out["jax"]
    snap = out["port"][1]
    assert snap["status"] == "partial" and snap["files_failed"] == 3 and snap["files_done"] == len(files) - 3
    assert any("bad.xyz" in e and "ValueError" in e for e in snap["errors"])
    assert any("data.json" in e and "poisoned embedding" in e for e in snap["errors"])


def test_a_quota_refusal_fails_only_its_file(tmp_path):
    files = _write_docs(tmp_path, n=4)
    out = {}
    for name, side in SIDES.items():
        counts = {}

        def admit(chunks, embs, counts=counts):
            total = counts.get("rows", 0) + len(chunks)
            if total > 12:
                raise RuntimeError(f"quota exceeded: rows {total} > 12")
            counts["rows"] = total

        store, snap, stats, _ = _run(side, files, admit_fn=admit, embed_batch_chunks=1000)
        out[name] = (_corpus(store), _mask(snap), _counts(stats))
    assert out["port"] == out["jax"]
    assert out["port"][1]["files_failed"] >= 1 and out["port"][1]["files_done"] >= 1


def test_direct_mode_and_empty_jobs_match_the_reference(tmp_path):
    files = _write_docs(tmp_path, n=3)
    out = {}
    for name, side in SIDES.items():
        seen, lock = [], threading.Lock()

        def custom(path, fname, seen=seen, lock=lock):
            with lock:
                seen.append(fname)

        store = side["Store"](DIM)
        pipe = _pipeline(side, store)
        try:
            snap = pipe.wait(pipe.submit(files, ingest_fn=custom), timeout=30)
            empty = pipe.status(pipe.submit([]))
        finally:
            pipe.close()
        with pytest.raises(RuntimeError):
            pipe.submit(files)
        out[name] = (_mask(snap), _mask(empty), sorted(seen), len(store))
    assert out["port"] == out["jax"]
    assert out["port"][0]["status"] == "done" and out["port"][1]["status"] == "done" and out["port"][3] == 0


def test_ingest_metrics_lines_match_the_reference(tmp_path):
    assert tpipeline.ingest_metrics_lines(None) == jpipeline.ingest_metrics_lines(None)
    files = _write_docs(tmp_path) + _poison(tmp_path)
    snap = _run(PORT, files)[2]
    assert tpipeline.ingest_metrics_lines(snap, active_jobs=2) == jpipeline.ingest_metrics_lines(snap, active_jobs=2)
    got = tpipeline.ingest_metrics_lines(snap)
    assert "ingest_doc_failures_total 2" in got and "ingest_jobs_active 0" in got
    assert f"ingest_chunks_total {snap['chunks_total']}" in got and snap["chunks_total"] > len(files)


@pytest.mark.parametrize("error", [torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
                                   RuntimeError("CUDA error: an illegal memory access was encountered")],
                         ids=["oom", "cuda_error"])
def test_a_device_failure_fails_the_job(tmp_path, error):
    """A failure of the card is not a poisoned file: no per-file retry
    hides it, every file of the batch fails and the job is 'failed', even
    where files of other batches landed."""
    files = _write_docs(tmp_path)
    calls = []

    def embed(texts):
        calls.append(list(texts))
        if len(calls) == 2:
            raise error
        return HashEmbedder(DIM).embed_documents(texts)

    store, snap, _, _ = _run(PORT, files, embed_fn=embed)
    assert snap["status"] == "failed" and snap["files_done"] >= 1 and snap["files_failed"] >= 1
    assert snap["files_done"] + snap["files_failed"] == len(files)
    assert all(type(error).__name__ in e for e in snap["errors"])
    # No per-file retry re-embeds the failed batch's texts.
    assert not any(set(c) <= set(calls[1]) for c in calls[2:])
    assert len(store) > 0


@pytest.mark.parametrize("where", ["retry", "append"])
def test_a_device_failure_in_a_retry_or_an_append_fails_the_job(tmp_path, where):
    """Out of device memory during the per-file retry of a poisoned batch
    fails that file and the rest of the batch, with no further retry; met
    at an append's second slice, it takes back the batch's rows that
    already landed.  Either way the job is 'failed'."""
    files = _write_docs(tmp_path)
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
    store = MemoryVectorStore(DIM)
    calls, appends, state = [], [], {}

    def embed(texts):
        calls.append(list(texts))
        if where == "retry" and any("json doc" in t for t in texts) and "poisoned" not in state:
            state["poisoned"] = len(calls) - 1
            raise ValueError("poisoned embedding")
        if where == "retry" and "poisoned" in state and "oom" not in state:
            state["oom"] = len(calls) - 1
            raise oom
        return HashEmbedder(DIM).embed_documents(texts)

    def append(chunks, embs):
        appends.append(len(chunks))
        if where == "append" and len(appends) == 3:
            raise oom
        return store.add(chunks, embs)

    splitter = RecursiveCharacterSplitter(chunk_size=120, chunk_overlap=20)
    pipe = tpipeline.IngestPipeline(
        parse_fn=lambda path, name: [Chunk(text=t, source=name) for t in splitter.split(tloaders.load_document(path))],
        embed_fn=embed, append_fn=append, parse_workers=1, embed_batch_chunks=16, append_batch_chunks=4,
        delete_source_fn=store.delete_source)
    try:
        snap = pipe.wait(pipe.submit(files), timeout=60)
    finally:
        pipe.close()
    failed = {e.split(":")[0] for e in snap["errors"]}
    assert snap["status"] == "failed" and snap["files_done"] >= 1 and snap["files_failed"] >= 1
    assert snap["files_done"] + snap["files_failed"] == len(files)
    assert any("OutOfMemoryError" in e for e in snap["errors"])
    landed = {c.source for c in store._chunks}
    assert not landed & failed and len(landed) == snap["files_done"]
    if where == "retry":
        poisoned = set(calls[state["poisoned"]])
        # Nothing of the poisoned batch is embedded again after the OOM.
        assert not any(set(c) <= poisoned for c in calls[state["oom"] + 1:])
        assert "data.json" in failed
