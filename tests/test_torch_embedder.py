"""The port's embedder, reranker and micro-batcher against the JAX package
on the CPU.

``GPUEmbedder(device="cpu")`` and ``GPUReranker(device="cpu")`` get the
reference's bert-tiny weights (float32) and must give ``TPUEmbedder``'s
vectors and ``TPUReranker``'s scores within 1e-5; the micro-batcher cases
are the reference's own (``tests/test_microbatch.py``); its deadline and
trace cases are in ``tests/test_torch_microbatch.py``.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JHashEmbedder
from generativeaiexamples_tpu.engine.embedder import TPUEmbedder
from generativeaiexamples_tpu.engine.reranker import TPUReranker
from generativeaiexamples_tpu.models import bert as jbert
from generativeaiexamples_tpu_torch.engine import embedder as tembedder
from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder, HashEmbedder
from generativeaiexamples_tpu_torch.engine.microbatch import BatchedEmbedder, BatcherClosed, MicroBatcher
from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker
from generativeaiexamples_tpu_torch.engine.weights import bert_params_from_numpy, rerank_head_from_numpy
from generativeaiexamples_tpu_torch.models import bert as tbert

TOL = dict(atol=1e-5, rtol=1e-5)
DOCS = ["short", "a slightly longer document text", "x" * 90, "ünïcödé bytes", "passage five"]
QUERIES = ["what is a tpu", "hello", "q" * 40]


@pytest.fixture(scope="module")
def weights():
    cfg = jbert.bert_tiny(dtype="float32")
    jp = jbert.init_params(cfg, jax.random.PRNGKey(3))
    jh = jbert.init_rerank_head(cfg, jax.random.PRNGKey(4))
    tcfg = tbert.bert_tiny(dtype="float32")
    tp = bert_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    th = rerank_head_from_numpy(jax.tree.map(np.asarray, jh), "cpu")
    return (cfg, jp, jh), (tcfg, tp, th)


@pytest.fixture(scope="module")
def embedders(weights):
    (cfg, jp, _), (tcfg, tp, _) = weights
    return (TPUEmbedder(cfg, jp, batch_size=4, max_length=64),
            GPUEmbedder(tcfg, tp, batch_size=4, max_length=64, device="cpu"))


@pytest.mark.parametrize("call", ["embed_documents", "embed_query", "embed_queries"])
def test_embedder_matches_reference(embedders, call):
    ref, port = embedders
    arg = {"embed_documents": DOCS, "embed_query": QUERIES[0], "embed_queries": QUERIES}[call]
    want, got = getattr(ref, call)(arg), getattr(port, call)(arg)
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    if call != "embed_query":
        assert getattr(port, call)([]) == getattr(ref, call)([]) == []


def test_embedder_batch_padding_invariance(embedders):
    """A text's embedding does not depend on its batch neighbours."""
    _, port = embedders
    solo = np.asarray(port.embed_documents(["the target text"])[0])
    batched = np.asarray(port.embed_documents(["the target text", "other a", "other b", "other c", "overflow"])[0])
    np.testing.assert_allclose(solo, batched, rtol=1e-4, atol=1e-5)
    assert np.linalg.norm(solo) == pytest.approx(1.0, abs=1e-5)


def test_batch_buckets_match_fixed_batch(weights, monkeypatch):
    """Power-of-two batch buckets (floor 4) give the fixed-batch padding's
    vectors; a one-text call runs a batch of 4, not batch_size."""
    _, (tcfg, tp, _) = weights
    bucketed = GPUEmbedder(tcfg, tp, batch_size=8, max_length=64, device="cpu")
    fixed = GPUEmbedder(tcfg, tp, batch_size=8, max_length=64, bucket_batch=False, device="cpu")
    texts = [f"passage number {i} with words" for i in range(5)]
    np.testing.assert_allclose(np.asarray(bucketed.embed_documents(texts)), np.asarray(fixed.embed_documents(texts)),
                               rtol=1e-4, atol=1e-5)
    shapes = []
    real_embed = tbert.embed

    def spy(params, cfg, tokens, mask, normalize=True):
        shapes.append(tuple(tokens.shape))
        return real_embed(params, cfg, tokens, mask, normalize)

    monkeypatch.setattr(tembedder.bert, "embed", spy)
    bucketed.embed_documents(["solo"])
    bucketed.embed_documents(texts)
    fixed.embed_documents(["solo"])
    assert shapes == [(4, 16), (8, 32), (8, 16)]


def test_query_prefix_applied(embedders):
    _, port = embedders
    assert not np.allclose(port.embed_query("hello"), port.embed_documents(["hello"])[0])
    np.testing.assert_allclose(port.embed_query("hello"), port.embed_documents([tembedder.QUERY_PREFIX + "hello"])[0],
                               **TOL)


def test_hash_embedder_equals_reference():
    for dim in (16, 1024):
        ours, ref = HashEmbedder(dim), JHashEmbedder(dim)
        assert ours.embed_documents(DOCS) == ref.embed_documents(DOCS)
        assert ours.embed_query("hello") == ref.embed_query("hello")
        assert ours.embed_queries(QUERIES) == ref.embed_queries(QUERIES)
    assert np.linalg.norm(HashEmbedder(64).embed_query("x")) == pytest.approx(1.0, abs=1e-9)


@pytest.fixture(scope="module")
def rerankers(weights):
    (cfg, jp, jh), (tcfg, tp, th) = weights
    return (TPUReranker(cfg, jp, jh, batch_size=4, max_length=64),
            GPUReranker(tcfg, tp, th, batch_size=4, max_length=64, device="cpu"))


def test_reranker_matches_reference(rerankers):
    ref, port = rerankers
    passages = DOCS + ["a sixth passage that is long enough to be cut at max_length " * 2]
    np.testing.assert_allclose(port.score("what is short", passages), ref.score("what is short", passages), **TOL)
    pairs = [(q, p) for q in QUERIES[:2] for p in DOCS[:3]]
    np.testing.assert_allclose(port.score_pairs(pairs), ref.score_pairs(pairs), **TOL)
    got, want = port.rerank("query", passages, 3), ref.rerank("query", passages, 3)
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], **TOL)
    assert port.score("q", []) == [] and port.score_pairs([]) == []
    # Every forward pads to the fixed batch: 6 passages score as 4 + 2 rows.
    assert port.score("q", passages[:2]) == port.score("q", passages)[:2]


def test_entry_points_default_to_cuda():
    """Without a card, asking for the default device raises (no quiet CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for make in (lambda: GPUEmbedder(tbert.bert_tiny()), lambda: GPUReranker(tbert.bert_tiny())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---------------------------------------------------------------------------
# micro-batcher (the reference's cases; deadlines and traces: test_torch_microbatch.py)


class CountingFn:
    """Batch fn that records every dispatched batch."""

    def __init__(self, delay_s: float = 0.0, fail_on=None):
        self.batches: list[list] = []
        self.delay_s = delay_s
        self.fail_on = fail_on
        self._lock = threading.Lock()

    def __call__(self, items):
        with self._lock:
            self.batches.append(list(items))
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail_on is not None and any(i == self.fail_on for i in items):
            raise ValueError(f"poisoned item {self.fail_on!r}")
        return [i * 2 for i in items]


def _run_threads(fn, args):
    threads = [threading.Thread(target=fn, args=(a,)) for a in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_coalesces_concurrent_callers_into_few_batches():
    mb = MicroBatcher(CountingFn(), max_batch=16, max_wait_ms=200.0)
    try:
        results = {}
        lock = threading.Lock()

        def caller(i):
            r = mb.call(i)
            with lock:
                results[i] = r

        _run_threads(caller, range(16))
        assert results == {i: i * 2 for i in range(16)}
        snap = mb.stats.snapshot()
        assert snap["batches_total"] < 16
        assert snap["requests_total"] == 16 and snap["batch_size_sum"] == 16
        assert snap["queue_wait_ms_sum"] >= 0.0
        assert set(snap) == {"requests_total", "batches_total", "batch_size_sum", "batch_size_max", "bucket_size_sum",
                             "queue_wait_ms_sum", "queue_wait_ms_max", "errors_total"}
    finally:
        mb.close()


def test_max_wait_flushes_a_lone_item():
    mb = MicroBatcher(CountingFn(), max_batch=64, max_wait_ms=30.0)
    try:
        t0 = time.perf_counter()
        assert mb.call("x", timeout=10) == "xx"
        assert time.perf_counter() - t0 < 5.0
        snap = mb.stats.snapshot()
        assert snap["batches_total"] == 1 and snap["batch_size_max"] == 1
    finally:
        mb.close()


def test_max_batch_splits_oversized_bursts():
    fn = CountingFn()
    mb = MicroBatcher(fn, max_batch=4, max_wait_ms=100.0)
    try:
        futs = [mb.submit(i) for i in range(10)]
        assert [f.result(timeout=30) for f in futs] == [i * 2 for i in range(10)]
        assert all(len(b) <= 4 for b in fn.batches)
        assert mb.stats.snapshot()["batch_size_max"] <= 4
    finally:
        mb.close()


def test_per_item_error_isolation():
    mb = MicroBatcher(CountingFn(fail_on="bad"), max_batch=8, max_wait_ms=150.0)
    try:
        futs = {i: mb.submit(i) for i in ("a", "bad", "c")}
        assert futs["a"].result(timeout=30) == "aa"
        assert futs["c"].result(timeout=30) == "cc"
        with pytest.raises(ValueError, match="poisoned"):
            futs["bad"].result(timeout=30)
        assert mb.stats.snapshot()["errors_total"] == 1
    finally:
        mb.close()


def test_result_count_mismatch_is_an_error():
    mb = MicroBatcher(lambda items: items[:-1], max_batch=4, max_wait_ms=5.0)
    try:
        with pytest.raises(RuntimeError, match="returned"):
            mb.call(1, timeout=30)
    finally:
        mb.close()


def test_close_drains_queued_callers_then_refuses_new_work():
    mb = MicroBatcher(CountingFn(delay_s=0.05), max_batch=2, max_wait_ms=500.0)
    futs = [mb.submit(i) for i in range(6)]
    mb.close()
    assert [f.result(timeout=30) for f in futs] == [i * 2 for i in range(6)]
    with pytest.raises(BatcherClosed):
        mb.submit(99)
    mb.close()  # idempotent


def test_worker_crash_fails_queued_callers_and_restarts(monkeypatch):
    """A fault outside the per-item path fails the batch's futures (no
    caller hangs) and a fresh worker serves the next submission."""
    mb = MicroBatcher(CountingFn(), max_batch=4, max_wait_ms=5.0)
    try:
        real = mb.stats.record_batch
        calls = []

        def crash_once(*args):
            calls.append(args)
            if len(calls) == 1:
                raise KeyboardInterrupt("stats fault")
            return real(*args)

        monkeypatch.setattr(mb.stats, "record_batch", crash_once)
        with pytest.raises(RuntimeError, match="crashed"):
            mb.call(1, timeout=30)
        assert mb.call(2, timeout=30) == 4
    finally:
        mb.close()


def test_invalid_construction():
    with pytest.raises(ValueError):
        MicroBatcher(lambda x: x, max_batch=0)
    with pytest.raises(ValueError):
        MicroBatcher(lambda x: x, max_wait_ms=-1.0)


class _RecordingEmbedder:
    dimensions = 4

    def __init__(self):
        self.query_batches: list[list[str]] = []
        self.doc_calls = 0

    def embed_queries(self, texts):
        self.query_batches.append(list(texts))
        return [[float(len(t)), 0.0, 0.0, 0.0] for t in texts]

    def embed_query(self, text):  # pragma: no cover - batched path wins
        return [float(len(text)), 0.0, 0.0, 0.0]

    def embed_documents(self, texts):
        self.doc_calls += 1
        return [[1.0, 0.0, 0.0, 0.0] for _ in texts]


def test_batched_embedder_coalesces_queries_and_passes_docs_through():
    inner = _RecordingEmbedder()
    be = BatchedEmbedder(inner, max_batch=8, max_wait_ms=150.0)
    try:
        out = {}

        def go(q):
            out[q] = be.embed_query(q)

        _run_threads(go, [f"q{i}" * (i + 1) for i in range(6)])
        assert len(out) == 6 and all(v[0] == float(len(q)) for q, v in out.items())
        assert len(inner.query_batches) < 6
        n_before = len(inner.query_batches)
        assert be.embed_queries(["a", "bb"]) == [[1.0, 0.0, 0.0, 0.0], [2.0, 0.0, 0.0, 0.0]]
        assert len(inner.query_batches) == n_before + 1
        assert be.embed_queries([]) == []
        be.embed_documents(["d1", "d2"])
        assert inner.doc_calls == 1 and be.dimensions == 4
    finally:
        be.close()


def test_batched_gpu_embedder_matches_direct_calls(embedders):
    """Concurrent queries through the batcher get the vectors the wrapped
    embedder gives them directly."""
    _, port = embedders
    be = BatchedEmbedder(port, max_batch=4, max_wait_ms=100.0)
    try:
        out = {}

        def go(q):
            out[q] = be.embed_query(q)

        _run_threads(go, QUERIES)
        for q in QUERIES:
            np.testing.assert_allclose(out[q], port.embed_query(q), rtol=1e-4, atol=1e-5)
        assert be.batcher.stats.snapshot()["requests_total"] == len(QUERIES)
    finally:
        be.close()
