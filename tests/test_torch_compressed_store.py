"""The port's compressed scan (``GPUVectorStore(quantization="int8"|"pq")``
in ``retrieval/gpu.py``) against the JAX package's ``TPUVectorStore`` on the
CPU, in float32 and bfloat16.

The helpers first: the numpy int8 and PQ encoders bit for bit, the
device-side int8 quantizer bit for bit, and both Lloyd loops from the same
initial centroids (drawn by ``jax.random.choice`` with the reference's keys
inside the test).  Then both stores take the same clustered corpora (numpy,
from a seed) through the same adds, deletes, appends and compactions, with
the port's k-means seeded as the reference seeds it: ids equal, scores
within 1e-5, and equal ``capacity_stats`` and ``scanned_bytes_per_query``.
On the CPU ``jax.lax.approx_max_k`` returns ``lax.top_k``'s answer, so the
port's exact stage one gives the reference's candidates.  The reference's
recall gates run on the port; snapshots load both ways; the factory and a
collection override build what the reference builds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.chains import factory as jfactory
from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.retrieval import tpu as tpu_mod
from generativeaiexamples_tpu.retrieval.base import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.factory import get_vector_store as jget_vector_store
from generativeaiexamples_tpu.retrieval.tpu import TPUVectorStore
from generativeaiexamples_tpu_torch.chains import factory as tfactory
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.retrieval import gpu as gpu_mod
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.factory import get_vector_store
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

DIM = 64
SCORE_TOL = 1e-5
DTYPES = ["float32", "bfloat16"]
MODES = {"int8": {}, "pq": {"pq_m": 8, "rescore_multiplier": 8}}


def jax_init_rows(n, k, key):
    """The reference's k-means seed rows: ``jax.random.choice`` under
    ``PRNGKey(key)``."""
    return np.array(jax.random.choice(jax.random.PRNGKey(key), n, (k,), replace=n < k))


@pytest.fixture(autouse=True)
def _reference_seeds(monkeypatch):
    monkeypatch.setattr(gpu_mod, "_init_rows", jax_init_rows)


def _clustered(n, seed=0, n_centers=32, n_queries=16):
    """Clustered unit vectors and queries near the centres (the reference's
    ``_clustered_q``)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, DIM)).astype(np.float32) * 3
    vecs = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = centers[rng.integers(0, n_centers, n_queries)] + 0.3 * rng.standard_normal((n_queries, DIM)).astype(
        np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return vecs, queries


class QPair:
    """The JAX store and the port's store, driven alike."""

    def __init__(self, dtype, **kw):
        self.ref = TPUVectorStore(DIM, dtype=dtype, **kw)
        self.port = GPUVectorStore(DIM, dtype=dtype, device="cpu", **kw)

    def add(self, prefix, lo, hi, vecs, source=None):
        texts = [f"{prefix}{i}" for i in range(lo, hi)]
        sources = [source or f"s{i % 3}" for i in range(lo, hi)]
        self.ref.add([JChunk(text=t, source=s, id=t) for t, s in zip(texts, sources)], vecs[lo:hi])
        self.port.add([Chunk(text=t, source=s, id=t) for t, s in zip(texts, sources)], vecs[lo:hi])

    def delete(self, source):
        assert self.ref.delete_source(source) == self.port.delete_source(source)

    def check(self, queries, ks=(10,), singles=2):
        for k in ks:
            got, want = self.port.search_batch(queries, k), self.ref.search_batch(queries, k)
            got += [self.port.search(q, k) for q in queries[:singles]]
            want += [self.ref.search(q, k) for q in queries[:singles]]
            assert [[h.chunk.id for h in r] for r in got] == [[h.chunk.id for h in r] for r in want]
            np.testing.assert_allclose([h.score for r in got for h in r], [h.score for r in want for h in r],
                                       atol=SCORE_TOL, rtol=0)
            assert self.port._quant_ready(k) == self.ref._quant_ready(k)
            assert self.port.scanned_bytes_per_query(k) == self.ref.scanned_bytes_per_query(k)
        assert self.port.capacity_stats() == self.ref.capacity_stats()
        assert len(self.port) == len(self.ref) and self.port.sources() == self.ref.sources()


def test_int8_rows_and_pq_encode_are_the_reference_bits(monkeypatch):
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((3000, DIM)).astype(np.float32)
    mat[:5] = 0.0  # all-zero rows: the epsilon scale, zero codes
    # Values at exactly k + 1/2 scale steps: round half to even.
    mat[5:9, 0] = 127.0
    mat[5:9, 1:5] = np.array([0.5, 1.5, 2.5, -3.5], np.float32)
    for got in (gpu_mod._int8_rows(mat), [t.numpy() for t in gpu_mod._int8_rows_t(torch.from_numpy(mat))]):
        want = tpu_mod._int8_rows(mat)
        assert got[0].dtype == np.int8 and np.array_equal(got[0], want[0])
        assert np.array_equal(got[1].view(np.uint32), want[1].view(np.uint32))
    assert np.array_equal(gpu_mod._int8_rows(mat)[0][5:9, 1:5], [[0, 2, 2, -4]] * 4)
    assert np.float32(gpu_mod._INT8_PAD_SCALE) == tpu_mod._int8_rows(np.zeros((1, 4), np.float32))[1][0]
    books = rng.standard_normal((8, 256, DIM // 8)).astype(np.float32)
    for mod in (gpu_mod, tpu_mod):  # chunks of 700 rows: several chunks, the port's over threads
        monkeypatch.setattr(mod, "_PQ_ENCODE_CHUNK", 700)
    codes = gpu_mod._pq_encode(mat, books)
    assert codes.dtype == np.uint8 and np.array_equal(codes, tpu_mod._pq_encode(mat, books))
    rows = np.random.default_rng(1).permutation(3000)[:2100]
    assert np.array_equal(gpu_mod._pq_encode(mat, books, rows), tpu_mod._pq_encode(mat[rows], books))
    assert np.array_equal(gpu_mod._pq_zero_code(books), tpu_mod._pq_encode(np.zeros((1, DIM), np.float32), books)[0])


def test_lloyd_loops_match_the_reference(monkeypatch):
    """From the same initial centroids: centroids within 1e-5 and the same
    final assignment, for the PQ subspaces' L2 loop, the IVF lists'
    inner-product loop (with padding rows past ``n_valid``), and
    ``_train_pq`` through its subsample."""
    vecs, _ = _clustered(2000)
    sub = np.ascontiguousarray(vecs[:, :8])
    key = 7
    want = np.asarray(tpu_mod._kmeans_l2(jnp.asarray(sub), jax.random.PRNGKey(key), 8))
    t = torch.from_numpy(sub)
    got = gpu_mod._lloyd_l2(t, t[torch.from_numpy(jax_init_rows(2000, 256, key))], 8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    d2 = lambda c: ((sub[:, None, :].astype(np.float64) - c[None].astype(np.float64)) ** 2).sum(-1)  # noqa: E731
    assert np.array_equal(d2(got).argmin(1), d2(want).argmin(1))
    assert np.array_equal(gpu_mod._kmeans_l2(t, key, 8).numpy(), got)

    padded = np.concatenate([vecs[:1500], np.zeros((100, DIM), np.float32)])
    want = np.asarray(tpu_mod._kmeans(jnp.asarray(padded), 16, 10, jax.random.PRNGKey(3), n_valid=1500))
    t = torch.from_numpy(padded)
    got = gpu_mod._lloyd_ip(t, t[torch.from_numpy(jax_init_rows(1500, 16, 3))], 10, n_valid=1500).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.array_equal((vecs[:1500] @ got.T).argmax(1), (vecs[:1500] @ want.T).argmax(1))
    assert np.array_equal(gpu_mod._kmeans(t, 16, 10, 3, n_valid=1500).numpy(), got)

    for mod in (gpu_mod, tpu_mod):
        monkeypatch.setattr(mod, "_PQ_TRAIN_MAX", 1200)
    rows = np.arange(0, 2000, 1)
    got = gpu_mod._train_pq(vecs, rows, 8, 0, torch.device("cpu"))
    np.testing.assert_allclose(got, tpu_mod._train_pq(vecs, 8, seed=0), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_store_through_appends_deletes_and_compaction(dtype, mode):
    """Two-stage search over the compressed main buffer with the full-width
    tail: appends ride the tail, deletes mask stage one and the tail, and a
    tail overflow recompresses (PQ retrains on the live rows)."""
    vecs, queries = _clustered(2800)
    pair = QPair(dtype, quantization=mode, **MODES[mode])
    pair.add("t", 0, 1500, vecs)
    pair.check(queries, ks=(10, 4))
    assert pair.port._q_buf is not None and pair.port._quant_ready(10)
    assert np.array_equal(pair.port._q_buf.numpy(), np.asarray(pair.ref._q_buf))
    if mode == "int8":
        assert np.array_equal(pair.port._q_scale.numpy(), np.asarray(pair.ref._q_scale))
    else:
        np.testing.assert_allclose(pair.port._pq_codebooks_h, pair.ref._pq_codebooks_h, atol=1e-5, rtol=0)
    buf0 = pair.port._device_buf
    pair.add("n", 1500, 1800, vecs, source="new")  # the tail
    pair.check(np.concatenate([queries, vecs[[1600, 1799]]]))
    assert pair.port._device_buf is buf0 and pair.port.capacity_stats()["tail_rows"] == 300
    pair.delete("s1")
    pair.delete("new")
    pair.check(np.concatenate([queries, vecs[[1, 4, 1600]]]))
    for hits in pair.port.search_batch(vecs[[1, 4, 1600]], 10):
        assert all(h.chunk.source not in ("s1", "new") for h in hits)
    pair.add("c", 1800, 2800, vecs)  # past the 2,048-row capacity: a rebuild, recompressed
    pair.check(np.concatenate([queries, vecs[[2500, 7]]]))
    assert pair.port._device_buf is not buf0 and pair.port._base == 2800


@pytest.mark.parametrize("mode", list(MODES))
def test_tiny_store_falls_back_to_exact(mode):
    """At most top_k * rescore_multiplier main rows: stage one is skipped
    and the results are the exact store's."""
    vecs, queries = _clustered(30)
    pair = QPair("float32", quantization=mode, **MODES[mode])
    pair.add("t", 0, 30, vecs)
    exact = GPUVectorStore(DIM, dtype="float32", device="cpu")
    exact.add([Chunk(text=f"t{i}", source="s", id=f"t{i}") for i in range(30)], vecs)
    pair.check(queries[:4], ks=(10,))
    assert not pair.port._quant_ready(10)
    got = [[(h.chunk.id, h.score) for h in pair.port.search(q, 10)] for q in queries[:4]]
    assert got == [[(h.chunk.id, h.score) for h in exact.search(q, 10)] for q in queries[:4]]


@pytest.mark.parametrize("mode,floor", [("int8", 0.95), ("pq", 0.90)])
def test_reference_recall_gates_on_the_port(mode, floor):
    """``tests/test_retrieval.py::TestQuantized``'s gates against the port's
    exact store: int8 >= 0.95, PQ (pq_m 8, rescore_multiplier 8) >= 0.90."""
    vecs, queries = _clustered(3000)
    chunks = [Chunk(id=str(i), text=f"t{i}", source="s") for i in range(3000)]
    exact = GPUVectorStore(DIM, dtype="float32", device="cpu")
    exact.add(chunks, vecs)
    store = GPUVectorStore(DIM, dtype="float32", device="cpu", quantization=mode, **MODES[mode])
    store.add(chunks, vecs)
    store.search(queries[0], 1)
    assert store._quant_ready(10)
    truth = [{h.chunk.id for h in exact.search(q, 10)} for q in queries]
    recall = sum(len({h.chunk.id for h in store.search(q, 10)} & t) for q, t in zip(queries, truth)) / 160
    assert recall >= floor, f"{mode} recall@10 {recall}"


@pytest.mark.parametrize("mode", list(MODES))
def test_planted_ties_rank_in_the_reference_order(mode):
    """Equal rows give equal compressed and exact scores: stage one keeps the
    lower positions where k2 cuts them, stage two ranks by stage-one rank,
    and tail rows come after equal main rows."""
    vecs, _ = _clustered(1300)
    same = vecs[5].copy()
    for i in (17, 40, 41, 300, 999, 1100, 1150):
        vecs[i] = same
    pair = QPair("bfloat16", quantization=mode, **MODES[mode])
    pair.add("t", 0, 1000, vecs)
    pair.check(same[None, :], ks=(2, 4, 10), singles=1)
    assert [h.chunk.id for h in pair.port.search(same, 4)] == ["t5", "t17", "t40", "t41"]
    pair.add("t", 1000, 1300, vecs, source="tail")
    pair.check(same[None, :], ks=(7, 8), singles=1)
    assert [h.chunk.id for h in pair.port.search(same, 8)][-2:] == ["t1100", "t1150"]


def test_query_chunks_pad_to_buckets_under_max_query_batch(monkeypatch):
    vecs, _ = _clustered(1200)
    pair = QPair("float32", quantization="int8", max_query_batch=8)
    pair.add("t", 0, 1200, vecs)
    shapes = []
    stage_one = GPUVectorStore.stage_one

    def spy(snap, Q):
        shapes.append(tuple(Q.shape))
        return stage_one(snap, Q)

    monkeypatch.setattr(GPUVectorStore, "stage_one", staticmethod(spy))
    queries = vecs[np.random.default_rng(1).integers(0, 1200, 21)]
    pair.check(queries, ks=(5,), singles=1)
    shapes.clear()
    pair.port.search_batch(queries, 5)
    pair.port.search(queries[0], 5)
    assert shapes == [(8, DIM), (8, DIM), (8, DIM), (4, DIM)]


def test_constructor_validation_matches_the_reference():
    for kw, match in ((dict(quantization="int4"), "quantization"), (dict(quantization="pq", pq_m=7), "pq_m"),
                      (dict(quantization="int8", rescore_multiplier=0), "rescore_multiplier")):
        with pytest.raises(ValueError, match=match) as ours:
            GPUVectorStore(DIM, device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            TPUVectorStore(DIM, **kw)
        assert str(ours.value) == str(theirs.value)
    store = GPUVectorStore(DIM, device="cpu", quantization="pq", pq_m=8, rescore_multiplier=3, recall_target=0.8)
    assert (store.quantization, store.pq_m, store.rescore_multiplier, store.recall_target) == ("pq", 8, 3, 0.8)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_load_across_packages(direction, mode, tmp_path):
    """A compressed store's snapshot keeps its knobs (``tpu_meta.json``);
    the store loaded by the other package answers as the saver's own
    package loading it does."""
    vecs, queries = _clustered(1500)
    pair = QPair("bfloat16", quantization=mode, recall_target=0.8, **MODES[mode])
    pair.add("t", 0, 1200, vecs)
    pair.port.search(queries[0], 1)
    pair.ref.search(queries[0], 1)
    pair.add("n", 1200, 1500, vecs, source="new")
    pair.delete("s2")
    saver = pair.ref if direction == "jax_to_port" else pair.port
    saver.save(str(tmp_path))
    port, ref = GPUVectorStore.load(str(tmp_path), device="cpu"), TPUVectorStore.load(str(tmp_path))
    assert type(port) is GPUVectorStore and port.version() == ref.version() == saver.version()
    for store in (port, ref):
        assert (store.quantization, store.pq_m, store.rescore_multiplier, store.recall_target) == (
            mode, MODES[mode].get("pq_m", 16), MODES[mode].get("rescore_multiplier", 4), 0.8)
    got, want = port.search_batch(queries, 10), ref.search_batch(queries, 10)
    assert [[h.chunk.id for h in r] for r in got] == [[h.chunk.id for h in r] for r in want]
    np.testing.assert_allclose([h.score for r in got for h in r], [h.score for r in want for h in r],
                               atol=SCORE_TOL, rtol=0)
    assert port._quant_ready(10) and port.capacity_stats() == ref.capacity_stats()


@pytest.fixture
def config(monkeypatch):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", str(DIM))
    for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
        configuration.reset_config_cache()
        factory.reset_factories()
    yield monkeypatch
    for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
        configuration.reset_config_cache()
        factory.reset_factories()


def _knobs(store):
    return (type(store).__name__.replace("TPU", "X").replace("GPU", "X"), store.quantization, store.pq_m,
            store.rescore_multiplier, store.recall_target, store.max_query_batch)


def test_factory_tpu_backend_takes_every_knob_and_override(config):
    """``tpu`` from ``APP_VECTORSTORE_*`` and with a collection's overrides:
    the reference's store type and knobs."""
    for key, value in (("APP_VECTORSTORE_NAME", "tpu"), ("APP_VECTORSTORE_QUANTIZATION", "pq"),
                       ("APP_VECTORSTORE_PQM", "8"), ("APP_VECTORSTORE_RESCOREMULTIPLIER", "6"),
                       ("APP_VECTORSTORE_RECALLTARGET", "0.9"), ("APP_RETRIEVER_BATCHMAXSIZE", "16")):
        config.setenv(key, value)
    tconfiguration.reset_config_cache()
    jconfiguration.reset_config_cache()
    store = get_vector_store(device="cpu")
    assert _knobs(store) == _knobs(jget_vector_store()) == ("XVectorStore", "pq", 8, 6, 0.9, 16)
    assert store.device.type == "cpu"
    for overrides in ({"quantization": "int8"}, {"quantization": "none", "rescore_multiplier": 2},
                      {"pq_m": 4, "recall_target": 0.5}):
        assert _knobs(get_vector_store(device="cpu", overrides=overrides)) == _knobs(
            jget_vector_store(overrides=overrides))
    with pytest.raises(ValueError, match="pq_m"):
        get_vector_store(device="cpu", overrides={"pq_m": 7})


def test_a_collection_with_an_int8_override_matches_the_reference(config):
    config.setenv("APP_VECTORSTORE_NAME", "tpu")
    tconfiguration.reset_config_cache()
    jconfiguration.reset_config_cache()
    tm, jm = tfactory.get_collection_manager(device="cpu"), jfactory.get_collection_manager()
    port, ref = tm.create("tenant-q", quantization="int8"), jm.create("tenant-q", quantization="int8")
    assert isinstance(port, GPUVectorStore) and port.quantization == "int8" and port.device.type == "cpu"
    vecs, queries = _clustered(600)
    for m, C in ((tm, Chunk), (jm, JChunk)):
        m.add("tenant-q", [C(text=f"t{i}", source=f"s{i % 2}", id=f"t{i}") for i in range(600)], vecs)
    got, want = port.search_batch(queries, 5), ref.search_batch(queries, 5)
    assert port._quant_ready(5)
    assert [[h.chunk.id for h in r] for r in got] == [[h.chunk.id for h in r] for r in want]
    np.testing.assert_allclose([h.score for r in got for h in r], [h.score for r in want for h in r],
                               atol=SCORE_TOL, rtol=0)
    assert tm.capacity_by_collection() == jm.capacity_by_collection()
