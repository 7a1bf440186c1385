"""The port's IVF store (``GPUIVFVectorStore`` in ``retrieval/gpu.py``) and the
``tpu-ivf`` / ``auto`` factory backends against the JAX package's
``TPUIVFVectorStore`` on the CPU, in float32 and bfloat16.

The port draws its k-means seed rows with numpy where the reference uses
``jax.random``; these tests seed it with the reference's draw, so both
stores train the same lists.  Both then take the same clustered corpora
(numpy, from a seed) through builds, appends in the tail, masked deletes,
folds and retrains: ids equal, scores within 1e-5.  The bucket ids live on
the host in the port, so its ``capacity_stats`` bytes are the reference's
less nlist x cap x 4.  Snapshots of either package (none, int8 and PQ lists,
nprobe below nlist) load into the other with the same answers, and the
durable store recovers an IVF snapshot.  The factory cases stub both
packages' C++ store to compare ``auto`` on the CPU with its IVF fallback,
then let both build it.
"""

import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.retrieval import native as jnative
from generativeaiexamples_tpu.retrieval.native import NativeVectorStore as JNativeVectorStore
from generativeaiexamples_tpu.retrieval import tpu as tpu_mod
from generativeaiexamples_tpu.retrieval.base import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.factory import get_vector_store as jget_vector_store
from generativeaiexamples_tpu.retrieval.tpu import TPUIVFVectorStore
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.durability.store import DurableVectorStore
from generativeaiexamples_tpu_torch.retrieval import factory as tfactory
from generativeaiexamples_tpu_torch.retrieval import gpu as gpu_mod
from generativeaiexamples_tpu_torch.retrieval import native as tnative
from generativeaiexamples_tpu_torch.retrieval.native import NativeVectorStore as TNativeVectorStore
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUIVFVectorStore, GPUVectorStore

DIM = 64
SCORE_TOL = 1e-5
DTYPES = ["float32", "bfloat16"]
MODES = {"none": {}, "int8": {}, "pq": {"pq_m": 8, "rescore_multiplier": 8}}


def jax_init_rows(n, k, key):
    return np.array(jax.random.choice(jax.random.PRNGKey(key), n, (k,), replace=n < k))


@pytest.fixture(autouse=True)
def _reference_seeds(monkeypatch):
    monkeypatch.setattr(gpu_mod, "_init_rows", jax_init_rows)


def _clustered(n, seed=0, n_centers=32, n_queries=12):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, DIM)).astype(np.float32) * 3
    vecs = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = centers[rng.integers(0, n_centers, n_queries)] + 0.3 * rng.standard_normal((n_queries, DIM)).astype(
        np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return vecs, queries


def _ids(results):
    return [[h.chunk.id for h in r] for r in results]


def _same(got, want):
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose([h.score for r in got for h in r], [h.score for r in want for h in r],
                               atol=SCORE_TOL, rtol=0)


class IPair:
    """The JAX IVF store and the port's, driven alike."""

    def __init__(self, dtype="float32", **kw):
        kw.setdefault("nlist", 16)
        kw.setdefault("nprobe", 4)
        kw.setdefault("min_train_size", 256)
        self.ref = TPUIVFVectorStore(DIM, dtype=dtype, **kw)
        self.port = GPUIVFVectorStore(DIM, dtype=dtype, device="cpu", **kw)

    def add(self, prefix, lo, hi, vecs, source=None):
        ids = [f"{prefix}{i}" for i in range(lo, hi)]
        sources = [source or f"s{i % 3}" for i in range(lo, hi)]
        self.ref.add([JChunk(text=t, source=s, id=t) for t, s in zip(ids, sources)], vecs[lo:hi])
        self.port.add([Chunk(text=t, source=s, id=t) for t, s in zip(ids, sources)], vecs[lo:hi])

    def delete(self, source):
        assert self.ref.delete_source(source) == self.port.delete_source(source)

    def wait(self):
        for store in (self.ref, self.port):
            store.wait_for_maintenance(timeout=60)
            assert not store._maintenance_running()

    def check(self, queries, k=10, singles=1):
        got = self.port.search_batch(queries, k) + [self.port.search(q, k) for q in queries[:singles]]
        want = self.ref.search_batch(queries, k) + [self.ref.search(q, k) for q in queries[:singles]]
        _same(got, want)
        assert self.port.scanned_bytes_per_query(k) == self.ref.scanned_bytes_per_query(k)
        ours, theirs = self.port.capacity_stats(), self.ref.capacity_stats()
        if self.port._buckets is not None:  # the bucket ids stay on the host
            theirs["bytes"] -= self.port.nlist * int(self.port._buckets.shape[1]) * 4
        assert ours == theirs
        assert len(self.port) == len(self.ref) and self.port.sources() == self.ref.sources()

    def same_index(self):
        np.testing.assert_allclose(self.port._centroids_h, np.asarray(self.ref._centroids), atol=1e-5, rtol=0)
        assert np.array_equal(self.port._bids_h, np.asarray(self.ref._bucket_ids))
        assert np.array_equal(self.port._bvalid_h, np.asarray(self.ref._bucket_valid))
        assert (self.port._ivf_base, self.port._ivf_synced) == (self.ref._ivf_base, self.ref._ivf_synced)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_ivf_store_matches_the_reference(dtype, mode):
    """Build, tail appends and masked deletes over the plain, int8 and PQ
    lists: the same index layout, compressed copies and answers."""
    vecs, queries = _clustered(1700)
    pair = IPair(dtype, quantization=mode, **MODES[mode])
    pair.add("t", 0, 1500, vecs)
    pair.check(queries)
    pair.same_index()
    if mode == "int8":
        assert np.array_equal(pair.port._q_buckets.numpy(), np.asarray(pair.ref._q_buckets))
        assert np.array_equal(pair.port._q_bucket_scales.numpy(), np.asarray(pair.ref._q_bucket_scales))
    elif mode == "pq":
        assert np.array_equal(pair.port._q_buckets.numpy(), np.asarray(pair.ref._q_buckets))
    buckets0 = pair.port._buckets
    pair.add("n", 1500, 1700, vecs, source="new")  # frozen-centroid assignment, served from the tail
    pair.check(np.concatenate([queries, vecs[[1550, 1699]]]))
    assert pair.port._buckets is buckets0 and pair.port.capacity_stats()["tail_rows"] == 200
    assert np.array_equal(pair.port._fill, pair.ref._fill)
    pair.delete("s1")
    pair.delete("new")
    pair.check(np.concatenate([queries, vecs[[1, 4, 1550]]]))
    pair.same_index()
    for hits in pair.port.search_batch(vecs[[1, 4, 1550]], 20):
        assert hits and all(h.chunk.source not in ("s1", "new") for h in hits)


def test_probing_every_list_is_exact():
    vecs, queries = _clustered(900)
    pair = IPair("float32", nlist=8, nprobe=8, min_train_size=100)
    pair.add("t", 0, 900, vecs)
    exact = GPUVectorStore(DIM, dtype="float32", device="cpu")
    exact.add([Chunk(text=f"t{i}", source="s", id=f"t{i}") for i in range(900)], vecs)
    pair.check(queries, k=8)
    got = pair.port.search_batch(queries, 8)
    _same(got, exact.search_batch(queries, 8))


@pytest.mark.parametrize("mode", list(MODES))
def test_masked_deletes_and_rebuilds_from_live_rows_only(mode):
    vecs, _ = _clustered(1500)
    store = GPUIVFVectorStore(DIM, dtype="float32", device="cpu", nlist=16, nprobe=16, min_train_size=256,
                              quantization=mode, **MODES[mode])
    store.add([Chunk(text=f"t{i}", source="evict" if i % 3 == 0 else "keep", id=f"t{i}") for i in range(1500)],
              vecs)
    assert store.search(vecs[0], 1)
    held = (store._buckets, store._q_buckets)
    assert store.delete_source("evict") == 500
    hits = store.search_batch(vecs[[0, 3, 6]], 20)
    assert all(hits) and all(h.chunk.source == "keep" for r in hits for h in r)
    assert store._buckets is held[0] and store._q_buckets is held[1]  # masks only
    assert np.array_equal(store._bucket_valid.numpy(), store._bvalid_h) and int(store._bvalid_h.sum()) == 1000
    store._build_inline(retrain=True)  # a retrain clusters the surviving rows only
    assert int(store._bvalid_h.sum()) == 1000 and store._last_train_live == 1000
    assert all(h.chunk.source == "keep" for r in store.search_batch(vecs[[0, 3, 6]], 20) for h in r)


def test_appends_are_searchable_before_a_fold():
    vecs, _ = _clustered(700)
    pair = IPair("float32", nlist=8, nprobe=8, min_train_size=100, retrain_growth=10.0)
    pair.add("t", 0, 500, vecs)
    pair.check(vecs[:2])
    buckets0, base0 = pair.port._buckets, pair.port._ivf_base
    pair.add("new", 500, 600, vecs, source="fresh")
    assert pair.port.search(vecs[550], 1)[0].chunk.id == "new550"
    pair.check(vecs[[550, 3]])
    pair.wait()
    assert pair.port._buckets is buckets0 and pair.port._ivf_base == base0
    pair.delete("fresh")
    pair.check(vecs[[550, 3]], k=30)
    assert all(h.chunk.source != "fresh" for h in pair.port.search(vecs[550], 30))


def test_fold_keeps_frozen_centroids(monkeypatch):
    """A tail past its fold size folds into the buckets in the background:
    the centroids stay, no row is lost, and the swap bumps the version and
    reports one ``index_swap``."""
    for mod in (tpu_mod, gpu_mod):
        monkeypatch.setattr(mod, "_MIN_TAIL", 32)
    vecs, _ = _clustered(600)
    pair = IPair("float32", nlist=8, nprobe=8, min_train_size=100, retrain_growth=50.0)
    pair.add("t", 0, 400, vecs)
    pair.check(vecs[:2])
    c0, v0 = pair.port._centroids.clone(), pair.port.version()
    events = []
    pair.port.add_mutation_listener(lambda event, info: events.append((event, info)))
    pair.add("f", 400, 500, vecs, source="fold")
    assert pair.port.search(vecs[450], 1)[0].chunk.id == "f450"
    assert pair.ref.search(vecs[450], 1)[0].chunk.id == "f450"
    pair.wait()
    assert pair.port._ivf_base == pair.ref._ivf_base == 500
    assert torch.equal(pair.port._centroids, c0) and pair.port.version() > v0
    assert events == [("index_swap", {"rows": 500, "nlist": 8, "trained": False})]
    pair.check(vecs[[0, 250, 420, 499]], k=5)
    pair.same_index()


def test_background_retrain_is_atomic_under_search():
    """Growth past ``retrain_growth`` retrains in the background while more
    readers than cores search (a short switch interval); every search
    answers, and the swapped index is the reference's."""
    vecs, _ = _clustered(900)
    pair = IPair("float32", nlist=8, nprobe=8, min_train_size=100, retrain_growth=1.5)
    pair.add("t", 0, 300, vecs)
    pair.check(vecs[:1])
    assert pair.port._last_train_live == 300
    stop, errors = threading.Event(), []
    switch = sys.getswitchinterval()

    def reader():
        try:
            while not stop.is_set():
                hits = pair.port.search(vecs[5], 3)
                assert hits and hits[0].chunk.id == "t5"
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    sys.setswitchinterval(1e-4)
    readers = [threading.Thread(target=reader) for _ in range((os.cpu_count() or 1) + 2)]
    for t in readers:
        t.start()
    try:
        pair.add("g", 300, 900, vecs, source="grow")
        assert pair.port.search(vecs[700], 1)[0].chunk.id == "g700"
        assert pair.ref.search(vecs[700], 1)[0].chunk.id == "g700"
        pair.wait()
    finally:
        stop.set()
        for t in readers:
            t.join(10)
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in readers) and not errors
    assert pair.port._ivf_base == 900 and pair.port._last_train_live == 900
    pair.check(vecs[[0, 300, 899]], k=5)
    pair.same_index()


def test_skewed_clusters_keep_bucket_memory_bounded():
    """90% of rows in one tight cluster: the capacity stays near 4x the
    mean list, overflow rows spill to their next-nearest list as the
    reference spills them, and every row is still found."""
    rng = np.random.default_rng(3)
    tight = rng.standard_normal(DIM).astype(np.float32) * 3
    base = np.where(np.arange(1000)[:, None] < 900, tight, rng.standard_normal((1000, DIM)) * 3)
    vecs = (base + rng.standard_normal((1000, DIM)) * 0.1).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    pair = IPair("float32", nlist=16, nprobe=16, min_train_size=100)
    pair.add("t", 0, 1000, vecs)
    pair.check(vecs[[5, 450, 899, 950]], k=1)
    pair.same_index()
    nlist, cap, _ = pair.port._buckets.shape
    assert nlist * cap <= 8 * 1000
    for row in (5, 450, 899, 950):
        assert pair.port.search(vecs[row], 1)[0].chunk.id == f"t{row}"


def test_query_chunks_follow_the_reference_budget_under_max_query_batch(monkeypatch):
    vecs, _ = _clustered(1200)
    pair = IPair("float32", nlist=16, nprobe=16, min_train_size=500, max_query_batch=4)
    pair.add("t", 0, 1200, vecs)
    queries = vecs[np.random.default_rng(1).integers(0, 1200, 10)]
    pair.check(queries, k=5)
    widths = []
    list_scores = GPUIVFVectorStore.list_scores

    def spy(snap, Q, probe, compressed):
        widths.append(len(probe))
        return list_scores(snap, Q, probe, compressed)

    monkeypatch.setattr(GPUIVFVectorStore, "list_scores", staticmethod(spy))
    pair.port.search_batch(queries, 5)
    assert widths == [4, 4, 2]
    snap = pair.port._prepared()
    monkeypatch.setattr(gpu_mod, "_IVF_CHUNK_BYTES", 16 * int(snap.buckets.shape[1]) * DIM * 4 * 2)
    assert pair.port.query_chunk(snap, 5) == 2  # the 2 GiB budget's rule, at a small budget


def test_planted_ties_rank_in_the_reference_order():
    """Equal rows sit in one list at consecutive slots; equal scores rank by
    probe order and slot, then the tail."""
    vecs, _ = _clustered(1100)
    same = vecs[5].copy()
    for i in (17, 40, 300, 999, 1020, 1050):
        vecs[i] = same
    pair = IPair("bfloat16", nlist=8, nprobe=2, min_train_size=100, retrain_growth=10.0)
    pair.add("t", 0, 1000, vecs)
    pair.check(same[None, :], k=3)
    assert [h.chunk.id for h in pair.port.search(same, 3)] == ["t5", "t17", "t40"]
    pair.add("t", 1000, 1100, vecs, source="tail")
    pair.check(same[None, :], k=7)
    assert [h.chunk.id for h in pair.port.search(same, 7)][-2:] == ["t1020", "t1050"]


def test_reference_recall_gate_on_the_port():
    """``tests/test_retrieval.py::test_tpu_ivf_recall`` on the port: nlist 64,
    nprobe 16, recall@10 >= 0.9 against the exact store."""
    vecs, queries = _clustered(3000, n_queries=20)
    chunks = [Chunk(text=f"t{i}", source="s") for i in range(3000)]
    exact = GPUVectorStore(DIM, dtype="float32", device="cpu")
    ivf = GPUIVFVectorStore(DIM, dtype="float32", device="cpu", nlist=64, nprobe=16, min_train_size=1000)
    for store in (exact, ivf):
        store.add(chunks, vecs)
    qs = vecs[np.random.default_rng(2).integers(0, 3000, 20)]
    got, want = ivf.search_batch(qs, 10), exact.search_batch(qs, 10)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(_ids(got), _ids(want))])
    assert ivf._centroids is not None and recall >= 0.9, recall


def test_exact_regime_below_min_train_size():
    vecs, queries = _clustered(300)
    pair = IPair("float32", min_train_size=5000)
    pair.add("t", 0, 300, vecs)
    pair.check(queries, k=10, singles=3)
    assert pair.port._centroids is None
    exact = GPUVectorStore(DIM, dtype="float32", device="cpu")
    exact.add([Chunk(text=f"t{i}", source="s", id=f"t{i}") for i in range(300)], vecs)
    _same(pair.port.search_batch(queries, 10), exact.search_batch(queries, 10))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_load_across_packages(direction, mode, tmp_path):
    """``ivf_index.npz`` (centroids, row-to-list layout, PQ codebooks) and
    the IVF meta load without k-means: the loaded store answers as the
    saver (nprobe below nlist, rows in the tail, a deleted source)."""
    vecs, queries = _clustered(1400)
    pair = IPair("bfloat16", nlist=16, nprobe=4, quantization=mode, retrain_growth=5.0, **MODES[mode])
    pair.add("t", 0, 1200, vecs)
    pair.check(queries[:2])
    pair.add("n", 1200, 1400, vecs, source="new")  # still in the tail when saved
    pair.delete("s2")
    saver = pair.ref if direction == "jax_to_port" else pair.port
    saver.save(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["chunks.json", "ivf_index.npz", "tpu_meta.json", "vectors.npz"]
    loaded = (GPUVectorStore.load(str(tmp_path), device="cpu") if direction == "jax_to_port"
              else TPUIVFVectorStore.load(str(tmp_path)))
    if direction == "jax_to_port":
        assert type(loaded) is GPUIVFVectorStore and loaded._centroids is not None and not loaded._dirty
        assert (loaded.nlist, loaded.nprobe, loaded.quantization, loaded.retrain_growth) == (16, 4, mode, 5.0)
        assert loaded._last_train_live == pair.ref._last_train_live
    # Installing the loaded index is a swap: one version past the saver's, in both packages.
    assert len(loaded) == len(saver) and loaded.version() == saver.version() + 1
    _same(loaded.search_batch(queries, 10), saver.search_batch(queries, 10))


def test_durable_store_recovers_an_ivf_snapshot(tmp_path):
    """A durable IVF store: a snapshot (with its index), a WAL tail, a crash;
    recovery through ``GPUVectorStore.load`` brings back the IVF store with
    the same answers, even when the wrapped store was built exact."""
    vecs, queries = _clustered(900)
    store = DurableVectorStore(GPUIVFVectorStore(DIM, device="cpu", nlist=8, nprobe=2, min_train_size=100),
                               str(tmp_path), fsync_every=0, snapshot_every_records=0)
    store.add([Chunk(text=f"t{i}", source=f"s{i % 2}", id=f"t{i}") for i in range(800)], vecs[:800])
    store.search(vecs[0], 1)
    store.snapshot()
    store.add([Chunk(text=f"n{i}", source="new", id=f"n{i}") for i in range(800, 900)], vecs[800:])
    store.delete_source("s1")
    store.flush()
    before = store.search_batch(queries, 10)
    for inner in (GPUIVFVectorStore(DIM, device="cpu", nlist=8, nprobe=2, min_train_size=100),
                  GPUVectorStore(DIM, device="cpu")):
        recovered = DurableVectorStore(inner, str(tmp_path), fsync_every=0, snapshot_every_records=0)
        assert recovered.last_recovery["snapshot_restored"] and recovered.last_recovery["replayed_records"] == 2
        assert isinstance(recovered.inner, GPUIVFVectorStore) and recovered.inner._centroids is not None
        assert len(recovered) == len(store) == 500
        _same(recovered.search_batch(queries, 10), before)
        recovered.close()
    store.close()


@pytest.fixture
def config(monkeypatch):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", str(DIM))

    class NoNativeLibrary:  # both packages' ``auto`` without their C++ store
        def __init__(self, *a, **k):
            raise OSError("no native library")

    monkeypatch.setattr(jnative, "NativeVectorStore", NoNativeLibrary)
    monkeypatch.setattr(tnative, "NativeVectorStore", NoNativeLibrary)
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    yield monkeypatch
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()


def _built(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    port, ref = tfactory.get_vector_store(device="cpu"), jget_vector_store()
    knobs = ("nlist", "nprobe", "min_train_size", "retrain_growth", "max_query_batch", "quantization", "pq_m",
             "rescore_multiplier", "recall_target")
    return port, ref, [getattr(port, k) for k in knobs], [getattr(ref, k) for k in knobs]


@pytest.mark.parametrize("env,min_train", [
    ({"APP_VECTORSTORE_NAME": "tpu-ivf"}, 256),
    ({"APP_VECTORSTORE_NAME": "tpu-ivf", "APP_VECTORSTORE_NLIST": "32", "APP_VECTORSTORE_NPROBE": "8",
      "APP_VECTORSTORE_RETRAINGROWTH": "3.0", "APP_VECTORSTORE_QUANTIZATION": "int8"}, 128),
    ({"APP_VECTORSTORE_NAME": "auto"}, 6_000),
    ({"APP_VECTORSTORE_NAME": "auto", "APP_EMBEDDINGS_DIMENSIONS": "1024"}, 16_000),
    ({"APP_VECTORSTORE_NAME": "auto", "GAIE_RETRIEVAL_CROSSOVER": "123000", "APP_VECTORSTORE_QUANTIZATION": "pq"},
     123_000),
], ids=["tpu-ivf", "tpu-ivf-knobs", "auto-narrow", "auto-wide", "auto-pinned"])
def test_factory_ivf_and_auto_backends_match_the_reference(config, env, min_train):
    """``tpu-ivf`` and ``auto`` (on the CPU: the IVF store with the CPU
    crossover as its training floor, as the reference without its native
    library) from ``APP_*``: the reference's store type and knobs."""
    port, ref, ours, theirs = _built(config, env)
    assert type(port) is GPUIVFVectorStore and type(ref) is TPUIVFVectorStore
    assert ours == theirs and port.device.type == "cpu" and port.min_train_size == min_train


@pytest.mark.parametrize("env,threshold", [
    ({"APP_VECTORSTORE_NAME": "auto"}, 6_000),
    ({"APP_VECTORSTORE_NAME": "auto", "APP_EMBEDDINGS_DIMENSIONS": "1024"}, 16_000),
    ({"APP_VECTORSTORE_NAME": "auto", "GAIE_RETRIEVAL_CROSSOVER": "123000", "APP_VECTORSTORE_NLIST": "32"}, 123_000),
], ids=["auto-narrow", "auto-wide", "auto-pinned"])
def test_auto_on_the_cpu_builds_the_native_store_when_both_packages_can(config, env, threshold):
    """With their C++ libraries, both packages' ``auto`` on the CPU build the
    native IVF store with the crossover as its build threshold; the port's
    ``tpu-ivf`` stays the IVF store."""
    config.setattr(jnative, "NativeVectorStore", JNativeVectorStore)
    config.setattr(tnative, "NativeVectorStore", TNativeVectorStore)
    for key, value in env.items():
        config.setenv(key, value)
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    port, ref = tfactory.get_vector_store(device="cpu"), jget_vector_store()
    assert type(port) is TNativeVectorStore and type(ref) is JNativeVectorStore
    knobs = ("index_type", "nlist", "nprobe", "ivf_build_threshold")
    assert [getattr(port, k) for k in knobs] == [getattr(ref, k) for k in knobs]
    assert port.index_type == "ivf" and port.ivf_build_threshold == threshold
    config.setenv("APP_VECTORSTORE_NAME", "tpu-ivf")
    tconfiguration.reset_config_cache()
    assert type(tfactory.get_vector_store(device="cpu")) is GPUIVFVectorStore


@pytest.mark.parametrize("value", ["abc", "0", "-5"])
def test_crossover_pin_is_validated_like_the_reference(config, value):
    from generativeaiexamples_tpu.retrieval.factory import crossover_rows as jcrossover_rows

    config.setenv("GAIE_RETRIEVAL_CROSSOVER", value)
    with pytest.raises(ValueError, match="GAIE_RETRIEVAL_CROSSOVER") as ours:
        tfactory.crossover_rows(64, "cuda")
    with pytest.raises(ValueError) as theirs:
        jcrossover_rows(64, "cpu")
    assert str(ours.value) == str(theirs.value)
    config.delenv("GAIE_RETRIEVAL_CROSSOVER")
    assert tfactory.crossover_rows(1024, "cuda") == 1 << 25 and tfactory.crossover_rows(384, "cuda") == 1 << 26


def test_a_cuda_store_without_a_card_raises(config):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPUIVFVectorStore(DIM)
    config.setenv("APP_VECTORSTORE_NAME", "auto")
    tconfiguration.reset_config_cache()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfactory.get_vector_store()
