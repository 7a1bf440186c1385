"""The port's sharded fabric (``retrieval/fabric/{sharded,coldtier}.py``)
against the JAX package's on the CPU, on the same seeded numpy corpora.

Routing and ``shard_k`` equal; the exact fabric's merge equal to the JAX
fabric's bit for bit (numpy children) and to a single ``GPUVectorStore``'s
bit for bit (CPU ``tpu`` children; numpy sums a shard's rows in another
order than a whole corpus's, so numpy children meet a single numpy store
within the reference's 1e-6), quantized children against the reference's
quantized fabric;
the cold tier's codebooks, codes and scans bit for bit; the EWMA
rebalance under one query stream; the stats, byte split and ``/metrics``
lines; snapshots written by one package and loaded by the other; replica
hydration; the factory's fabric and its nested-fabric refusal; the durable
restore (R1: the reference's comes back on numpy children, the port's on
the configured children on the store's device); demotion dropping the
child; and the engine server's pool hydrating the fabric on scale-up.
"""

import gc
import os
import threading
import weakref

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.durability.store import DurableVectorStore as JDurable
from generativeaiexamples_tpu.retrieval.base import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.fabric import ShardedVectorStore as JFabric
from generativeaiexamples_tpu.retrieval.fabric import coldtier as jcold
from generativeaiexamples_tpu.retrieval.fabric.metrics import fabric_metrics_lines as jmetrics_lines
from generativeaiexamples_tpu.retrieval.factory import get_vector_store as jget_vector_store
from generativeaiexamples_tpu.retrieval.memory import MemoryVectorStore as JMemory
from generativeaiexamples_tpu.retrieval.tpu import TPUVectorStore
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.durability.store import DurableVectorStore
from generativeaiexamples_tpu_torch.retrieval import gpu as gpu_mod
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.fabric import ColdPartition, HostPrefetcher, ShardedVectorStore
from generativeaiexamples_tpu_torch.retrieval.fabric import coldtier as tcold
from generativeaiexamples_tpu_torch.retrieval.fabric.metrics import fabric_metrics_lines
from generativeaiexamples_tpu_torch.retrieval.factory import get_vector_store
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore
from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore

DIM = 32
SCORE_TOL = 1e-5
WAIT = 2.0  # fan-out batcher wait (ms): small, so tier-1 stays light


def _corpus(n, seed=0, n_sources=7, dim=DIM):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    return vecs


def _chunks(cls, n, n_sources=7):
    return [cls(text=f"t{i}", source=f"s{i % n_sources}", id=f"c{i}") for i in range(n)]


def _hits(results):
    return [[(h.chunk.id, h.score) for h in hits] for hits in results]


def _ids(results):
    return [[h.chunk.id for h in hits] for hits in results]


class Pair:
    """The JAX fabric and the port's, built alike and driven alike."""

    def __init__(self, jfactory=None, tfactory=None, **kw):
        kw.setdefault("fanout_wait_ms", WAIT)
        self.ref = JFabric(DIM, shard_factory=jfactory, **kw)
        # The reference's children default to numpy stores, the port's to
        # GPUVectorStore: name the port's numpy children where it compares.
        self.port = ShardedVectorStore(DIM, shard_factory=tfactory or (lambda i: MemoryVectorStore(DIM)),
                                       device="cpu", **kw)

    def add(self, vecs, lo=0):
        n = len(vecs)
        self.ref.add(_chunks(JChunk, lo + n)[lo:], vecs)
        self.port.add(_chunks(Chunk, lo + n)[lo:], vecs)

    def search(self, Q, k):
        return self.ref.search_batch(Q.tolist(), k), self.port.search_batch(Q, k)

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.fixture
def pair_factory():
    made = []

    def make(**kw):
        made.append(Pair(**kw))
        return made[-1]

    yield make
    for p in made:
        p.close()


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("shards,mult,margin", [(1, 4, 8), (3, 4, 8), (4, 1, 0), (8, 4, 8), (5, 7, 2)])
def test_routes_and_shard_k_equal_the_reference(pair_factory, shards, mult, margin):
    p = pair_factory(num_shards=shards, rescore_multiplier=mult, margin=margin)
    ids = [f"c{i}" for i in range(300)] + ["", "é-ü", "doc7-chunk-12"]
    assert [p.port.route(i) for i in ids] == [p.ref.route(i) for i in ids]
    assert [p.port.shard_k(k) for k in range(1, 70)] == [p.ref.shard_k(k) for k in range(1, 70)]
    assert [p.port.shards_for_replica(r, t) for r in range(4) for t in range(1, 4)] == \
        [p.ref.shards_for_replica(r, t) for r in range(4) for t in range(1, 4)]


# -- merge --------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_exact_fabric_equals_the_reference_and_a_single_store_bit_for_bit(pair_factory, shards):
    vecs = _corpus(300, seed=1)
    p = pair_factory(num_shards=shards)
    p.add(vecs)
    single = MemoryVectorStore(DIM)
    single.add(_chunks(Chunk, 300), vecs)
    Q = vecs[::17][:12]
    for step in ("all", "deleted"):
        if step == "deleted":
            assert p.port.delete_source("s3") == p.ref.delete_source("s3") == single.delete_source("s3") > 0
            assert len(p.port) == len(p.ref) == len(single) and p.port.sources() == p.ref.sources()
        ref, port = p.search(Q, 10)
        assert _hits(port) == _hits(ref)
        # numpy's product over a shard's rows may sum in another order than
        # over the single store's: ids, and scores within the reference's
        # own bound (1e-6).
        want = [single.search(q, 10) for q in Q]
        assert _ids(port) == _ids(want)
        np.testing.assert_allclose([s for r in _hits(port) for _, s in r], [s for r in _hits(want) for _, s in r],
                                   atol=1e-6, rtol=0)
    assert _hits([p.port.search(Q[0], 5)]) == _hits([p.ref.search(Q[0].tolist(), 5)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tpu_children_merge_equals_a_single_store_bit_for_bit(pair_factory, dtype):
    """CPU ``tpu`` children: the fabric equals one ``GPUVectorStore`` over
    the same rows bit for bit, with fresh tail rows and a delete, and the
    reference's fabric of ``TPUVectorStore`` children in ids and within
    ``SCORE_TOL`` (XLA's and torch's sum orders differ)."""
    vecs = _corpus(400, seed=4)
    p = pair_factory(num_shards=3, jfactory=lambda i: TPUVectorStore(DIM, dtype=dtype),
                     tfactory=lambda i: GPUVectorStore(DIM, dtype=dtype, device="cpu"))
    single = GPUVectorStore(DIM, dtype=dtype, device="cpu")
    p.add(vecs[:300])
    single.add(_chunks(Chunk, 300), vecs[:300])
    Q = vecs[::23][:12]
    p.search(Q, 5)
    p.add(vecs[300:], lo=300)  # lands in the children's tails
    single.add(_chunks(Chunk, 400)[300:], vecs[300:])
    for source in ("s2", None):
        if source:
            p.port.delete_source(source), p.ref.delete_source(source), single.delete_source(source)
        ref, port = p.search(Q, 10)
        assert _hits(port) == _hits(single.search_batch(Q, 10))
        assert _ids(port) == _ids(ref)
        np.testing.assert_allclose([h[1] for r in _hits(port) for h in r], [h[1] for r in _hits(ref) for h in r],
                                   atol=SCORE_TOL, rtol=0)
    single_fb = single.search_fallback(Q, 10)
    assert _ids(p.port.search_fallback(Q, 10)) == _ids(single_fb)


@pytest.mark.parametrize("quant", ["int8", "pq"])
def test_quantized_children_match_the_reference_quantized_fabric(pair_factory, quant, monkeypatch):
    monkeypatch.setattr(gpu_mod, "_init_rows", lambda n, k, key: np.array(
        jax.random.choice(jax.random.PRNGKey(key), n, (k,), replace=n < k)))
    kw = dict(quantization=quant, rescore_multiplier=64, **({"pq_m": 8} if quant == "pq" else {}))
    vecs = _corpus(600, seed=2)
    p = pair_factory(num_shards=3, rescore_multiplier=8,
                     jfactory=lambda i: TPUVectorStore(DIM, dtype="float32", **kw),
                     tfactory=lambda i: GPUVectorStore(DIM, dtype="float32", device="cpu", **kw))
    p.add(vecs)
    single = MemoryVectorStore(DIM)
    single.add(_chunks(Chunk, 600), vecs)
    Q = vecs[::31][:8]
    ref, port = p.search(Q, 5)
    assert _ids(port) == _ids(ref) == _ids([single.search(q, 5) for q in Q])
    np.testing.assert_allclose([s for r in _hits(port) for _, s in r], [s for r in _hits(ref) for _, s in r],
                               atol=SCORE_TOL, rtol=0)


def test_concurrent_callers_get_their_alone_results(pair_factory):
    vecs = _corpus(400, seed=5)
    p = pair_factory(num_shards=4, fanout_wait_ms=20.0)
    p.add(vecs)
    Q = vecs[:32]
    alone = [_hits([p.port.search(q, 8)])[0] for q in Q]
    got = [None] * 8

    def call(i):
        got[i] = _hits(p.port.search_batch(Q[i * 4 : i * 4 + 4], 8))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert [h for g in got for h in g] == alone
    snap = p.port.stats_snapshot()
    assert snap["requests_total"] == 4 * (32 + 8) and snap["errors_total"] == 0


# -- cold tier ------------------------------------------------------------------


@pytest.mark.parametrize("n,pq_m", [(150, 8), (600, 4), (40, 8)])
def test_cold_partition_codebooks_codes_and_scans_equal_the_reference(n, pq_m):
    vecs = _corpus(n, seed=6)
    theirs = jcold.ColdPartition.from_rows(_chunks(JChunk, n), vecs, pq_m=pq_m, seed=3)
    ours = ColdPartition.from_rows(_chunks(Chunk, n), vecs, pq_m=pq_m, seed=3)
    assert ours.codebooks.tobytes() == theirs.codebooks.tobytes()
    assert ours.codes.tobytes() == theirs.codes.tobytes()
    assert ours.host_bytes() == theirs.host_bytes() and ours.scan_bytes(10, 40) == theirs.scan_bytes(10, 40)
    assert ours.delete_source("s1") == theirs.delete_source("s1")
    assert ours.sources() == theirs.sources() and ours.rows() == theirs.rows()
    ref_pf, port_pf = jcold.HostPrefetcher(), HostPrefetcher("cpu")
    for q in vecs[:6]:
        for k, rk in ((5, 20), (10, 10), (3, n)):
            assert ours.scan(q, k, rk, port_pf) == theirs.scan(q.tolist(), k, rk, ref_pf)
            assert ours.scan(q, k, rk) == theirs.scan(q.tolist(), k, rk)
    assert (port_pf.prefetches_total, port_pf.prefetch_bytes_total) == (ref_pf.prefetches_total,
                                                                        ref_pf.prefetch_bytes_total)
    # The numpy helpers themselves, with a train cap below the rows.
    np.testing.assert_array_equal(tcold.train_codebooks(vecs, pq_m, seed=9, train_cap=n // 2),
                                  jcold.train_codebooks(vecs, pq_m, seed=9, train_cap=n // 2))


def test_cold_tier_searches_deletes_and_promotes_as_the_reference(pair_factory):
    vecs = _corpus(240, seed=3)
    p = pair_factory(num_shards=3, pq_m=8, rescore_multiplier=8)
    p.add(vecs)
    for fab in (p.ref, p.port):
        assert fab.demote_shard(0) and fab.demote_shard(2) and not fab.demote_shard(2)
    assert p.port.cold_shards() == p.ref.cold_shards() == [0, 2]
    assert p.port.shard_devices() == ["cold", "cpu", "cold"]
    Q = vecs[::29][:8]
    ref, port = p.search(Q, 6)
    assert _hits(port) == _hits(ref)
    assert p.port.delete_source("s1") == p.ref.delete_source("s1") > 0
    assert len(p.port) == len(p.ref) and sorted(p.port.sources()) == sorted(p.ref.sources())
    ref, port = p.search(Q, 6)
    assert _hits(port) == _hits(ref) and all(h.chunk.source != "s1" for r in port for h in r)
    # The fallback rung: the port takes a batch, each query the reference's.
    assert _hits(p.port.search_fallback(Q, 6)) == _hits([p.ref.search_fallback(q.tolist(), 6) for q in Q])
    # A write to a cold shard promotes it first.
    extra = _corpus(12, seed=30)
    p.add(extra, lo=240)
    assert p.port.cold_shards() == p.ref.cold_shards()
    p.port.promote_shard(0), p.ref.promote_shard(0)
    ref, port = p.search(Q, 6)
    assert _hits(port) == _hits(ref)
    assert p.port.capacity_stats() == p.ref.capacity_stats()
    assert p.port.scanned_bytes_split(10) == p.ref.scanned_bytes_split(10)
    ours, theirs = p.port.stats_snapshot(), p.ref.stats_snapshot()
    assert ours == {k: theirs[k] for k in ours}
    assert p.port.version() == p.ref.version()
    swaps = p.port.swap_stats()
    assert (swaps["demotions"], swaps["promotions"]) == (2, theirs["coldtier_promotions_total"])


def test_ewma_rebalance_swaps_the_same_shards_under_one_query_stream(pair_factory):
    vecs = _corpus(300, seed=8)
    p = pair_factory(num_shards=4, hot_shard_budget=2, pq_m=8, ewma_alpha=0.5, rescore_multiplier=8)
    p.add(vecs)
    assert p.port.rebalance() == p.ref.rebalance()
    # Queries drawn near shard 1's and then shard 3's rows pull those hot.
    owners = [p.port.route(f"c{i}") for i in range(300)]
    trace = []
    for target in (1, 3, 0, 2):
        rows = [i for i, s in enumerate(owners) if s == target][:6]
        for i in rows:
            ref, port = p.search(vecs[i : i + 1], 4)
            assert _hits(port) == _hits(ref)
            trace.append((p.port.hot_shards(), p.ref.hot_shards(), p.port.cold_shards(), p.ref.cold_shards()))
    assert all(a == b and c == d for a, b, c, d in trace)
    assert len({tuple(t[0]) for t in trace}) > 1  # the hot set moved
    ours, theirs = p.port.stats_snapshot(), p.ref.stats_snapshot()
    assert ours == {k: theirs[k] for k in ours} and theirs["coldtier_promotions_total"] > 0
    assert [s.ewma for s in p.port._shards] == [s.ewma for s in p.ref._shards]


def test_demotion_drops_the_child_store(pair_factory):
    """Once demoted, nothing holds the child (its device buffers on a card):
    not the batcher's closure, not the fabric."""
    vecs = _corpus(120, seed=12)
    p = pair_factory(num_shards=2, pq_m=8, tfactory=lambda i: GPUVectorStore(DIM, device="cpu"))
    p.add(vecs)
    p.port.search_batch(vecs[:4], 3)
    child = weakref.ref(p.port._shards[1].store)
    assert p.port.demote_shard(1)
    gc.collect()
    assert child() is None


def test_stats_byte_split_and_metrics_lines_equal_the_reference(pair_factory, tmp_path):
    vecs = _corpus(400, seed=7)
    p = pair_factory(num_shards=4, pq_m=8, jfactory=lambda i: TPUVectorStore(DIM, dtype="float32"),
                     tfactory=lambda i: GPUVectorStore(DIM, dtype="float32", device="cpu"))
    p.add(vecs)
    for q in vecs[:5]:
        p.search(q[None, :], 10)
    p.port.demote_shard(1), p.ref.demote_shard(1)
    p.search(vecs[5:9], 7)
    assert p.port.capacity_stats() == p.ref.capacity_stats()
    assert p.port.scanned_bytes_split(10) == p.ref.scanned_bytes_split(10)
    assert p.port.scanned_bytes_per_query(4) == p.ref.scanned_bytes_per_query(4)
    ours, theirs = p.port.stats_snapshot(), p.ref.stats_snapshot()
    assert ours == {k: theirs[k] for k in ours}
    assert fabric_metrics_lines(p.port) == jmetrics_lines(p.ref)
    # Behind a durability shell too (the servers' peeked singleton).
    shell = DurableVectorStore(p.port, str(tmp_path / "d"), fsync_every=0, snapshot_every_records=0)
    assert fabric_metrics_lines(shell) == jmetrics_lines(p.ref)
    shell.close()


# -- persistence and replicas -----------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_snapshots_load_across_packages(pair_factory, tmp_path, writer):
    vecs = _corpus(180, seed=10)
    p = pair_factory(num_shards=3, pq_m=8, rescore_multiplier=8)
    p.add(vecs)
    p.port.delete_source("s4"), p.ref.delete_source("s4")
    p.port.demote_shard(2), p.ref.demote_shard(2)
    Q = vecs[::13][:6]
    want = _hits(p.port.search_batch(Q, 5))
    src = p.port if writer == "port" else p.ref
    src.save(str(tmp_path / "fab"))
    ref = JFabric.load(str(tmp_path / "fab"), fanout_wait_ms=WAIT)
    port = ShardedVectorStore.load(str(tmp_path / "fab"), device="cpu", fanout_wait_ms=WAIT,
                                   shard_factory=lambda i: MemoryVectorStore(DIM))
    on_tpu = ShardedVectorStore.load(str(tmp_path / "fab"), device="cpu", fanout_wait_ms=WAIT,
                                     shard_factory=lambda i: GPUVectorStore(DIM, dtype="float32", device="cpu"))
    try:
        for fab in (ref, port, on_tpu):
            assert len(fab) == len(src) and fab.cold_shards() == [2] and fab.version() == src.version()
        assert _hits(port.search_batch(Q, 5)) == _hits(ref.search_batch(Q.tolist(), 5)) == want
        assert isinstance(on_tpu._shards[0].store, GPUVectorStore) and _ids(on_tpu.search_batch(Q, 5)) == \
            [[i for i, _ in r] for r in want]
    finally:
        for fab in (ref, port, on_tpu):
            fab.close()


@pytest.mark.parametrize("how", ["built", "loaded"])
def test_default_children_are_gpu_stores_on_the_fabric_device(tmp_path, how):
    """With no ``shard_factory`` (the constructor, and ``load`` of a snapshot)
    the port's children are ``GPUVectorStore``s on the fabric's device, and
    their exact merge equals one such store's; the reference's default
    children are numpy stores."""
    vecs = _corpus(120, seed=17)
    Q = vecs[::11][:5]
    fab = ShardedVectorStore(DIM, num_shards=3, device="cpu", fanout_wait_ms=WAIT)
    fab.add(_chunks(Chunk, 120), vecs)
    if how == "loaded":
        fab.save(str(tmp_path / "fab"))
        fab.close()
        fab = ShardedVectorStore.load(str(tmp_path / "fab"), device="cpu", fanout_wait_ms=WAIT)
    ref = JFabric(DIM, num_shards=3, fanout_wait_ms=WAIT)
    single = GPUVectorStore(DIM, device="cpu")
    single.add(_chunks(Chunk, 120), vecs)
    try:
        assert all(type(s.store) is GPUVectorStore and s.store.device.type == "cpu" for s in fab._shards)
        assert {type(s.store) for s in ref._shards} == {JMemory}
        assert _hits(fab.search_batch(Q, 5)) == _hits(single.search_batch(Q, 5))
    finally:
        fab.close()
        ref.close()


def test_hydrate_replica_warms_the_same_shards(pair_factory):
    vecs = _corpus(160, seed=11)
    p = pair_factory(num_shards=4, pq_m=8, jfactory=lambda i: TPUVectorStore(DIM, dtype="float32"),
                     tfactory=lambda i: GPUVectorStore(DIM, dtype="float32", device="cpu"))
    p.add(vecs)
    p.port.demote_shard(3), p.ref.demote_shard(3)
    for args in ((1, 2), (0, 2), (2, 3), (0, 1)):
        assert p.port.hydrate_replica(*args) == p.ref.hydrate_replica(*args)
    assert p.port.stats_snapshot()["replica_hydrations_total"] == 4
    assert p.port._shards[1].store._device_buf is not None and not p.port._shards[1].store._dirty


# -- factory, durability, servers ---------------------------------------------------


@pytest.fixture
def config(monkeypatch):
    from generativeaiexamples_tpu.chains import factory as jfactory
    from generativeaiexamples_tpu_torch.chains import factory as tfactory

    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", str(DIM))
    monkeypatch.setenv("APP_FABRIC_FANOUTWAITMS", str(WAIT))
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    yield monkeypatch
    tfactory.reset_factories()
    jfactory.reset_factories()
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()


def _env(monkeypatch, **env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()


KNOBS = ("num_shards", "rescore_multiplier", "margin", "hot_shard_budget", "ewma_alpha", "pq_m", "name")


@pytest.mark.parametrize("env,child", [
    ({"APP_FABRIC_CHILDBACKEND": "memory", "APP_FABRIC_NUMSHARDS": "3"}, MemoryVectorStore),
    ({"APP_FABRIC_CHILDBACKEND": "tpu", "APP_FABRIC_HOTSHARDBUDGET": "2", "APP_VECTORSTORE_QUANTIZATION": "int8",
      "APP_FABRIC_EWMAALPHA": "0.4", "APP_VECTORSTORE_PQM": "8"}, GPUVectorStore),
], ids=["memory", "tpu-int8"])
def test_factory_builds_the_reference_fabric(config, env, child):
    _env(config, APP_VECTORSTORE_NAME="fabric", **env)
    port, ref = get_vector_store(device="cpu", collection="t"), jget_vector_store(collection="t")
    try:
        assert [getattr(port, k) for k in KNOBS] == [getattr(ref, k) for k in KNOBS]
        assert (port.fanout_max_batch, port.fanout_wait_ms) == (ref._batchers[0].max_batch, WAIT)
        assert all(type(s.store) is child for s in port._shards)
        if child is GPUVectorStore:
            assert all(s.store.device.type == "cpu" and s.store.quantization == "int8" for s in port._shards)
        vecs = _corpus(60, seed=15)
        port.add(_chunks(Chunk, 60), vecs)
        ref.add(_chunks(JChunk, 60), vecs)
        assert _ids(port.search_batch(vecs[:3], 3)) == _ids(ref.search_batch(vecs[:3].tolist(), 3))
    finally:
        port.close()
        ref.close()
    # Overrides reach the topology; a nested fabric is refused alike.
    over = get_vector_store(device="cpu", overrides={"num_shards": 2, "child_backend": "memory"})
    assert over.num_shards == 2 and isinstance(over._shards[0].store, MemoryVectorStore)
    over.close()
    with pytest.raises(ValueError) as ours:
        get_vector_store(device="cpu", overrides={"child_backend": "fabric"})
    with pytest.raises(ValueError) as theirs:
        jget_vector_store(overrides={"child_backend": "fabric"})
    assert str(ours.value) == str(theirs.value) and "nest" in str(ours.value)


def test_durable_fabric_restores_onto_its_configured_children(tmp_path):
    """R1: the reference restores a durable fabric with ``type(inner).load``,
    whose children are numpy ``MemoryVectorStore``s whatever was configured
    (and its fan-out knobs at their defaults); the port's restore rebuilds
    the configured children on the store's device, with its knobs."""
    vecs = _corpus(200, seed=16)
    Q = vecs[::21][:6]
    make_ref = lambda: JFabric(DIM, num_shards=3, fanout_wait_ms=7.0, ewma_alpha=0.3, name="fabric-x",
                               shard_factory=lambda i: TPUVectorStore(DIM, dtype="float32"))
    make_port = lambda: ShardedVectorStore(DIM, num_shards=3, fanout_wait_ms=7.0, ewma_alpha=0.3, name="fabric-x",
                                           device="cpu",
                                           shard_factory=lambda i: GPUVectorStore(DIM, dtype="float32", device="cpu"))
    results = {}
    for name, make, cls, C in (("ref", make_ref, JDurable, JChunk), ("port", make_port, DurableVectorStore, Chunk)):
        d = str(tmp_path / name)
        store = cls(make(), d, fsync_every=0, snapshot_every_records=0)
        store.add(_chunks(C, 150), vecs[:150])
        store.snapshot()
        store.add(_chunks(C, 200)[150:], vecs[150:])
        store.delete_source("s2")
        store.close()
        store._inner.close()
        fresh = make()
        back = cls(fresh, d, fsync_every=0, snapshot_every_records=0)
        inner = back._inner
        assert back.last_recovery["snapshot_restored"] and back.last_recovery["replayed_records"] == 2
        results[name] = (back, inner, _ids(back.search_batch(Q if name == "port" else Q.tolist(), 5)))
    (rb, ri, rids), (pb, pi, pids) = results["ref"], results["port"]
    try:
        assert pids == rids and len(pb) == len(rb) == 200 - sum(1 for i in range(200) if i % 7 == 2)
        assert {type(s.store) for s in ri._shards} == {JMemory}  # the reference's behaviour
        assert ri._batchers[0].max_wait_ms == 0.5 and ri.name == "fabric"
        assert all(type(s.store) is GPUVectorStore and s.store.device.type == "cpu" for s in pi._shards)
        assert (pi.fanout_wait_ms, pi.ewma_alpha, pi.name) == (7.0, 0.3, "fabric-x")
        assert pb.last_recovery["shard_devices"] == ["cpu", "cpu", "cpu"]
    finally:
        for b, i in ((rb, ri), (pb, pi)):
            b.close()
            i.close()


def test_engine_pool_hydrates_the_fabric_on_scale_up(config):
    """``--replicas 2`` with ``APP_VECTORSTORE_NAME=fabric``: ``/admin/scale``
    grows the pool, the bootstrap builds the store singleton on the
    server's device and warms the new replica's shards, and ``/metrics``
    reads ``rag_shard_replica_hydrations_total 1``."""
    import json
    import urllib.request

    from generativeaiexamples_tpu_torch.chains import factory as tfactory
    from generativeaiexamples_tpu_torch.engine.server import build_server

    _env(config, APP_VECTORSTORE_NAME="fabric", APP_FABRIC_CHILDBACKEND="tpu")
    server = build_server(["--device", "cpu", "--model", "llama-tiny", "--host", "127.0.0.1", "--port", "0",
                           "--max-batch", "2", "--max-len", "128", "--replicas", "2", "--embedder", "none"])
    engine = server.scheduler
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    engine.start()
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert tfactory.peek_store() is None
        req = urllib.request.Request(base + "/admin/scale?replicas=3", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200 and json.loads(resp.read())["size"] == 3
        store = tfactory.peek_store()
        assert isinstance(store, ShardedVectorStore) and store.device.type == "cpu"
        assert all(isinstance(s.store, GPUVectorStore) for s in store._shards)
        warmed = [i for i in range(store.num_shards) if store._shards[i].store._device_buf is not None]
        assert warmed == store.shards_for_replica(2, 3) == [2]
        with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
        assert "rag_shard_replica_hydrations_total 1" in metrics.splitlines()
        assert "rag_shard_count 4" in metrics.splitlines()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=60)
