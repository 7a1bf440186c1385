"""The port's named collections (``retrieval/fabric/collections.py``,
``retrieval/fabric/metrics.py``, the factory's ``get_collection_manager``)
against the JAX package's on the CPU.

The same operation sequence (create, admit, quota refusal, add, drop,
``capacity_by_collection``, the collection count cap, bad names) runs on
both managers and gives the same results and the same errors; the
``rag_shard_*`` / ``rag_coldtier_*`` / ``rag_collection_*`` lines and the
per-collection ``rag_store_rows`` series agree, from zero and after.
"""

import os

import numpy as np
import pytest

from generativeaiexamples_tpu.chains import factory as jfactory
from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.retrieval.base import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.fabric import collections as jcollections
from generativeaiexamples_tpu.retrieval.fabric import metrics as jmetrics
from generativeaiexamples_tpu.retrieval.memory import MemoryVectorStore as JMemoryVectorStore
from generativeaiexamples_tpu.server import app as japp
from generativeaiexamples_tpu_torch.chains import factory as tfactory
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.fabric import collections as tcollections
from generativeaiexamples_tpu_torch.retrieval.fabric import metrics as tmetrics
from generativeaiexamples_tpu_torch.retrieval.factory import get_vector_store
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore
from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore
from generativeaiexamples_tpu_torch.server import app as tapp

DIM = 64
JAX = dict(mod=jcollections, metrics=jmetrics, Chunk=JChunk, Store=JMemoryVectorStore)
PORT = dict(mod=tcollections, metrics=tmetrics, Chunk=Chunk, Store=MemoryVectorStore)


def _vecs(n, seed):
    v = np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _outcome(fn):
    """A call's result, or its error's type name and text."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return (type(exc).__name__, str(exc))


def _sequence(side):
    mod = side["mod"]
    default = side["Store"](DIM)
    made = []

    def factory(name, overrides):
        made.append((name, dict(overrides)))
        return side["Store"](DIM)

    m = mod.CollectionManager(factory, default_store=lambda: default, max_collections=3, default_max_rows=10,
                              default_max_bytes=0)
    chunks = lambda n, src: [side["Chunk"](text=f"{src}{i}", source=src, id=f"{src}-{i}") for i in range(n)]  # noqa
    out = [
        _outcome(lambda: m.list()),
        _outcome(lambda: m.exists("default") and not m.exists("tenant-a")),
        _outcome(lambda: type(m.create("tenant-a")).__name__),
        _outcome(lambda: m.create("tenant-a") is m.get("tenant-a")),  # create is ensure
        _outcome(lambda: type(m.create("tenant-b", max_rows=4, backend="memory")).__name__),
        _outcome(lambda: m.create("-bad name")),
        _outcome(lambda: m.create("x" * 65)),
        _outcome(lambda: m.add("tenant-a", chunks(6, "a"), _vecs(6, 0))),
        _outcome(lambda: m.add("tenant-a", chunks(5, "b"), _vecs(5, 1))),  # 6 + 5 > 10
        _outcome(lambda: m.admit("tenant-a", 4, 0)),
        _outcome(lambda: m.add("tenant-b", chunks(4, "c"), _vecs(4, 2))),
        _outcome(lambda: m.admit("tenant-b", 1, 0)),
        _outcome(lambda: m.admit("default", 11, 0)),  # the singleton keeps the config quota
        _outcome(lambda: m.admit("nobody", 10**6, 0)),  # unknown names are not gated
        _outcome(lambda: m.get("nobody")),
        _outcome(lambda: type(m.create("tenant-c")).__name__),
        _outcome(lambda: m.create("tenant-d")),  # past the cap of 3
        _outcome(lambda: m.version("tenant-a")),
        _outcome(lambda: m.capacity_by_collection()),
        _outcome(lambda: m.stats_snapshot()),
        _outcome(lambda: m.drop("default")),
        _outcome(lambda: m.drop("tenant-b")),
        _outcome(lambda: m.drop("tenant-b")),
        _outcome(lambda: m.list()),
        _outcome(lambda: m.stats_snapshot()),
        _outcome(lambda: side["metrics"].fabric_metrics_lines(default, m)),
        _outcome(lambda: side["metrics"].aggregate_capacity_stats(default, m)),
    ]
    m.close()
    return out + [_outcome(lambda: m.list()), made]


def test_manager_sequence_matches_the_reference():
    got, want = _sequence(PORT), _sequence(JAX)
    assert got == want
    assert got[8][0] == "CollectionQuotaExceeded" and "rows 6+5 > 10" in got[8][1]
    assert got[14] == ("UnknownCollection", "unknown collection 'nobody'")
    assert got[16][0] == "CollectionQuotaExceeded" and got[5][0] == "ValueError"


def test_fabric_lines_and_label_fold_match_the_reference():
    for store, manager in ((None, None), (MemoryVectorStore(DIM), None)):
        assert tmetrics.fabric_metrics_lines(store, manager) == jmetrics.fabric_metrics_lines(store, manager)
        assert tmetrics.aggregate_capacity_stats(store, manager) == jmetrics.aggregate_capacity_stats(store, manager)
    per = {f"t{i:03d}": {"rows": i, "bytes": 2 * i, "tail_rows": 0, "note": "x"} for i in range(70)}
    assert tmetrics.fold_collection_labels(per) == jmetrics.fold_collection_labels(per)
    assert tmetrics.fold_collection_labels(per)[-1][0] == "other"
    stats = {"rows": 5, "bytes": 10, "tail_rows": 1}
    for collections in (None, {"tenant-a": {"rows": 3}, 'we"ird\\': {"rows": 2}}, per):
        assert tapp.store_metrics_lines(stats, collections) == japp.store_metrics_lines(stats, collections)


@pytest.fixture
def config(monkeypatch):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    for key, value in (("APP_EMBEDDINGS_MODELENGINE", "hash"), ("APP_EMBEDDINGS_DIMENSIONS", str(DIM)),
                       ("APP_VECTORSTORE_NAME", "tpu"), ("APP_COLLECTIONS_MAXROWSPERCOLLECTION", "8"),
                       ("APP_COLLECTIONS_MAXCOLLECTIONS", "4")):
        monkeypatch.setenv(key, value)
    for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
        configuration.reset_config_cache()
        factory.reset_factories()
    yield
    for configuration, factory in ((jconfiguration, jfactory), (tconfiguration, tfactory)):
        configuration.reset_config_cache()
        factory.reset_factories()


def test_factory_manager_from_config_matches_the_reference(config):
    """The factory's manager from one APP_* overlay: the default collection
    is the store singleton, named ones are exact stores on the port's
    device, quotas come from the config, and the peek stays empty until
    something builds it."""
    assert tfactory.peek_collection_manager() is None and jfactory.peek_collection_manager() is None
    tm, jm = tfactory.get_collection_manager(device="cpu"), jfactory.get_collection_manager()
    assert tfactory.peek_collection_manager() is tm
    assert tm.get("default") is tfactory.get_store() and jm.get("default") is jfactory.get_store()
    store = tm.create("tenant-a")
    assert isinstance(store, GPUVectorStore) and store.device.type == "cpu"
    jm.create("tenant-a")
    for m, C in ((tm, Chunk), (jm, JChunk)):
        m.add("tenant-a", [C(text=f"t{i}", source="a", id=f"a{i}") for i in range(6)], _vecs(6, 0))
    got = [_outcome(lambda: tm.add("tenant-a", [Chunk(text="x", source="b")] * 3, _vecs(3, 1))),
           tm.capacity_by_collection()["tenant-a"]["rows"], tm.stats_snapshot(), tm.list()]
    want = [_outcome(lambda: jm.add("tenant-a", [JChunk(text="x", source="b")] * 3, _vecs(3, 1))),
            jm.capacity_by_collection()["tenant-a"]["rows"], jm.stats_snapshot(), jm.list()]
    assert got == want and got[0][0] == "CollectionQuotaExceeded"
    q = _vecs(2, 5)
    assert [[h.chunk.text for h in r] for r in tm.get("tenant-a").search_batch(q, 4)] == \
        [[h.chunk.text for h in r] for r in jm.get("tenant-a").search_batch(q, 4)]


def test_store_overrides_follow_the_reference(config):
    assert isinstance(get_vector_store(device="cpu", overrides={"backend": "memory"}), MemoryVectorStore)
    assert isinstance(get_vector_store(device="cpu", collection="tenant-a"), GPUVectorStore)
    int8 = get_vector_store(device="cpu", overrides={"quantization": "int8"})
    assert isinstance(int8, GPUVectorStore) and int8.quantization == "int8" and int8.device.type == "cpu"
    fabric = get_vector_store(device="cpu", overrides={"backend": "fabric", "child_backend": "tpu", "num_shards": 2})
    assert type(fabric).__name__ == "ShardedVectorStore" and fabric.num_shards == 2
    assert all(isinstance(s.store, GPUVectorStore) and s.store.device.type == "cpu" for s in fabric._shards)
    fabric.close()
    with pytest.raises(ValueError):
        get_vector_store(device="cpu", overrides={"backend": "nowhere"})
