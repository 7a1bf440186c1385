"""The port's C++ CPU store (``retrieval/native.py`` over
``native/vecsearch.cpp``, built by the port's ``utils/native_build.py``
into ``build/torch_native/``) against the JAX package's ``NativeVectorStore``
(built into ``native/build/``) on the same seeded numpy corpora: exact and
IVF ids and scores bit for bit (both libraries build from one source with
the same flags on one host), deletes, ``sources`` and ``len``; the
``native`` backend and ``auto`` on the CPU from ``APP_*`` as the
reference's factory builds them.
"""

import os

import numpy as np
import pytest

from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.retrieval.base import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.factory import get_vector_store as jget_vector_store
from generativeaiexamples_tpu.retrieval.native import NativeVectorStore as JNative
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.factory import get_vector_store
from generativeaiexamples_tpu_torch.retrieval.native import NativeVectorStore
from generativeaiexamples_tpu_torch.utils import native_build

DIM = 48


def _clustered(n, seed=0, n_centers=16, n_queries=12):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, DIM)).astype(np.float32) * 3
    vecs = centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = vecs[rng.integers(0, n, n_queries)] + 0.1 * rng.standard_normal((n_queries, DIM)).astype(np.float32)
    return vecs, queries


def _hits(results):
    return [[(h.chunk.id, h.score) for h in hits] for hits in results]


def _pair(n, seed, **kw):
    vecs, queries = _clustered(n, seed)
    ref, port = JNative(DIM, **kw), NativeVectorStore(DIM, **kw)
    for store, C in ((ref, JChunk), (port, Chunk)):
        for lo in range(0, n, 700):  # several adds: later rows join the built lists
            store.add([C(text=f"t{i}", source=f"s{i % 5}", id=f"c{i}") for i in range(lo, min(n, lo + 700))],
                      vecs[lo : lo + 700])
    return ref, port, queries


def test_the_port_builds_its_own_library():
    lib = native_build.load_native_library("vecsearch")
    assert os.path.dirname(lib._name) == native_build.BUILD_DIR


@pytest.mark.parametrize("kw", [
    {"index_type": "exact"},
    {"index_type": "ivf", "nlist": 16, "nprobe": 4, "ivf_build_threshold": 1000},
    {"index_type": "ivf", "nlist": 64, "nprobe": 16, "ivf_build_threshold": 512, "kmeans_iters": 3},
], ids=["exact", "ivf-16-4", "ivf-64-16"])
def test_ids_and_scores_equal_the_reference_bit_for_bit(kw):
    ref, port, queries = _pair(2000, seed=1, **kw)
    for k in (1, 10, 50):
        assert _hits([port.search(q, k) for q in queries]) == _hits([ref.search(q.tolist(), k) for q in queries])
    assert _hits(port.search_batch(queries, 7)) == _hits(ref.search_batch(queries.tolist(), 7))
    assert port._lib.vs_nlist(port._handle) == ref._lib.vs_nlist(ref._handle) == kw.get("nlist", 0) * (
        kw["index_type"] == "ivf")
    assert port.delete_source("s2") == ref.delete_source("s2") > 0
    assert port.delete_source("s2") == ref.delete_source("s2") == 0
    assert len(port) == len(ref) == 1600 and port.sources() == ref.sources() == ["s0", "s1", "s3", "s4"]
    got = [port.search(q, 10) for q in queries]
    assert _hits(got) == _hits([ref.search(q.tolist(), 10) for q in queries])
    assert all(h.chunk.source != "s2" for r in got for h in r)
    assert port.version() == ref.version()


def test_empty_and_bad_inputs_behave_as_the_reference():
    port, ref = NativeVectorStore(DIM), JNative(DIM)
    assert port.search(np.ones(DIM), 5) == ref.search([1.0] * DIM, 5) == []
    assert port.add([], []) == ref.add([], []) == []
    for store, C in ((port, Chunk), (ref, JChunk)):
        with pytest.raises(ValueError, match="mismatch"):
            store.add([C(text="a", source="s")], [])
        with pytest.raises(ValueError, match="shape"):
            store.add([C(text="a", source="s")], [[1.0] * (DIM - 1)])


@pytest.fixture
def config(monkeypatch):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", str(DIM))
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    yield monkeypatch
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()


KNOBS = ("index_type", "nlist", "nprobe", "ivf_build_threshold", "kmeans_iters", "dimensions")


@pytest.mark.parametrize("env,threshold", [
    ({"APP_VECTORSTORE_NAME": "native"}, 2048),
    ({"APP_VECTORSTORE_NAME": "native", "APP_VECTORSTORE_INDEXTYPE": "ivf", "APP_VECTORSTORE_NLIST": "32",
      "APP_VECTORSTORE_NPROBE": "8"}, 2048),
    ({"APP_VECTORSTORE_NAME": "auto"}, 6_000),
    ({"APP_VECTORSTORE_NAME": "auto", "APP_EMBEDDINGS_DIMENSIONS": "1024"}, 16_000),
    ({"APP_VECTORSTORE_NAME": "auto", "GAIE_RETRIEVAL_CROSSOVER": "700"}, 700),
], ids=["native", "native-ivf", "auto-narrow", "auto-wide", "auto-pinned"])
def test_factory_builds_the_reference_native_store(config, env, threshold):
    """``native`` from ``APP_*``, and ``auto`` on the CPU: the C++ IVF store
    with the CPU crossover as its build threshold, as the reference's."""
    for key, value in env.items():
        config.setenv(key, value)
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    port, ref = get_vector_store(device="cpu"), jget_vector_store()
    assert type(port) is NativeVectorStore and type(ref) is JNative
    assert [getattr(port, k) for k in KNOBS] == [getattr(ref, k) for k in KNOBS]
    assert port.ivf_build_threshold == threshold
    if env["APP_VECTORSTORE_NAME"] == "auto":
        assert port.index_type == "ivf"
    if port.dimensions == DIM:
        vecs, queries = _clustered(900, seed=3)
        port.add([Chunk(text=f"t{i}", source="s", id=f"c{i}") for i in range(900)], vecs)
        ref.add([JChunk(text=f"t{i}", source="s", id=f"c{i}") for i in range(900)], vecs)
        assert _hits(port.search_batch(queries, 5)) == _hits(ref.search_batch(queries.tolist(), 5))
