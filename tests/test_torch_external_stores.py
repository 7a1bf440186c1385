"""The port's external-service adapters (``retrieval/{milvus,pgvector,
elastic}_compat.py``) and ``engine/embedder.py::STEmbedder`` against the
JAX package's, driven alike:

* Milvus and pgvector through the duck-typed client and connection fakes
  of ``tests/test_external_stores.py`` (copied here), each package on its
  own fake;
* Elasticsearch against a fake ES HTTP server on an ephemeral localhost
  port (the reference speaks to it with ``requests``, the port with the
  standard library's ``http.client``);
* the client libraries' absence: the reference's ``RuntimeError`` text, from the
  factories too;
* ``STEmbedder`` through a stand-in ``sentence_transformers`` module in
  ``sys.modules``: the same lists as the reference's, on the device asked
  for (the card by default, which raises here).
"""

import json
import os
import sys
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.retrieval.base import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.factory import get_vector_store as jget_vector_store
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.core.httpclient import HTTPStatusError
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.factory import get_vector_store

DIM = 8


def _contract(store, C, embs):
    """The reference's contract run (``_store_contract_roundtrip``), its
    observations returned for comparison."""
    texts = ["alpha doc about tpus", "beta doc about gpus", "gamma doc", "zero"]
    sources = ["a.txt", "b.txt", "b.txt", "c.txt"]
    chunks = [C(text=t, source=s, id=f"id{i}") for i, (t, s) in enumerate(zip(texts, sources))]
    seen = [store.add(chunks, embs), len(store)]
    for q in (embs[0], embs[1] * -1.0, np.zeros(DIM, np.float32)):
        seen.append([(h.chunk.text, h.chunk.source, h.chunk.id, round(h.score, 6)) for h in store.search(q, 2)])
    seen += [sorted(store.sources()), store.delete_source("b.txt"), len(store), sorted(store.sources()),
             store.delete_source("nothing"), store.version()]
    return seen


def _embs(zero_last=True):
    embs = np.random.default_rng(0).normal(size=(4, DIM)).astype(np.float32)
    if zero_last:
        embs[3] = 0.0
    return embs


# -- Elasticsearch over HTTP ----------------------------------------------------


def _fake_es_handler():
    class FakeES(BaseHTTPRequestHandler):
        """Just enough of the ES REST surface for the adapters (a copy of
        ``tests/test_external_stores.py``'s, one index table a server)."""

        indices: dict = {}

        def _send(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            return self.rfile.read(int(self.headers.get("Content-Length", 0)))

        def log_message(self, *a):
            pass

        def do_HEAD(self):
            index = self.path.strip("/").split("?")[0]
            self.send_response(200 if index in self.indices else 404)
            self.end_headers()

        def do_PUT(self):
            self.indices[self.path.strip("/").split("?")[0]] = []
            self._body()
            self._send({"acknowledged": True})

        def do_GET(self):
            parts = self.path.strip("/").split("?")[0].split("/")
            if len(parts) == 2 and parts[1] == "_count":
                self._send({"count": len(self.indices.get(parts[0], []))})
            else:
                self._send({}, status=404)

        def do_POST(self):
            parts = self.path.split("?")[0].strip("/").split("/")
            raw = self._body()
            if parts == ["_bulk"]:
                assert self.headers["Content-Type"] == "application/x-ndjson"
                lines = [line for line in raw.decode().splitlines() if line.strip()]
                for i in range(0, len(lines), 2):
                    index = json.loads(lines[i])["index"]["_index"]
                    self.indices.setdefault(index, []).append(json.loads(lines[i + 1]))
                self._send({"errors": False, "items": []})
                return
            body = json.loads(raw or b"{}")
            docs = self.indices.get(parts[0], [])
            if parts[-1] == "_search" and "knn" in body:
                q = np.asarray(body["knn"]["query_vector"], np.float32)
                scored = sorted((((1.0 + float(np.dot(q, np.asarray(d["vector"], np.float32)))) / 2.0, d)
                                 for d in docs), key=lambda t: -t[0])[: body["knn"]["k"]]
                self._send({"hits": {"hits": [{"_score": s, "_source": {k: d[k] for k in ("text", "source",
                                                                                          "chunk_id")}}
                                              for s, d in scored]}})
            elif parts[-1] == "_search":
                counts: dict = {}
                for d in docs:
                    counts[d["source"]] = counts.get(d["source"], 0) + 1
                self._send({"aggregations": {"srcs": {"buckets": [{"key": k, "doc_count": v}
                                                                  for k, v in counts.items()]}}})
            elif parts[-1] == "_delete_by_query":
                term = body["query"]["term"]["source"]
                self.indices[parts[0]] = [d for d in docs if d["source"] != term]
                self._send({"deleted": len(docs) - len(self.indices[parts[0]])})
            else:
                self._send({}, status=404)

    return FakeES


@pytest.fixture
def fake_es():
    servers = []

    def start(handler=None):
        server = ThreadingHTTPServer(("127.0.0.1", 0), handler or _fake_es_handler())
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return f"http://127.0.0.1:{server.server_address[1]}"

    yield start
    for server in servers:
        server.shutdown()
        server.server_close()


def test_elasticsearch_contract_equals_the_reference(fake_es):
    from generativeaiexamples_tpu.retrieval.elastic_compat import ElasticsearchVectorStore as JES
    from generativeaiexamples_tpu_torch.retrieval.elastic_compat import ElasticsearchVectorStore

    embs = _embs()
    port = _contract(ElasticsearchVectorStore(DIM, url=fake_es(), index="T-Idx"), Chunk, embs)
    ref = _contract(JES(DIM, url=fake_es(), index="T-Idx"), JChunk, embs)
    assert port == ref and port[1] == 3  # the zero embedding is skipped alike


def test_elasticsearch_refuses_a_cluster_that_is_not_ready(fake_es):
    from generativeaiexamples_tpu_torch.retrieval.elastic_compat import ElasticsearchVectorStore

    class Booting(_fake_es_handler()):
        def do_HEAD(self):
            self.send_response(503)
            self.end_headers()

    with pytest.raises(HTTPStatusError) as err:
        ElasticsearchVectorStore(DIM, url=fake_es(Booting), index="x")
    assert err.value.status == 503


# -- Milvus and pgvector through fakes ---------------------------------------------


class _FakeMilvusClient:
    """Duck-typed MilvusClient (a copy of ``tests/test_external_stores.py``'s)."""

    def __init__(self, dict_delete=False):
        self.collections: dict[str, list[dict]] = {}
        self.dict_delete = dict_delete

    def has_collection(self, name):
        return name in self.collections

    def create_collection(self, name, dimension, metric_type, auto_id):
        assert metric_type == "IP" and auto_id
        self.collections[name] = []

    def insert(self, name, rows):
        self.collections[name].extend(dict(r) for r in rows)

    def search(self, name, data, limit, output_fields):
        out = []
        for q in data:
            qv = np.asarray(q, np.float32)
            scored = sorted(((float(np.dot(qv, np.asarray(r["vector"], np.float32))), r)
                             for r in self.collections[name]), key=lambda t: -t[0])[:limit]
            out.append([{"distance": s, "entity": {k: r[k] for k in output_fields}} for s, r in scored])
        return out

    def query(self, name, filter, output_fields, limit):
        assert filter == ""
        return [{k: r[k] for k in output_fields} for r in self.collections[name][:limit]]

    def delete(self, name, filter):
        assert filter.startswith('source == "') and filter.endswith('"')
        src = filter[len('source == "') : -1].replace('\\"', '"').replace("\\\\", "\\")
        before = self.collections[name]
        self.collections[name] = [r for r in before if r["source"] != src]
        n = len(before) - len(self.collections[name])
        return {"delete_count": n} if self.dict_delete else list(range(n))

    def get_collection_stats(self, name):
        return {"row_count": len(self.collections[name])}


@pytest.mark.parametrize("dict_delete", [False, True], ids=["pk-list", "delete-count"])
def test_milvus_contract_equals_the_reference(dict_delete):
    from generativeaiexamples_tpu.retrieval.milvus_compat import MilvusVectorStore as JMilvus
    from generativeaiexamples_tpu_torch.retrieval.milvus_compat import MilvusVectorStore

    embs = _embs(zero_last=False)
    clients = _FakeMilvusClient(dict_delete), _FakeMilvusClient(dict_delete)
    port = _contract(MilvusVectorStore(DIM, url="fake://", collection="t", client=clients[0]), Chunk, embs)
    ref = _contract(JMilvus(DIM, url="fake://", collection="t", client=clients[1]), JChunk, embs)
    assert port == ref and clients[0].collections == clients[1].collections
    evil = 'a" or source != "'
    for cls, C, client in ((MilvusVectorStore, Chunk, clients[0]), (JMilvus, JChunk, clients[1])):
        store = cls(DIM, url="fake://", collection="t", client=client)
        before = len(store)
        store.add([C(text="x", source=evil, id="e")], np.ones((1, DIM), np.float32))
        assert store.delete_source(evil) == 1 and len(store) == before == 2


class _FakePgCursor:
    """Exactly the SQL the adapters issue (a copy of
    ``tests/test_external_stores.py``'s), with the statements recorded."""

    def __init__(self, db):
        self.db = db
        self.rowcount = -1
        self._rows: list = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def execute(self, sql, params=None):
        s = " ".join(sql.split())
        self.db["log"].append(s)
        table, rows = self.db["table"], self.db["rows"]
        if s.startswith(("CREATE EXTENSION", "CREATE TABLE")):
            return
        if s.startswith(f"INSERT INTO {table}"):
            cid, text, source, emb = params
            if not any(r["id"] == cid for r in rows):
                rows.append({"id": cid, "text": text, "source": source, "emb": emb})
            return
        if s.startswith("SELECT id, text, source, 1 - (embedding <=>"):
            q = np.asarray(params[0], np.float32)

            def cos_dist(r):
                v = np.asarray(r["emb"], np.float32)
                return 1.0 - float(np.dot(q, v) / ((np.linalg.norm(q) * np.linalg.norm(v)) or 1.0))

            self._rows = [(r["id"], r["text"], r["source"], 1.0 - cos_dist(r))
                          for r in sorted(rows, key=cos_dist)[: params[2]]]
            return
        if s.startswith(f"SELECT DISTINCT source FROM {table}"):
            self._rows = [(src,) for src in sorted({r["source"] for r in rows})]
            return
        if s.startswith(f"DELETE FROM {table} WHERE source"):
            before = len(rows)
            rows[:] = [r for r in rows if r["source"] != params[0]]
            self.rowcount = before - len(rows)
            return
        if s.startswith(f"SELECT COUNT(*) FROM {table}"):
            self._rows = [(len(rows),)]
            return
        raise AssertionError(f"unexpected SQL from adapter: {s}")

    def fetchall(self):
        return list(self._rows)

    def fetchone(self):
        return self._rows[0]


class _FakePgConnection:
    def __init__(self, table):
        self.autocommit = False
        self.db = {"table": table, "rows": [], "log": []}

    def cursor(self):
        return _FakePgCursor(self.db)


def test_pgvector_contract_and_sql_equal_the_reference():
    from generativeaiexamples_tpu.retrieval.pgvector_compat import PgVectorStore as JPg
    from generativeaiexamples_tpu_torch.retrieval.pgvector_compat import PgVectorStore

    embs = _embs(zero_last=False)
    conns = _FakePgConnection("gaie_tpu_chunks_t"), _FakePgConnection("gaie_tpu_chunks_t")
    port_store, ref_store = PgVectorStore(DIM, url="fake://", table_suffix="t", conn=conns[0]), JPg(
        DIM, url="fake://", table_suffix="t", conn=conns[1])
    assert conns[0].autocommit is True and port_store._table == ref_store._table
    assert _contract(port_store, Chunk, embs) == _contract(ref_store, JChunk, embs)
    assert conns[0].db["log"] == conns[1].db["log"] and conns[0].db["rows"] == conns[1].db["rows"]


# -- client libraries and factories ------------------------------------------------------------


@pytest.fixture
def config(monkeypatch):
    for key in list(os.environ):
        if key.startswith(("APP_", "GAIE_")):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", str(DIM))
    # The client libraries are absent here and on the card machine; make sure of it.
    monkeypatch.setitem(sys.modules, "pymilvus", None)
    monkeypatch.setitem(sys.modules, "psycopg2", None)
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()
    yield monkeypatch
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()


def _reset():
    jconfiguration.reset_config_cache()
    tconfiguration.reset_config_cache()


@pytest.mark.parametrize("backend", ["milvus", "pgvector"])
def test_missing_client_libraries_raise_the_reference_error(config, backend):
    config.setenv("APP_VECTORSTORE_NAME", backend)
    config.setenv("APP_VECTORSTORE_URL", "fake://nowhere")
    _reset()
    with pytest.raises(RuntimeError) as ours:
        get_vector_store(device="cpu")
    with pytest.raises(RuntimeError) as theirs:
        jget_vector_store()
    assert str(ours.value) == str(theirs.value) and "requires" in str(ours.value)


def test_factory_builds_elasticsearch_with_the_reference_index(config, fake_es):
    config.setenv("APP_VECTORSTORE_NAME", "elasticsearch")
    config.setenv("APP_VECTORSTORE_URL", fake_es())
    _reset()
    port, ref = get_vector_store(device="cpu", collection="Fact"), jget_vector_store(collection="Fact")
    assert type(port).__name__ == type(ref).__name__ == "ElasticsearchVectorStore"
    assert port._index == ref._index == "generativeaiexamples-tpu-fact"
    from generativeaiexamples_tpu.retrieval.milvus_compat import _COLLECTION as JCOL
    from generativeaiexamples_tpu.retrieval.pgvector_compat import _TABLE as JTABLE
    from generativeaiexamples_tpu_torch.retrieval.milvus_compat import _COLLECTION
    from generativeaiexamples_tpu_torch.retrieval.pgvector_compat import _TABLE

    assert (_COLLECTION, _TABLE) == (JCOL, JTABLE)


# -- STEmbedder through a stand-in sentence_transformers ----------------------------------


class _StandInST:
    """A stand-in ``SentenceTransformer``: deterministic vectors from the
    texts' bytes, normalized as asked; it records its device."""

    built: list = []

    def __init__(self, model_name, device=None):
        self.model_name, self.device = model_name, device
        _StandInST.built.append(self)

    def get_sentence_embedding_dimension(self):
        return 16

    def encode(self, texts, normalize_embeddings=False):
        out = np.stack([np.resize(np.frombuffer(t.encode() or b"\0", np.uint8).astype(np.float32) - 96.5, 16)
                        for t in texts]).astype(np.float32)
        if normalize_embeddings:
            out /= np.linalg.norm(out, axis=1, keepdims=True)
        return out


@pytest.fixture
def stand_in(monkeypatch):
    module = types.ModuleType("sentence_transformers")
    module.SentenceTransformer = _StandInST
    monkeypatch.setitem(sys.modules, "sentence_transformers", module)
    _StandInST.built = []
    return module


def test_st_embedder_gives_the_reference_lists(stand_in):
    from generativeaiexamples_tpu.engine.embedder import STEmbedder as JST
    from generativeaiexamples_tpu_torch.engine.embedder import STEmbedder

    port, ref = STEmbedder("some/model", 1024, device="cpu"), JST("some/model", 1024)
    texts = ["alpha", "a longer passage of text", ""]
    assert port.dimensions == ref.dimensions == 16
    assert port.embed_documents(texts) == ref.embed_documents(texts)
    assert port.embed_query("q?") == ref.embed_query("q?")
    assert port.embed_queries(texts) == ref.embed_queries(texts) and port.embed_queries([]) == []
    assert [(m.model_name, m.device) for m in _StandInST.built] == [("some/model", "cpu"), ("some/model", "cpu")]


def test_huggingface_engine_builds_st_embedder_on_the_asked_device(stand_in, config):
    import torch

    from generativeaiexamples_tpu_torch.chains import factory as tfactory
    from generativeaiexamples_tpu_torch.engine.embedder import STEmbedder

    config.setenv("APP_EMBEDDINGS_MODELENGINE", "huggingface")
    config.setenv("APP_EMBEDDINGS_MODELNAME", "st/model")
    _reset()
    try:
        emb = tfactory.get_embedder(device="cpu")
        assert isinstance(emb, STEmbedder) and emb.device.type == "cpu" and _StandInST.built[-1].device == "cpu"
        assert _StandInST.built[-1].model_name == "st/model"
        tfactory.reset_factories()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tfactory.get_embedder()
    finally:
        tfactory.reset_factories()
