"""The port's retrieval chain against the JAX package's on the CPU.

The port's ``Retriever`` runs on ``GPUEmbedder(device="cpu")`` (bert-tiny
in float32, the reference's weights carried over by ``engine/weights.py``),
``GPUVectorStore(device="cpu")`` and, where a case asks for one,
``GPUReranker``; the JAX ``Retriever`` runs on ``TPUEmbedder``,
``TPUVectorStore`` and ``TPUReranker`` with the same weights, the same
rows and the same queries.  Each case takes both through the same calls
and holds the port to the reference: hit texts equal, scores within
``SCORE_TOL``, and per request the same ``DegradeLog`` stages, ``CacheLog``
tier and entry, trace stages (names and attributes), and the same cache
and resilience counters.  The ladder's rungs are driven through the same
``GAIE_FAULTS`` spec in both packages, an open breaker, or a budget under
the retriever's floors.  The config-built chain (``chains/factory.py``)
is held to the reference's factory on the ``hash`` embedder and the
``memory`` and exact stores.
"""

import dataclasses
import os
import types

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.cache import core as jcache
from generativeaiexamples_tpu.cache import log as jcachelog
from generativeaiexamples_tpu.cache import metrics as jcachemetrics
from generativeaiexamples_tpu.chains import factory as jfactory
from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.engine.embedder import TPUEmbedder
from generativeaiexamples_tpu.engine.reranker import TPUReranker
from generativeaiexamples_tpu.models import bert as jbert
from generativeaiexamples_tpu.obs import trace as jtrace
from generativeaiexamples_tpu.resilience import breaker as jbreaker
from generativeaiexamples_tpu.resilience import deadline as jdeadline
from generativeaiexamples_tpu.resilience import degrade as jdegrade
from generativeaiexamples_tpu.resilience import faults as jfaults
from generativeaiexamples_tpu.resilience import metrics as jmetrics
from generativeaiexamples_tpu.resilience import retry as jretry
from generativeaiexamples_tpu.retrieval import base as jbase
from generativeaiexamples_tpu.retrieval import retriever as jretriever
from generativeaiexamples_tpu.retrieval.tpu import TPUVectorStore
from generativeaiexamples_tpu_torch.cache import core as tcache
from generativeaiexamples_tpu_torch.cache import log as tcachelog
from generativeaiexamples_tpu_torch.cache import metrics as tcachemetrics
from generativeaiexamples_tpu_torch.chains import factory as tfactory
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker
from generativeaiexamples_tpu_torch.engine.weights import bert_params_from_numpy, rerank_head_from_numpy
from generativeaiexamples_tpu_torch.models import bert as tbert
from generativeaiexamples_tpu_torch.obs import trace as ttrace
from generativeaiexamples_tpu_torch.resilience import breaker as tbreaker
from generativeaiexamples_tpu_torch.resilience import deadline as tdeadline
from generativeaiexamples_tpu_torch.resilience import degrade as tdegrade
from generativeaiexamples_tpu_torch.resilience import faults as tfaults
from generativeaiexamples_tpu_torch.resilience import metrics as tmetrics
from generativeaiexamples_tpu_torch.resilience import retry as tretry
from generativeaiexamples_tpu_torch.retrieval import base as tbase
from generativeaiexamples_tpu_torch.retrieval import retriever as tretriever
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

# Scores of the same rows against queries embedded by each package's BERT
# (f32, within 1e-5 of each other), and cross-encoder logits (up to ~7
# here), both within tests/test_torch_embedder.py's TOL: atol and rtol 1e-5.
SCORE_TOL = 1e-5
DIM = 64

P = {
    "jax": types.SimpleNamespace(
        Retriever=jretriever.Retriever, RetrievalCache=jcache.RetrievalCache, CacheLog=jcachelog.CacheLog,
        DegradeLog=jdegrade.DegradeLog, RequestTrace=jtrace.RequestTrace, Deadline=jdeadline.Deadline,
        RetryPolicy=jretry.RetryPolicy, get_breaker=jbreaker.get_breaker, reset=jmetrics.reset_resilience,
        snapshot=jmetrics.resilience_snapshot, cache_snapshot=jcachemetrics.cache_snapshot, Chunk=jbase.Chunk,
        factory=jfactory, configuration=jconfiguration, faults=jfaults),
    "torch": types.SimpleNamespace(
        Retriever=tretriever.Retriever, RetrievalCache=tcache.RetrievalCache, CacheLog=tcachelog.CacheLog,
        DegradeLog=tdegrade.DegradeLog, RequestTrace=ttrace.RequestTrace, Deadline=tdeadline.Deadline,
        RetryPolicy=tretry.RetryPolicy, get_breaker=tbreaker.get_breaker, reset=tmetrics.reset_resilience,
        snapshot=tmetrics.resilience_snapshot, cache_snapshot=tcachemetrics.cache_snapshot, Chunk=tbase.Chunk,
        factory=tfactory, configuration=tconfiguration, faults=tfaults),
}

DOCS = [f"passage {i} on {('tpus', 'gpus', 'caches', 'vector search', 'rerankers', 'deadlines')[i % 6]} "
        f"with detail {i * 7 % 11}" for i in range(48)]
QUERIES = ["what is a tpu", "how do caches work", "vector search on gpus", "tell me about deadlines",
           "rerankers and passages"]
NEW_QUERIES = ["a question never asked", "breakers open and close", "one more distinct query"]


class _NoFallback:
    """The store without its host fallback: the ladder's next rung is the
    stale cache."""

    def __init__(self, store):
        self._store = store

    def search_batch(self, embeddings, top_k):
        return self._store.search_batch(embeddings, top_k)

    def version(self):
        return self._store.version()


_NORMS = ("embed_norm_g", "embed_norm_b", "attn_norm_g", "attn_norm_b", "mlp_norm_g", "mlp_norm_b")
# bert-tiny's random leaves scaled up from the reference's 0.02 std: at
# 0.02 every CLS vector lies within 1e-5 of every other and every pair
# scores alike, so ranks would turn on rounding.  Embedder at 0.5 std: the
# queries' cosines to each other are 0.67 to 0.97 (no accidental semantic
# hits at 0.98), the top scores' gaps >= 3.7e-4.  Cross-encoder at 0.2 std:
# logits 0.03 to 1.1, gaps within a query's candidates >= 5.7e-4, the two
# packages 1.5e-6 apart.
EMBED_SCALE, RERANK_SCALE = 25.0, 10.0


def _scaled(tree, scale):
    return {k: _scaled(v, scale) if isinstance(v, dict) else v if k in _NORMS else v * scale for k, v in tree.items()}


@pytest.fixture(scope="module")
def stacks():
    cfg = jbert.bert_tiny(dtype="float32")
    tcfg = tbert.bert_tiny(dtype="float32")
    params = {}
    for name, seed, scale in (("embed", 3, EMBED_SCALE), ("rerank", 5, RERANK_SCALE)):
        jp = _scaled(jbert.init_params(cfg, jax.random.PRNGKey(seed)), scale)
        params[name] = (jp, bert_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    jh = _scaled(jbert.init_rerank_head(cfg, jax.random.PRNGKey(6)), RERANK_SCALE)
    th = rerank_head_from_numpy(jax.tree.map(np.asarray, jh), "cpu")
    jemb = TPUEmbedder(cfg, params["embed"][0], batch_size=4, max_length=64)
    temb = GPUEmbedder(tcfg, params["embed"][1], batch_size=4, max_length=64, device="cpu")
    rows = np.asarray(jemb.embed_documents(DOCS), dtype=np.float32)
    out = {}
    for name, emb, store, reranker in (
        ("jax", jemb, TPUVectorStore(DIM, dtype="float32"),
         TPUReranker(cfg, params["rerank"][0], jh, batch_size=4, max_length=64)),
        ("torch", temb, GPUVectorStore(DIM, dtype="float32", device="cpu"),
         GPUReranker(tcfg, params["rerank"][1], th, batch_size=4, max_length=64, device="cpu")),
    ):
        store.add([P[name].Chunk(text=t, source=f"doc{i % 6}", id=str(i)) for i, t in enumerate(DOCS)], rows)
        # Warm-up at the cases' shapes: the JAX side compiles here, so no
        # case's deadline pays a compile.
        emb.embed_queries(QUERIES + NEW_QUERIES)
        store.search_batch(emb.embed_queries(QUERIES), 12)
        store.search_fallback(emb.embed_queries(QUERIES), 12)
        reranker.score_pairs([(q, d) for q in QUERIES[:2] for d in DOCS[:12]])
        out[name] = types.SimpleNamespace(embedder=emb, store=store, reranker=reranker)
    return out


def _reset(p):
    p.reset()
    p.factory.reset_factories()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("GAIE_FAULTS", raising=False)
    for p in P.values():
        _reset(p)
    yield
    monkeypatch.delenv("GAIE_FAULTS", raising=False)
    for p in P.values():
        _reset(p)


def _retriever(p, stack, *, rerank=False, store=None, **kw):
    cfg = p.configuration.get_config()
    return p.Retriever(
        store=store or stack.store, embedder=stack.embedder, top_k=cfg.retriever.top_k,
        score_threshold=cfg.retriever.score_threshold, fetch_k_multiplier=cfg.retriever.fetch_k_multiplier,
        reranker=stack.reranker if rerank else None,
        min_rerank_budget_ms=kw.pop("min_rerank_budget_ms", cfg.resilience.min_rerank_budget_ms),
        min_full_k_budget_ms=kw.pop("min_full_k_budget_ms", cfg.resilience.min_full_k_budget_ms),
        embed_retry=p.RetryPolicy(max_attempts=2, base_ms=1, name="embed"),
        search_retry=p.RetryPolicy(max_attempts=2, base_ms=1, name="store-search"),
        cache=p.RetrievalCache(DIM, max_entries=cfg.cache.max_entries, semantic_entries=cfg.cache.semantic_entries,
                               similarity_threshold=cfg.cache.similarity_threshold,
                               semantic_enabled=cfg.cache.semantic_enabled,
                               **({"device": "cpu"} if p is P["torch"] else {})),
        cache_serve_stale=cfg.cache.serve_stale, **kw,
    )


def _arm(p, monkeypatch, spec):
    """Arm ``spec`` the way a deployment does: GAIE_FAULTS, read when the
    package's injector is next built."""
    monkeypatch.setenv("GAIE_FAULTS", spec)
    p.faults.reset_faults()


def _trip(breaker):
    for _ in range(breaker.min_calls):
        breaker.record_failure()
    assert breaker.state == "open"


def _call(p, r, queries, k, deadline=None):
    """One batched call with per-request logs and traces: (hit texts,
    scores, degrade stages, cache tier and entry, trace stages) per
    request, or the error."""
    logs = [p.DegradeLog() for _ in queries]
    clogs = [p.CacheLog() for _ in queries]
    traces = [p.RequestTrace(route="/search") for _ in queries]
    try:
        many = r.retrieve_many(queries, top_k=k, deadline=deadline, degrade_logs=logs, cache_logs=clogs,
                               traces=traces)
    except Exception as exc:  # the embedder rung: the retriever raises
        return {"error": f"{type(exc).__name__}: {exc}"}
    out = []
    for hits, log, clog, tr in zip(many, logs, clogs, traces):
        entry = clog.entry
        stages = [(s["stage"], {a: v for a, v in (s.get("attrs") or {}).items()}) for s in tr.stages()]
        out.append(dict(texts=[h.chunk.text for h in hits], scores=[h.score for h in hits], degraded=log.stages(),
                        tier=clog.tier, entry=None if entry is None else (entry.query, entry.top_k, len(entry.hits)),
                        stages=stages, store_version=tr.snapshot()["attrs"].get("store_version")))
    return out


def _counters(p):
    snap, cache = p.snapshot(), p.cache_snapshot()
    return dict(degraded=snap["degraded_total"], retries=snap["retries_total"],
                breakers={k: v for k, v in snap["breakers"].items()},
                hits=cache["hits"], misses=cache["misses"], invalidations=cache["invalidations"])


def _scenario(name, p, stack, monkeypatch):
    """The calls of one case; returns {step: _call result} + counters."""
    rerank = name in ("rerank", "reranker_fault", "reranker_breaker", "budget_rerank", "budget_k")
    r = _retriever(p, stack, rerank=rerank, **(
        dict(min_rerank_budget_ms=10_000.0, min_full_k_budget_ms=5_000.0) if name.startswith("budget") else {}))
    steps = {"cold": _call(p, r, QUERIES, 3), "warm": _call(p, r, QUERIES, 3)}
    if name in ("clean", "rerank"):
        # Exact misses at a smaller k: semantic hits on the cold entries
        # (re-ranked over their candidates when a reranker is on).
        steps["semantic"] = _call(p, r, QUERIES, 2)
        steps["exact_alias"] = _call(p, r, QUERIES, 2)
        r.store.add([p.Chunk(text="a late passage on tpus", source="late", id="late")],
                    [stack.embedder.embed_documents(["a late passage on tpus"])[0]])
        steps["after_add"] = _call(p, r, QUERIES[:2], 3)  # version bumped: invalidations
    elif name == "embedder_fault":
        _arm(p, monkeypatch, "embedder:error=1")
        steps["faulted"] = _call(p, r, NEW_QUERIES, 3)
    elif name == "store_fault":
        _arm(p, monkeypatch, "store:error=1")
        steps["faulted"] = _call(p, r, NEW_QUERIES, 3)
    elif name == "store_fault_stale":
        _arm(p, monkeypatch, "store:error=1")
        stale = dataclasses.replace(r, store=_NoFallback(r.store))
        steps["faulted"] = _call(p, stale, QUERIES, 4)  # deeper than the cached k: a miss, then stale
        steps["no_stale"] = _call(p, stale, NEW_QUERIES[:1], 4)  # nothing cached: the error surfaces
    elif name == "store_breaker":
        _trip(p.get_breaker("store"))
        steps["faulted"] = _call(p, r, NEW_QUERIES, 3)
    elif name == "reranker_fault":
        _arm(p, monkeypatch, "reranker:error=1")
        steps["faulted"] = _call(p, r, NEW_QUERIES, 3)
    elif name == "reranker_breaker":
        _trip(p.get_breaker("reranker"))
        steps["faulted"] = _call(p, r, NEW_QUERIES, 3)
    elif name == "budget_rerank":  # under min_rerank_budget_ms only
        steps["faulted"] = _call(p, r, NEW_QUERIES, 3, deadline=p.Deadline.after_ms(60_000.0 / 8))
    elif name == "budget_k":  # under both floors
        steps["faulted"] = _call(p, r, NEW_QUERIES, 3, deadline=p.Deadline.after_ms(3_000.0))
    if name in ("store_fault", "store_breaker", "reranker_fault", "reranker_breaker"):
        # The same rung with no per-request logs (a caller outside a
        # request scope): only the call's own flag keeps it out of the cache.
        bare = r.retrieve_many(NEW_QUERIES, top_k=3)
        steps["bare"] = [dict(texts=[h.chunk.text for h in hits], scores=[h.score for h in hits]) for hits in bare]
    # A degraded result is never admitted: the cache holds what it held.
    steps["cache_after"] = r.cache.stats()
    return steps, _counters(p)


def _split_scores(steps):
    """(steps without scores, flat scores) for a tolerance comparison."""
    scores, bare = [], {}
    for step, res in steps.items():
        if isinstance(res, dict):
            bare[step] = res
            continue
        bare[step] = [{k: v for k, v in req.items() if k != "scores"} for req in res]
        scores += [s for req in res for s in req["scores"]]
    return bare, np.asarray(scores)


CASES = ["clean", "rerank", "embedder_fault", "store_fault", "store_fault_stale", "store_breaker", "reranker_fault",
         "reranker_breaker", "budget_rerank", "budget_k"]
EXPECT = {  # the rung each case must show on its faulted step
    "embedder_fault": "error", "store_fault": ["index_fallback"], "store_fault_stale": ["cache_stale"],
    "store_breaker": ["index_fallback"], "reranker_fault": ["rerank"], "reranker_breaker": ["rerank"],
    "budget_rerank": ["rerank"], "budget_k": ["shrink_k", "rerank"],
}


@pytest.mark.parametrize("case", CASES)
def test_retriever_matches_reference(case, stacks, monkeypatch):
    got = {}
    for name, p in P.items():
        got[name] = _scenario(case, p, stacks[name], monkeypatch)
        monkeypatch.delenv("GAIE_FAULTS", raising=False)
        p.faults.reset_faults()
    (jsteps, jcount), (tsteps, tcount) = got["jax"], got["torch"]
    jbare, jscores = _split_scores(jsteps)
    tbare, tscores = _split_scores(tsteps)
    for step in jbare:  # stage durations are host times: compare names and attributes
        assert tbare[step] == jbare[step], step
    assert tscores.shape == jscores.shape
    np.testing.assert_allclose(tscores, jscores, atol=SCORE_TOL, rtol=SCORE_TOL)
    assert tcount == jcount
    # The case exercised what it names.
    cold = tsteps["cold"]
    assert all(req["texts"] and req["tier"] == "" and not req["degraded"] for req in cold)
    assert [s for s, _ in cold[0]["stages"]][:4] == ["cache_lookup", "embed", "cache_lookup", "search"]
    assert all(req["tier"] == "exact" and [s for s, _ in req["stages"]] == ["cache_lookup"] for req in tsteps["warm"])
    if case in EXPECT:
        assert tsteps["cache_after"]["entries"] == len(QUERIES)  # the cold pass's only
        faulted = tsteps["faulted"]
        if EXPECT[case] == "error":
            assert "injected fault at 'embedder'" in faulted["error"]
        else:
            assert all(sorted(req["degraded"]) == sorted(EXPECT[case]) for req in faulted)
            assert all(req["texts"] for req in faulted)
    if case == "store_fault_stale":
        assert all(req["tier"] == "stale" for req in tsteps["faulted"])
        assert "injected fault at 'store'" in tsteps["no_stale"]["error"]
    if case in ("clean", "rerank"):
        assert all(req["tier"] == "semantic" for req in tsteps["semantic"])
        assert all(req["tier"] == "exact" for req in tsteps["exact_alias"])
        # The stale exact entries; with a reranker the smaller-k re-ranks
        # were admitted with ring slots too.
        assert tcount["invalidations"] == (2 if case == "clean" else 4)
        if case == "rerank":
            assert ("rerank", {"batch_size": len(QUERIES), "ok": True}) in cold[0]["stages"]


def test_factory_chain_matches_reference(monkeypatch, tmp_path):
    """The chain built from one APP_* overlay by each package's factory:
    the same retriever knobs and cache, and the same answers through the
    process-wide micro-batcher, on the hash embedder over the memory and
    the exact stores."""
    for key in [k for k in os.environ if k.startswith("APP_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", "32")
    monkeypatch.setenv("APP_RETRIEVER_SCORETHRESHOLD", "-1")
    texts = [f"document number {i} about subject {i % 5}" for i in range(40)]
    for backend in ("memory", "tpu"):
        monkeypatch.setenv("APP_VECTORSTORE_NAME", backend)
        monkeypatch.setenv("APP_VECTORSTORE_INDEXTYPE", "exact")
        answers = {}
        for name, p in P.items():
            p.configuration.reset_config_cache()
            _reset(p)
            kw = {"device": "cpu"} if name == "torch" else {}
            r = p.factory.get_retriever(**kw)
            assert r is p.factory.get_retriever(**kw) and p.factory.peek_store() is r.store
            assert p.factory.peek_retrieval_cache() is r.cache and r.reranker is None
            r.store.add([p.Chunk(text=t, source="s", id=str(i)) for i, t in enumerate(texts)],
                        r.embedder.embed_documents(texts))
            batcher = p.factory.get_retrieval_batcher(**kw)
            results = []
            for q, k in (("subject 3", 4), ("document number 7", 2), ("subject 3", 4)):
                log, clog, tr = p.DegradeLog(), p.CacheLog(), p.RequestTrace()
                hits = batcher.call((q, k, log, clog, tr), timeout=30)
                results.append(([h.chunk.text for h in hits], [round(h.score, 5) for h in hits], log.stages(),
                                clog.tier, [s["stage"] for s in tr.stages()]))
            knobs = (r.top_k, r.score_threshold, r.fetch_k_multiplier, r.min_rerank_budget_ms,
                     r.min_full_k_budget_ms, r.cache_serve_stale, r.cache.max_entries, r.cache.similarity_threshold,
                     type(r.store).__name__.replace("TPU", "X").replace("GPU", "X"))
            answers[name] = (results, knobs, p.cache_snapshot()["hits"], p.cache_snapshot()["misses"])
            _reset(p)
            p.configuration.reset_config_cache()
        assert answers["torch"] == answers["jax"], backend
        assert answers["torch"][0][2][3] == "exact"


@pytest.mark.parametrize("env", [
    {"APP_VECTORSTORE_NAME": "tpu-ivf"}, {"APP_VECTORSTORE_NAME": "fabric"}, {"APP_VECTORSTORE_NAME": "native"},
    {"APP_VECTORSTORE_NAME": "milvus"}, {"APP_VECTORSTORE_NAME": "elasticsearch"},
    {"APP_VECTORSTORE_NAME": "pgvector"}, {"APP_VECTORSTORE_NAME": "auto"},
    {"APP_VECTORSTORE_QUANTIZATION": "int8"}, {"APP_VECTORSTORE_QUANTIZATION": "pq"},
    {"APP_DURABILITY_ENABLED": "true"}, {"APP_EMBEDDINGS_MODELENGINE": "huggingface"},
])
def test_unported_backends_raise_with_their_roadmap_item(env, monkeypatch):
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", "32")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    tconfiguration.reset_config_cache()
    try:
        with pytest.raises(NotImplementedError, match=r"ROADMAP.md, Queue 1 item \d"):
            tfactory.get_retriever(device="cpu")
    finally:
        tconfiguration.reset_config_cache()
        tfactory.reset_factories()


def test_provisioned_checkpoint_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("GAIE_WEIGHTS_DIR", str(tmp_path))
    (tmp_path / "snowflake--snowflake-arctic-embed-l").mkdir()
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "tpu")
    monkeypatch.setenv("APP_EMBEDDINGS_MODELNAME", "snowflake/snowflake-arctic-embed-l")
    tconfiguration.reset_config_cache()
    try:
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            tfactory.get_embedder(device="cpu")
    finally:
        tconfiguration.reset_config_cache()
        tfactory.reset_factories()
