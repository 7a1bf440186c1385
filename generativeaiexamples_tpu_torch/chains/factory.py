"""Lazy singletons for the chains (port of the JAX package's
``chains/factory.py``).

``get_chat_llm``, ``get_embedder``, ``get_store``, ``get_reranker``,
``get_splitter``, ``get_retriever``, ``get_retrieval_cache`` and
``get_retrieval_batcher`` build one shared instance per process from
``get_config()``, so the pipelines of a process share one engine, one
embedder, one store and one micro-batcher.  Engine names are the
reference's: ``tpu`` means this package's device implementation on the
card (``GPUChatLLM``, ``GPUEmbedder``, ``GPUVectorStore``,
``GPUReranker``), ``openai`` an HTTP client, and ``echo`` / ``hash`` the
fakes.

Each factory function takes ``device`` like every other entry point of the
port: ``None`` is the card, ``"cpu"`` the CPU; the first build of a
singleton fixes its device.  The bulk-ingest pipeline, the named
collections, the conversation-memory store and durability are not ported
(``ROADMAP.md``, Queue 1): their factories raise.
"""

from __future__ import annotations

import threading
from typing import Sequence

from generativeaiexamples_tpu_torch.core.configuration import get_config

# Built singletons by name.  Not lru_cached: a factory takes a device, and
# reset_factories must close the batcher's worker thread.  Re-entrant:
# get_retriever builds the store, embedder, reranker and cache under it.
_LOCK = threading.RLock()
_STATE: dict = {}


def _singleton(name: str, build, device):
    with _LOCK:
        if name not in _STATE:
            _STATE[name] = build(device)
        return _STATE[name]


def _peek(name: str):
    with _LOCK:
        return _STATE.get(name)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet (ROADMAP.md, Queue 1 {item})")


def _checkpoint_refused(model_name: str, what: str) -> None:
    from generativeaiexamples_tpu_torch.engine.weights import weights_dir_for

    ckpt_dir = weights_dir_for(model_name)
    if ckpt_dir:
        raise _not_ported(f"loading the provisioned {what} checkpoint {ckpt_dir}", "item 5 (HF weights)")


def _build_chat_llm(device):
    cfg = get_config()
    engine = cfg.llm.model_engine.lower()
    if engine == "echo":
        from generativeaiexamples_tpu_torch.chains.llm import EchoChatLLM

        return EchoChatLLM()
    if engine == "openai":
        from generativeaiexamples_tpu_torch.chains.llm import OpenAIChatLLM

        base = cfg.llm.server_url or "http://localhost:8000/v1"
        if not base.startswith("http"):
            base = f"http://{base}/v1"
        return OpenAIChatLLM(base_url=base, model=cfg.llm.model_name)
    if engine == "tpu":
        from generativeaiexamples_tpu_torch.chains.llm import GPUChatLLM
        from generativeaiexamples_tpu_torch.engine.weights import resolve_model_preset

        _checkpoint_refused(cfg.llm.model_name, "LLM")
        return GPUChatLLM(model_preset=resolve_model_preset(cfg.llm.model_name), device=device)
    raise ValueError(f"unknown llm.model_engine {cfg.llm.model_engine!r}")


def get_chat_llm(device=None):
    """Configured chat LLM (reference ``get_chat_llm``): ``tpu`` is
    :class:`GPUChatLLM`, the in-process engine on ``device``."""
    return _singleton("chat_llm", _build_chat_llm, device)


def peek_chat_llm():
    """The chat LLM IF one has been built, else None."""
    return _peek("chat_llm")


def get_splitter():
    """The configured ingestion splitter (``ingest/splitters.py``)."""

    def build(_device):
        from generativeaiexamples_tpu_torch.ingest.splitters import get_text_splitter

        return get_text_splitter(get_config())

    return _singleton("splitter", build, None)


def get_ingest_pipeline():
    raise _not_ported("the bulk-ingest pipeline (ingest/pipeline.py, POST /documents/bulk)", "item 2")


def get_collection_manager():
    raise _not_ported("named collections (retrieval/fabric/)", "item 8")


def get_memory_store():
    raise _not_ported("the conversation-memory store of the multi-turn chain", "item 2")


def shutdown_durability() -> None:
    raise _not_ported("durability (the write-ahead-logged store and the ingest journal)", "item 2")


def _build_embedder(device):
    cfg = get_config()
    engine = cfg.embeddings.model_engine.lower()
    if engine == "hash":
        from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder

        return HashEmbedder(dimensions=cfg.embeddings.dimensions)
    if engine == "huggingface":
        raise _not_ported("embeddings.model_engine 'huggingface' (STEmbedder)", "item 8")
    if engine == "openai":
        from generativeaiexamples_tpu_torch.engine.embedder_client import HTTPEmbedder

        return HTTPEmbedder(cfg.embeddings.server_url, cfg.embeddings.model_name, cfg.embeddings.dimensions)
    if engine == "tpu":
        from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
        from generativeaiexamples_tpu_torch.models import bert

        _checkpoint_refused(cfg.embeddings.model_name, "embedder")
        if cfg.embeddings.dimensions == 1024:
            bcfg = bert.arctic_embed_l()
        else:
            bcfg = bert.bert_tiny(d_model=cfg.embeddings.dimensions)
        return GPUEmbedder(bcfg, device=device)
    raise ValueError(f"unknown embeddings.model_engine {cfg.embeddings.model_engine!r}")


def get_embedder(device=None):
    """Configured embedder (reference ``get_embedder``)."""
    return _singleton("embedder", _build_embedder, device)


def _build_store(device):
    from generativeaiexamples_tpu_torch.retrieval.factory import get_vector_store

    cfg = get_config()
    if cfg.durability.enabled:
        raise _not_ported("durability.enabled (the write-ahead-logged store)", "item 2")
    return get_vector_store(cfg, device=device)


def get_store(device=None):
    """Configured vector store singleton (reference ``get_store``)."""
    return _singleton("store", _build_store, device)


def peek_store():
    """The store singleton IF one has been created, else None: a metrics
    scrape must never build the store."""
    return _peek("store")


def _build_reranker(device):
    cfg = get_config()
    engine = cfg.ranking.model_engine.lower()
    if engine in ("", "none"):
        return None
    if engine == "tpu":
        from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker

        _checkpoint_refused(cfg.ranking.model_name, "reranker")
        return GPUReranker(device=device)
    raise ValueError(f"unknown ranking.model_engine {cfg.ranking.model_engine!r}")


def get_reranker(device=None):
    """Configured cross-encoder, or None (``ranking.model_engine`` 'none',
    the default)."""
    return _singleton("reranker", _build_reranker, device)


def _build_retriever(device):
    from generativeaiexamples_tpu_torch.resilience.retry import policy_from_config
    from generativeaiexamples_tpu_torch.retrieval.retriever import Retriever

    cfg = get_config()
    return Retriever(
        store=get_store(device),
        embedder=get_embedder(device),
        top_k=cfg.retriever.top_k,
        score_threshold=cfg.retriever.score_threshold,
        fetch_k_multiplier=cfg.retriever.fetch_k_multiplier,
        reranker=get_reranker(device),
        min_rerank_budget_ms=cfg.resilience.min_rerank_budget_ms,
        min_full_k_budget_ms=cfg.resilience.min_full_k_budget_ms,
        embed_retry=policy_from_config("embed"),
        search_retry=policy_from_config("store-search"),
        cache=get_retrieval_cache(device),
        cache_serve_stale=cfg.cache.serve_stale,
    )


def get_retriever(device=None):
    """Shared Retriever over the singleton store, embedder, reranker and
    cache: cross-request micro-batching only coalesces calls that reach
    the SAME retriever."""
    return _singleton("retriever", _build_retriever, device)


def _build_cache(device):
    cfg = get_config()
    if not cfg.cache.enabled:
        return None
    from generativeaiexamples_tpu_torch.cache.core import RetrievalCache

    return RetrievalCache(
        cfg.embeddings.dimensions,
        max_entries=cfg.cache.max_entries,
        semantic_entries=cfg.cache.semantic_entries,
        similarity_threshold=cfg.cache.similarity_threshold,
        semantic_enabled=cfg.cache.semantic_enabled,
        device=device,
    )


def get_retrieval_cache(device=None):
    """Process-wide two-tier result cache (its semantic ring on
    ``device``), or None when ``cache.enabled`` is off."""
    return _singleton("cache", _build_cache, device)


def peek_retrieval_cache():
    """The live cache if one was ever built, else None."""
    return _peek("cache")


def _build_batcher(device):
    cfg = get_config()
    if cfg.retriever.batch_max_size <= 1:
        return None
    from generativeaiexamples_tpu_torch.engine.microbatch import MicroBatcher

    def _retrieve_batch(items):
        retriever = get_retriever(device)
        ks = [k for _, k, _, _, _ in items]
        # One shared search at the widest k; each caller keeps its own
        # prefix (top-k_i of top-k_max == top-k_i).
        many = retriever.retrieve_many(
            [q for q, _, _, _, _ in items],
            top_k=max(ks),
            degrade_logs=[log for _, _, log, _, _ in items],
            cache_logs=[clog for _, _, _, clog, _ in items],
            traces=[trace for _, _, _, _, trace in items],
        )
        return [hits[:k] for hits, (_, k, _, _, _) in zip(many, items)]

    return MicroBatcher(
        _retrieve_batch,
        max_batch=cfg.retriever.batch_max_size,
        max_wait_ms=cfg.retriever.batch_wait_ms,
        name="rag-retrieve",
    )


def get_retrieval_batcher(device=None):
    """Process-wide micro-batcher over ``get_retriever().retrieve_many``.

    Items are ``(query, top_k, degrade_log, cache_log, trace)`` tuples;
    concurrent callers within one ``batch_wait_ms`` window share one
    embed, search and rerank dispatch chain.  Deadlines ride the queue
    entries and the batch runs under the loosest member's.  Returns None
    when ``retriever.batch_max_size`` <= 1 (batching off).
    """
    return _singleton("batcher", _build_batcher, device)


def reset_factories(keep: Sequence[str] = ()) -> None:
    """Testing hook: drop the singletons and zero the counters (pairs with
    ``reset_config_cache``).  ``keep`` names singletons to carry over
    (``"store"``, ``"embedder"``, ``"chat_llm"``, ...), so a chain can be
    rebuilt under a new config over a store and an engine already loaded.
    The dropped batcher's worker and chat LLM's scheduler thread stop."""
    from generativeaiexamples_tpu_torch.cache.metrics import reset_cache_metrics
    from generativeaiexamples_tpu_torch.obs import reset_obs
    from generativeaiexamples_tpu_torch.resilience.metrics import reset_resilience

    reset_resilience()
    reset_cache_metrics()
    reset_obs()
    with _LOCK:
        dropped = {n: _STATE.pop(n) for n in list(_STATE) if n not in keep}
    # Stop the worker threads of what was dropped: the batcher's, and the
    # chat LLM's scheduler tick.
    for name in ("batcher", "chat_llm"):
        if hasattr(dropped.get(name), "close"):
            dropped[name].close()
