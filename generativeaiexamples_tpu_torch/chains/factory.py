"""Lazy singletons for the chains (port of the JAX package's
``chains/factory.py``).

``get_chat_llm``, ``get_embedder``, ``get_store``, ``get_reranker``,
``get_splitter``, ``get_retriever``, ``get_retrieval_cache`` and
``get_retrieval_batcher`` build one shared instance per process from
``get_config()``, so the pipelines of a process share one engine, one
embedder, one store and one micro-batcher.  Engine names are the
reference's: ``tpu`` means this package's device implementation on the
card (``GPUChatLLM``, ``GPUEmbedder``, ``GPUVectorStore``,
``GPUReranker``), ``huggingface`` sentence-transformers (``STEmbedder``),
``openai`` an HTTP client, and ``echo`` / ``hash`` the fakes.

Each factory function takes ``device`` like every other entry point of the
port: ``None`` is the card, ``"cpu"`` the CPU; the first build of a
singleton fixes its device.  ``get_ingest_pipeline`` (the bulk path),
``get_collection_manager`` (named collections, the ``default`` one being
the ``get_store`` singleton), ``get_memory_store`` (the multi-turn chain's
conversation store) and, with ``durability.enabled``, the write-ahead
logged store, the ingest journal and ``shutdown_durability`` follow the
reference.
"""

from __future__ import annotations

import threading
from typing import Sequence

from generativeaiexamples_tpu_torch.core.configuration import get_config
from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

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


def _checkpoint_refused(model_name: str) -> None:
    """The chain LLM loads no checkpoint: the reference's ``TPUChatLLM``
    never does (it serves random weights whatever is provisioned), and the
    port refuses rather than quietly serve random weights beside one."""
    from generativeaiexamples_tpu_torch.engine.weights import weights_dir_for

    ckpt_dir = weights_dir_for(model_name)
    if ckpt_dir:
        raise NotImplementedError(
            f"the in-process chain LLM does not load the provisioned checkpoint {ckpt_dir}: the reference's "
            "TPUChatLLM never loads one (a deliberate difference, ROADMAP.md, Queue 1 item 5); serve it with "
            "the engine server (python -m generativeaiexamples_tpu_torch.engine.server) and set "
            "llm.model_engine to openai"
        )


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

        _checkpoint_refused(cfg.llm.model_name)
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


def _build_embedder(device):
    cfg = get_config()
    engine = cfg.embeddings.model_engine.lower()
    if engine == "hash":
        from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder

        return HashEmbedder(dimensions=cfg.embeddings.dimensions)
    if engine == "huggingface":
        from generativeaiexamples_tpu_torch.engine.embedder import STEmbedder

        return STEmbedder(cfg.embeddings.model_name, cfg.embeddings.dimensions, device=device)
    if engine == "openai":
        from generativeaiexamples_tpu_torch.engine.embedder_client import HTTPEmbedder

        return HTTPEmbedder(cfg.embeddings.server_url, cfg.embeddings.model_name, cfg.embeddings.dimensions)
    if engine == "tpu":
        from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
        from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
        from generativeaiexamples_tpu_torch.engine.weights import bert_config_from_hf, load_hf_bert, weights_dir_for
        from generativeaiexamples_tpu_torch.models import bert

        ckpt_dir = weights_dir_for(cfg.embeddings.model_name)
        if ckpt_dir:
            # Provisioned arctic-embed-l-class weights and their WordPiece vocab.
            bcfg = bert_config_from_hf(ckpt_dir)
            if bcfg.d_model != cfg.embeddings.dimensions:
                raise ValueError(
                    f"provisioned embedder checkpoint {ckpt_dir} has hidden_size={bcfg.d_model} but "
                    f"embeddings.dimensions={cfg.embeddings.dimensions}; the vector store would be sized wrong "
                    "— fix APP_EMBEDDINGS_DIMENSIONS"
                )
            params = load_hf_bert(bcfg, ckpt_dir, device=device)
            return GPUEmbedder(bcfg, params, tokenizer=get_tokenizer(ckpt_dir), device=device)
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
    store = get_vector_store(cfg, device=device)
    if cfg.durability.enabled:
        store = _wrap_durable(store, cfg)
    return store


def get_store(device=None):
    """Configured vector store singleton (reference ``get_store``).

    With ``durability.enabled`` the backend is wrapped in a
    :class:`DurableVectorStore`: construction itself performs crash
    recovery (snapshot restore onto ``device`` + WAL tail replay), and
    every mutation from then on is write-ahead logged."""
    return _singleton("store", _build_store, device)


def _wrap_durable(store, cfg, subdir: str = "store"):
    import os

    from generativeaiexamples_tpu_torch.durability.store import DurableVectorStore
    from generativeaiexamples_tpu_torch.retrieval.base import VectorStore

    if type(store).save is VectorStore.save:
        # A backend without a save() path: wrapping it would snapshot nothing.
        logger.warning("durability.enabled but %s has no save() path; store runs without a WAL", type(store).__name__)
        return store
    return DurableVectorStore(
        store,
        os.path.join(cfg.durability.directory, subdir),
        fsync_every=cfg.durability.fsync_every,
        snapshot_every_records=cfg.durability.snapshot_every_records,
        keep_snapshots=cfg.durability.keep_snapshots,
    )


def peek_store():
    """The store singleton IF one has been created, else None: a metrics
    scrape must never build the store."""
    return _peek("store")


def _build_collection_manager(device):
    from generativeaiexamples_tpu_torch.retrieval.fabric.collections import CollectionManager
    from generativeaiexamples_tpu_torch.retrieval.factory import get_vector_store

    cfg = get_config()

    def _store_factory(name: str, overrides: dict):
        store = get_vector_store(cfg, device=device, collection=name, overrides=overrides)
        if cfg.durability.enabled:
            # Per-collection WAL/snapshot directory: tenant A's ingest never
            # rewrites tenant B's recovery artifacts.
            store = _wrap_durable(store, cfg, subdir=f"collections/{name}")
        return store

    return CollectionManager(
        _store_factory,
        default_store=lambda: get_store(device),
        max_collections=cfg.collections.max_collections,
        default_max_rows=cfg.collections.max_rows_per_collection,
        default_max_bytes=cfg.collections.max_bytes_per_collection,
    )


def get_collection_manager(device=None):
    """Process-wide :class:`CollectionManager` over the store factory: named
    collections get their own stores on ``device`` (and their own WAL
    directory with durability on); the ``default`` collection IS the
    :func:`get_store` singleton, so nothing is double counted."""
    return _singleton("collections", _build_collection_manager, device)


def peek_collection_manager():
    """The live manager if one was ever built, else None: /metrics exports
    the ``rag_collection_*`` zeros without building anything."""
    return _peek("collections")


def get_memory_store(device=None):
    """Separate store for conversation memory (the multi-turn chain's second
    collection): another ``GPUVectorStore`` on ``device``."""

    def build(dev):
        from generativeaiexamples_tpu_torch.retrieval.factory import get_vector_store

        return get_vector_store(get_config(), device=dev, collection="memory")

    return _singleton("memory_store", build, device)


def _build_ingest_pipeline(device):
    import os

    from generativeaiexamples_tpu_torch.ingest.loaders import load_document
    from generativeaiexamples_tpu_torch.ingest.pipeline import IngestPipeline
    from generativeaiexamples_tpu_torch.retrieval.base import Chunk
    from generativeaiexamples_tpu_torch.retrieval.fabric.collections import DEFAULT_COLLECTION

    cfg = get_config()

    def _parse(path: str, filename: str) -> list:
        return [Chunk(text=p, source=filename) for p in get_splitter().split(load_document(path))]

    journal = durable_flush_fn = None
    if cfg.durability.enabled:
        from generativeaiexamples_tpu_torch.durability.journal import IngestJournal
        from generativeaiexamples_tpu_torch.durability.store import DurableVectorStore

        os.makedirs(cfg.durability.directory, exist_ok=True)
        journal = IngestJournal(os.path.join(cfg.durability.directory, "ingest-journal.log"))
        store = get_store(device)
        if isinstance(store, DurableVectorStore):
            durable_flush_fn = store.flush

    def _admit(chunks, embs):
        # Quota gate at ingest admission: refuse BEFORE the store mutates
        # (CollectionQuotaExceeded isolates to the file).
        get_collection_manager(device).admit(DEFAULT_COLLECTION, len(chunks), sum(len(e) * 4 for e in embs))

    pipeline = IngestPipeline(
        parse_fn=_parse,
        embed_fn=lambda texts: get_embedder(device).embed_documents(texts),
        append_fn=lambda chunks, embs: get_store(device).add(chunks, embs),
        admit_fn=_admit,
        parse_workers=cfg.ingest.parse_workers,
        embed_batch_chunks=cfg.ingest.embed_batch_chunks,
        append_batch_chunks=cfg.ingest.append_batch_chunks,
        queue_depth=cfg.ingest.queue_depth,
        delete_files=True,  # bulk uploads stream to unique temp paths
        journal=journal,
        delete_source_fn=lambda source: get_store(device).delete_source(source),
        durable_flush_fn=durable_flush_fn,
    )
    if journal is not None and cfg.durability.resume_jobs:
        try:
            journal.compact()
            resumed = pipeline.resume()
            if resumed:
                logger.info("resumed %d interrupted ingest job(s)", len(resumed))
        except Exception:
            logger.exception("ingest job resume failed")
    return pipeline


def get_ingest_pipeline(device=None):
    """Process-wide bulk-ingestion pipeline (``ingest/pipeline.py``) over the
    singleton splitter, embedder and store on ``device``: parse/split on a
    CPU pool, chunks coalesced into shared embed dispatches, O(new rows)
    store appends.  With durability on it journals its jobs and, when
    built, resumes the ones a restart interrupted."""
    return _singleton("ingest", _build_ingest_pipeline, device)


def peek_ingest_pipeline():
    """The live pipeline if one was ever built, else None: /metrics exports
    the ``ingest_*`` zeros without building the embedder stack."""
    return _peek("ingest")


def shutdown_durability() -> None:
    """Graceful-shutdown hook: drain queued ingest work, close the journal,
    flush the WAL and (per ``durability.final_snapshot_on_shutdown``) cut a
    final snapshot so the next boot replays nothing.  Touches only
    singletons that already exist."""
    from generativeaiexamples_tpu_torch.durability.store import DurableVectorStore

    pipeline = peek_ingest_pipeline()
    if pipeline is not None:
        try:
            pipeline.close()
        except Exception:
            logger.exception("ingest pipeline drain failed during shutdown")
        if pipeline.journal is not None:
            try:
                pipeline.journal.close()
            except Exception:
                logger.exception("ingest journal close failed during shutdown")
    store = peek_store()
    if isinstance(store, DurableVectorStore):
        try:
            store.close(final_snapshot=get_config().durability.final_snapshot_on_shutdown)
        except Exception:
            logger.exception("durable store close failed during shutdown")


def _build_reranker(device):
    cfg = get_config()
    engine = cfg.ranking.model_engine.lower()
    if engine in ("", "none"):
        return None
    if engine == "tpu":
        from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker
        from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
        from generativeaiexamples_tpu_torch.engine.weights import (
            bert_config_from_hf,
            load_hf_cross_encoder,
            weights_dir_for,
        )

        ckpt_dir = weights_dir_for(cfg.ranking.model_name)
        if ckpt_dir:
            bcfg = bert_config_from_hf(ckpt_dir)
            params, head = load_hf_cross_encoder(bcfg, ckpt_dir, device=device)
            return GPUReranker(bcfg, params, head, tokenizer=get_tokenizer(ckpt_dir), device=device)
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
    What is dropped is closed as the reference closes it: the batcher's
    worker and the chat LLM's scheduler thread stop, the ingest pipeline
    drains and its journal closes, the named collections are dropped, a
    durable store closes its WAL without a final snapshot (a recovery
    test needs the WAL tail exactly as its scenario left it), and a
    sharded store stops its fan-out workers."""
    from generativeaiexamples_tpu_torch.cache.metrics import reset_cache_metrics
    from generativeaiexamples_tpu_torch.durability.metrics import reset_durability_metrics
    from generativeaiexamples_tpu_torch.durability.store import DurableVectorStore
    from generativeaiexamples_tpu_torch.obs import reset_obs
    from generativeaiexamples_tpu_torch.resilience.metrics import reset_resilience
    from generativeaiexamples_tpu_torch.retrieval.fabric.sharded import ShardedVectorStore

    reset_resilience()
    reset_cache_metrics()
    reset_durability_metrics()
    reset_obs()
    with _LOCK:
        dropped = {n: _STATE.pop(n) for n in list(_STATE) if n not in keep}
    for name in ("batcher", "chat_llm", "ingest"):
        if hasattr(dropped.get(name), "close"):
            dropped[name].close()
    if getattr(dropped.get("ingest"), "journal", None) is not None:
        dropped["ingest"].journal.close()
    if dropped.get("collections") is not None:
        dropped["collections"].close()
    store = dropped.get("store")
    if isinstance(store, DurableVectorStore):
        store.close(final_snapshot=False)
    # A sharded store owns fan-out worker threads: stop them.
    inner = getattr(store, "_inner", store)
    if isinstance(inner, ShardedVectorStore):
        inner.close()
