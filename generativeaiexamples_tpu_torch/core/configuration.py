"""Application config schema for the chain server (a copy of the JAX
package's ``core/configuration.py``: one config file or ``APP_*`` overlay
drives both packages, with the same defaults; engine names such as ``tpu``
mean this package's device implementations on the card).

Capability-parity with the reference schema
(``RetrievalAugmentedGeneration/common/configuration.py:20-258``), keeping
the same env-var surface (``APP_VECTORSTORE_URL``, ``APP_LLM_MODELNAME``,
``APP_EMBEDDINGS_DIMENSIONS``, ...) so existing compose files port
unchanged — while defaults point at the TPU-native engine rather than
NVIDIA API endpoints.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

from generativeaiexamples_tpu_torch.core.config import configclass, configfield, load_config


@configclass
class VectorStoreConfig:
    """Vector store selection (reference ``configuration.py:20-47``)."""

    name: str = configfield(
        "Vector store backend: 'tpu' (exact top-k on TPU), 'native' (C++ CPU "
        "library), 'memory' (numpy), 'milvus', or 'pgvector'.",
        default="tpu",
    )
    url: str = configfield(
        "URL of an external vector-store service (milvus/pgvector). Unused "
        "by the in-process backends.",
        default="",
    )
    nlist: int = configfield("Number of IVF cluster lists (ivf index only).", default=64)
    nprobe: int = configfield("Number of IVF lists probed per query.", default=16)
    index_type: str = configfield("Index type: 'exact' or 'ivf'.", default="exact")
    retrain_growth: float = configfield(
        "IVF re-train growth threshold: a full k-means re-train fires "
        "only once the live row count reaches this multiple of the count "
        "at the last train (appends in between assign to the frozen "
        "centroids and stay exactly searchable from the staging tail).",
        default=2.0,
    )
    quantization: str = configfield(
        "Compressed scoring for the TPU stores: 'none' (full-width scan), "
        "'int8' (per-row symmetric quantization, ~recall 1.0), or 'pq' "
        "(product quantization, pq_m bytes/row). Both quantized modes run "
        "a two-stage search: approx_max_k over compressed scores picks "
        "top_k*rescore_multiplier candidates, then only those rows are "
        "rescored at full width.",
        default="none",
    )
    pq_m: int = configfield(
        "PQ subspace count (quantization='pq'): bytes per compressed row; "
        "must divide the embedding dimension. Higher = better recall, "
        "more bytes scanned.",
        default=16,
    )
    rescore_multiplier: int = configfield(
        "Two-stage oversample factor: stage one selects "
        "top_k*rescore_multiplier compressed candidates for exact rescore. "
        "The main recall lever for quantized search (int8 saturates at 4; "
        "pq typically wants 8+). Stores smaller than top_k*"
        "rescore_multiplier skip stage one and serve exact top-k.",
        default=4,
    )
    recall_target: float = configfield(
        "approx_max_k recall target for the stage-one compressed scan "
        "(TPU-side binned reduction; exact on CPU).",
        default=0.95,
    )


@configclass
class FabricConfig:
    """Sharded scatter-gather retrieval fabric (``docs/sharded-retrieval.md``).

    Selected with ``vector_store.name='fabric'``: one logical store over
    ``num_shards`` hash-routed partitions, parallel fan-out search with
    an exact-score top-k merge, and an optional host-RAM PQ cold tier
    capped by ``hot_shard_budget``.
    """

    num_shards: int = configfield(
        "Partition count: rows hash-route (stable crc32 of the chunk id) "
        "to one of this many child stores; queries fan out to all of "
        "them.",
        default=4,
    )
    child_backend: str = configfield(
        "Backend for each shard's child store: 'auto' picks the "
        "platform's fastest in-process store (the vector_store.name "
        "policy), or pin 'memory'/'tpu'/'tpu-ivf'.",
        default="auto",
    )
    margin: int = configfield(
        "Additive slack on the per-shard candidate quota "
        "ceil(k*rescore_multiplier/num_shards) + margin; the quota is "
        "floored at k so exact-mode merges stay bit-equivalent to a "
        "single-store scan.",
        default=8,
    )
    fanout_max_batch: int = configfield(
        "Per-shard fan-out micro-batcher dispatch cap: concurrent "
        "fabric searches landing on one shard coalesce into one child "
        "search_batch up to this size.",
        default=32,
    )
    fanout_wait_ms: float = configfield(
        "How long a fan-out dispatch waits for batch-mates before "
        "going alone (the latency the batcher may add to an idle "
        "query).",
        default=0.5,
    )
    hot_shard_budget: int = configfield(
        "Max shards kept HBM-resident; the rest demote to the host-RAM "
        "PQ cold tier, lowest hit-EWMA first. 0 disables the cold tier "
        "(every shard stays hot).",
        default=0,
    )
    ewma_alpha: float = configfield(
        "Per-shard hit-rate EWMA smoothing (the promotion/demotion "
        "signal): fraction of each query's final top-k the shard "
        "contributed, folded in at this weight.",
        default=0.2,
    )


@configclass
class CollectionsConfig:
    """Named multi-tenant collections (``docs/sharded-retrieval.md``).

    Each collection is an independent vector store with its own
    quantization mode, mutation-version counter (result cache and WAL
    compose per collection) and ingest-admission quotas.
    """

    max_collections: int = configfield(
        "Cap on named collections per process (also the /metrics label "
        "cardinality bound before the 64-label fold).",
        default=64,
    )
    max_rows_per_collection: int = configfield(
        "Default per-collection row quota enforced at ingest admission "
        "(0 = unlimited; per-collection overrides win).",
        default=0,
    )
    max_bytes_per_collection: int = configfield(
        "Default per-collection store-byte quota (device + host bytes) "
        "enforced at ingest admission (0 = unlimited).",
        default=0,
    )


@configclass
class LLMConfig:
    """LLM engine selection (reference ``configuration.py:50-77``)."""

    server_url: str = configfield(
        "host:port of an already-running generation engine; empty means "
        "serve in-process.",
        default="",
    )
    model_name: str = configfield(
        "Chat model to serve.", default="meta-llama/Meta-Llama-3-8B-Instruct"
    )
    model_engine: str = configfield(
        "Backend implementation: 'tpu' (in-process JAX engine), 'openai' "
        "(any OpenAI-compatible HTTP endpoint), or 'echo' (hermetic fake "
        "for tests).",
        default="tpu",
    )
    spec_decode: bool = configfield(
        "Enable speculative decoding in the serving scheduler (config "
        "twin of the engine server's --spec-decode flag): draft-model "
        "draft/verify when draft_model is set, prompt-lookup (n-gram) "
        "speculation otherwise. Always distribution-preserving.",
        default=False,
    )
    draft_model: str = configfield(
        "Draft model preset/HF id for speculative decoding; empty means "
        "no draft model (spec_decode falls back to prompt-lookup).",
        default="",
    )
    spec_gamma: int = configfield(
        "Maximum speculation lookahead (draft tokens per round); 0 means "
        "use the engine server's --gamma default. The per-request "
        "acceptance-adaptive controller only ever shrinks below this.",
        default=0,
    )
    matmul_kernel: str = configfield(
        "Serving matmul path (config twin of the engine server's "
        "--matmul-kernel flag): 'xla' streams weight-only int8 through "
        "XLA's fused convert-dot; 'pallas_w8a8' pre-blocks int8 "
        "projections at load and decodes through the streaming W8A8 "
        "Pallas kernel (native s8xs8 MXU dot), falling back to a "
        "bit-identical XLA twin off-TPU.",
        default="xla",
    )
    kv_layout: str = configfield(
        "KV cache layout (config twin of the engine server's "
        "--kv-layout flag): 'contiguous' gives each slot a dense "
        "max_len window; 'paged' carves KV into fixed-size int8 pages "
        "behind per-lane page tables — zero-copy prefix grafts (a "
        "page-table row write plus refcount bumps), copy-on-write "
        "sharing, slot-free parked segments, and per-lane attention "
        "windows.  Requires kv_dtype='int8' and a single chip.",
        default="contiguous",
    )
    kv_page_size: int = configfield(
        "Tokens per KV page when kv_layout='paged' (power of two). "
        "Smaller pages track ragged lengths more tightly (less read "
        "amplification, finer parked accounting) at the cost of wider "
        "page tables; the paged kernel engages for sizes that divide "
        "128 (>= 32) or are multiples of it.  64 balances both.",
        default=64,
    )


@configclass
class TextSplitterConfig:
    """Token-aware splitter settings (reference ``configuration.py:79-101``)."""

    model_name: str = configfield(
        "Tokenizer used for token-aware chunking.",
        default="Snowflake/snowflake-arctic-embed-l",
    )
    chunk_size: int = configfield("Chunk size in tokens.", default=510)
    chunk_overlap: int = configfield("Overlap between adjacent chunks, in tokens.", default=200)


@configclass
class EmbeddingConfig:
    """Embedder selection (reference ``configuration.py:104-130``)."""

    model_name: str = configfield(
        "Embedding model.", default="Snowflake/snowflake-arctic-embed-l"
    )
    model_engine: str = configfield(
        "Backend: 'tpu' (in-process JAX), 'openai' (HTTP /v1/embeddings), "
        "'huggingface' (CPU sentence-transformers), or 'hash' (hermetic fake).",
        default="tpu",
    )
    dimensions: int = configfield("Embedding dimensionality.", default=1024)
    server_url: str = configfield(
        "host:port of an external embedding service; empty means in-process.",
        default="",
    )


@configclass
class RankingConfig:
    """Cross-encoder reranker (reference NeMo reranking microservice)."""

    model_name: str = configfield("Reranker model.", default="cross-encoder-rerank")
    model_engine: str = configfield("Backend: 'tpu', 'openai', or 'none'.", default="none")
    server_url: str = configfield("host:port of an external reranking service.", default="")


@configclass
class VLMConfig:
    """Vision-language model used during multimodal ingestion (the
    reference's Neva-22B / DePlot calls,
    ``multimodal_rag/vectorstore/custom_pdf_parser.py:42-71``)."""

    model_name: str = configfield("VLM checkpoint to serve.", default="vlm-tiny")
    model_engine: str = configfield(
        "Backend: 'tpu' (in-process JAX ViT+llama VLM) or 'heuristic' "
        "(deterministic pixel-statistics analyst; hermetic fallback).",
        default="heuristic",
    )


@configclass
class RetrieverConfig:
    """Retrieval knobs (reference ``configuration.py:133-160``)."""

    top_k: int = configfield("Number of chunks retrieved per query.", default=4)
    score_threshold: float = configfield(
        "Minimum similarity score for a retrieved chunk.", default=0.25
    )
    fetch_k_multiplier: int = configfield(
        "Over-fetch multiplier when a reranker is active: the vector "
        "search returns top_k * this many candidates for the "
        "cross-encoder to re-order.",
        default=4,
    )
    batch_max_size: int = configfield(
        "Micro-batch cap for cross-request retrieval coalescing: up to "
        "this many concurrent /search-or-/generate retrievals share one "
        "embed+search+rerank device dispatch. 0 or 1 disables batching.",
        default=32,
    )
    batch_wait_ms: float = configfield(
        "How long a retrieval call waits for batch-mates before its "
        "micro-batch dispatches anyway (the max latency batching can add "
        "to an idle request).",
        default=3.0,
    )


@configclass
class IngestConfig:
    """Bulk-ingestion pipeline knobs (``ingest/pipeline.py``)."""

    parse_workers: int = configfield(
        "CPU parse/split worker threads for bulk ingestion (the "
        "load+split stage; the embed stage is always a single device "
        "dispatcher).",
        default=4,
    )
    embed_batch_chunks: int = configfield(
        "Chunks coalesced per bulk embed dispatch: parsed documents "
        "accumulate until this many chunks are buffered (or the parse "
        "stage idles), then embed as one batch of pow2-bucketed "
        "forwards.",
        default=128,
    )
    append_batch_chunks: int = configfield(
        "Rows per vector-store append during bulk ingestion; each "
        "append is an O(new rows) incremental device sync.",
        default=1024,
    )
    queue_depth: int = configfield(
        "Parsed-document queue bound between the parse pool and the "
        "embed dispatcher (backpressure: parsing blocks when the device "
        "stage lags this far behind).",
        default=16,
    )


@configclass
class PromptsConfig:
    """Prompt templates (reference ``configuration.py:163-204``).

    Wording is our own; roles match the reference behavior: a plain chat
    template, a context-grounded RAG template, and a multi-turn variant.
    """

    chat_template: str = configfield(
        "System prompt for plain (non-RAG) chat.",
        default=(
            "You are a careful, knowledgeable assistant. Answer the user's "
            "question directly and concisely. If you are not sure of the "
            "answer, say that you do not know."
        ),
    )
    rag_template: str = configfield(
        "System prompt for context-grounded answers.",
        default=(
            "You are an assistant that answers strictly from the provided "
            "context. Use only the information between <context> and "
            "</context> to answer. If the context does not contain the "
            "answer, reply that the information is not available. Give at "
            "most five sentences.\n<context>\n{context}\n</context>"
        ),
    )
    multi_turn_rag_template: str = configfield(
        "System prompt for multi-turn, memory-augmented answers.",
        default=(
            "You are an assistant in an ongoing conversation. Ground your "
            "answer in the retrieved context and the conversation history "
            "below; if neither contains the answer, say so.\n"
            "Context: {context}\nHistory: {history}"
        ),
    )


@configclass
class ResilienceConfig:
    """Resilience layer knobs (``generativeaiexamples_tpu_torch/resilience/``;
    see ``docs/resilience.md``)."""

    default_deadline_ms: float = configfield(
        "Default per-request deadline budget in milliseconds, applied at "
        "admission when the client sends no X-Request-Deadline-Ms header. "
        "0 disables (unlimited).",
        default=0.0,
    )
    max_deadline_ms: float = configfield(
        "Upper clamp for client-requested deadlines; a header asking for "
        "more is reduced to this. 0 means no clamp.",
        default=0.0,
    )
    retry_max_attempts: int = configfield(
        "Total attempts (first try + retries) a RetryPolicy makes "
        "against a flaky dependency.",
        default=3,
    )
    retry_base_ms: float = configfield(
        "Backoff before the first retry, milliseconds; doubles each "
        "retry with full jitter, capped at retry_max_ms.",
        default=25.0,
    )
    retry_max_ms: float = configfield(
        "Backoff ceiling per retry, milliseconds.", default=1000.0
    )
    retry_jitter: float = configfield(
        "Fraction of each backoff randomized away (1.0 = full jitter: "
        "sleep uniform in [0, backoff]).",
        default=1.0,
    )
    retry_budget_ratio: float = configfield(
        "Retry-budget deposit per first attempt: sustained failure "
        "converges to at most this many retries per request (the "
        "retry-storm guard).",
        default=0.2,
    )
    breaker_window: int = configfield(
        "Sliding count window of call outcomes per circuit breaker.",
        default=32,
    )
    breaker_min_calls: int = configfield(
        "Minimum outcomes in the window before a breaker may trip.",
        default=8,
    )
    breaker_failure_threshold: float = configfield(
        "Failure rate over the window at which a breaker opens.",
        default=0.5,
    )
    breaker_reset_s: float = configfield(
        "Cool-down before an open breaker admits half-open probes.",
        default=30.0,
    )
    breaker_half_open_max: int = configfield(
        "Concurrent half-open probes; this many consecutive successes "
        "re-close the breaker.",
        default=2,
    )
    min_rerank_budget_ms: float = configfield(
        "Remaining-budget floor for reranking: below this the ladder "
        "skips the cross-encoder (degraded stage 'rerank').",
        default=150.0,
    )
    min_full_k_budget_ms: float = configfield(
        "Remaining-budget floor for full fetch_k over-fetch: below this "
        "the ladder shrinks to plain top_k (degraded stage 'shrink_k').",
        default=75.0,
    )
    faults: str = configfield(
        "Fault-injection spec armed at startup (chaos testing), e.g. "
        "'embedder:error=0.1;reranker:latency=200'. Also settable via "
        "the GAIE_FAULTS env var, which wins.",
        default="",
    )


@configclass
class CacheConfig:
    """Multi-tier result cache (see ``docs/caching.md``).

    Retrieval caching defaults ON (a pure latency win with version-keyed
    invalidation); answer caching defaults OFF — cached answers pin one
    phrasing and bypass sampling-parameter nuance, so it is an explicit
    opt-in for high-traffic FAQ-style deployments.
    """

    enabled: bool = configfield(
        "Cache retrieval results (exact tier).", default=True
    )
    semantic_enabled: bool = configfield(
        "Also serve near-duplicate queries via embedding similarity "
        "(tier 1).",
        default=True,
    )
    answer_enabled: bool = configfield(
        "Cache fully generated answers for single-turn requests and "
        "replay them on an exact cache hit with identical generation "
        "settings.",
        default=False,
    )
    max_entries: int = configfield(
        "Exact-tier LRU capacity (entries).", default=1024
    )
    semantic_entries: int = configfield(
        "Semantic-tier ring capacity (recently cached query vectors "
        "scanned per lookup).",
        default=512,
    )
    similarity_threshold: float = configfield(
        "Cosine similarity floor for a semantic hit; below it the query "
        "computes the full pipeline.",
        default=0.98,
    )
    serve_stale: bool = configfield(
        "When the store is hard-down (breaker open, no host fallback), "
        "serve version-ignoring cached results as the 'cache_stale' "
        "degradation rung instead of failing.",
        default=True,
    )


@configclass
class ObservabilityConfig:
    """Per-request telemetry (see ``docs/observability.md``).

    Defaults ON: the stage histograms and the ``/debug/requests`` flight
    recorder are the production postmortem surface, and ``bench_obs``
    gates their clean-path overhead at <= 3%.
    """

    enabled: bool = configfield(
        "Record per-request stage traces (latency histograms, "
        "/debug/requests flight recorder, Server-Timing headers).",
        default=True,
    )
    flight_recorder_entries: int = configfield(
        "Completed request traces kept for GET /debug/requests.",
        default=128,
    )
    flight_recorder_pinned: int = configfield(
        "Extra slots reserved for error/degraded traces so healthy "
        "traffic cannot evict them.",
        default=32,
    )


@configclass
class SLOConfig:
    """Service-level objectives + burn-rate alerting (``docs/slo.md``).

    Objectives are evaluated as Google-SRE multi-window burn rates over
    the in-process TSDB (``obs/tsdb.py``): a *fast* rule (short window +
    a 12x long confirmation window, paging threshold) and a *slow* rule
    (same shape, ticket threshold).  A firing fast rule turns ``/health``
    degraded and pins a transition entry into the flight recorder.
    """

    enabled: bool = configfield(
        "Evaluate SLO burn-rate rules and export rag_slo_* metrics.",
        default=True,
    )
    availability_target: float = configfield(
        "Fraction of requests that must finish non-error and "
        "non-degraded (error budget = 1 - target).",
        default=0.999,
    )
    latency_p95_ms: str = configfield(
        "Per-route latency objectives as 'route=ms' pairs; a request "
        "slower than its route budget burns the latency error budget.",
        default="/generate=2500,/search=500",
    )
    fast_window_s: float = configfield(
        "Short window of the fast burn-rate rule (long window is 12x).",
        default=300.0,
    )
    slow_window_s: float = configfield(
        "Short window of the slow burn-rate rule (long window is 12x).",
        default=1800.0,
    )
    fast_burn_threshold: float = configfield(
        "Burn-rate multiple that fires the fast (page) rule in both of "
        "its windows.",
        default=14.4,
    )
    slow_burn_threshold: float = configfield(
        "Burn-rate multiple that fires the slow (ticket) rule in both "
        "of its windows.",
        default=6.0,
    )
    evaluation_period_s: float = configfield(
        "Minimum seconds between rule evaluations; reads in between "
        "serve the cached verdict (hot paths never evaluate).",
        default=10.0,
    )


@configclass
class AutoscaleConfig:
    """Closed-loop replica autoscaling (``engine/autoscale.py``; see
    ``docs/elasticity.md``).

    The controller reads the fleet TSDB (queue depth, tick latency) and
    the SLO burn state, computes a desired replica count with hysteresis
    (a dead band between ``queue_high`` and ``queue_low`` plus
    ``down_checks`` consecutive confirmations before shrinking) and
    per-direction cooldowns, then drives ``EnginePool.scale_to``.
    """

    enabled: bool = configfield(
        "Run the autoscaler control loop (engine server --autoscale also "
        "enables it).",
        default=False,
    )
    min_replicas: int = configfield(
        "Floor for the desired replica count.", default=1
    )
    max_replicas: int = configfield(
        "Ceiling for the desired replica count.", default=4
    )
    interval_s: float = configfield(
        "Control-loop period in seconds.", default=2.0
    )
    window_s: float = configfield(
        "Trailing TSDB window examined per decision (engine.queued mean, "
        "engine.tick_ms mean).",
        default=30.0,
    )
    queue_high: float = configfield(
        "Mean queued requests per healthy replica above which the "
        "controller scales up.",
        default=4.0,
    )
    queue_low: float = configfield(
        "Mean queued requests per healthy replica below which the "
        "controller may scale down (the gap to queue_high is the "
        "hysteresis dead band).",
        default=0.5,
    )
    tick_high_ms: float = configfield(
        "Mean engine.tick_ms above which the controller scales up "
        "(0 disables the tick-latency trigger).",
        default=0.0,
    )
    scale_on_fast_burn: bool = configfield(
        "A firing SLO fast-burn rule forces a scale-up step regardless "
        "of queue depth.",
        default=True,
    )
    down_checks: int = configfield(
        "Consecutive scale-down verdicts required before the controller "
        "actually drains a replica.",
        default=3,
    )
    up_cooldown_s: float = configfield(
        "Minimum seconds between scale-up actions.", default=10.0
    )
    down_cooldown_s: float = configfield(
        "Minimum seconds between scale-down actions (and after any "
        "scale-up) — scale-down is deliberately the slower direction.",
        default=120.0,
    )


@configclass
class AdmissionConfig:
    """Priority-class admission control (``resilience/admission.py``;
    see ``docs/elasticity.md``).

    Requests carry a traffic class — ``interactive``, ``batch`` or
    ``ingest`` (highest to lowest priority) — via the ``X-Traffic-Class``
    header or a per-route default.  Each class gets an optional
    token-bucket rate quota and a weighted share of the concurrency
    budget; under pressure the lowest class sheds first, and queued
    requests whose deadline can no longer be met are shed ahead of the
    blind backpressure 429.
    """

    enabled: bool = configfield(
        "Gate API routes through the admission controller. With the "
        "default unlimited quotas this only classifies and counts; "
        "shedding starts once max_inflight or class rates are set.",
        default=True,
    )
    default_class: str = configfield(
        "Traffic class assumed when the header is absent and the route "
        "has no per-route default (ingest routes default to 'ingest').",
        default="interactive",
    )
    header: str = configfield(
        "Request header naming the traffic class.",
        default="X-Traffic-Class",
    )
    weights: str = configfield(
        "Per-class weights as 'class=weight' pairs; a class may use up "
        "to (its weight + all lower-priority weights) / total of "
        "max_inflight, so interactive can always displace batch/ingest "
        "but never the reverse.",
        default="interactive=70,batch=20,ingest=10",
    )
    rates: str = configfield(
        "Optional per-class token-bucket quotas as 'class=requests_per_s' "
        "pairs (empty or 0 = unlimited).",
        default="",
    )
    burst_s: float = configfield(
        "Token-bucket burst capacity, in seconds of the class rate "
        "(capacity = rate * burst_s, min 1 token).",
        default=2.0,
    )
    max_inflight: int = configfield(
        "Concurrency budget for admitted API requests; 0 disables the "
        "weighted-share gate (no shedding by load).",
        default=0,
    )
    parallel_hint: int = configfield(
        "Effective service parallelism used to estimate queue wait for "
        "deadline-aware shedding (roughly the worker-thread count).",
        default=8,
    )
    retry_after_max_s: float = configfield(
        "Clamp for the Retry-After hint attached to shed responses.",
        default=30.0,
    )


@configclass
class DurabilityConfig:
    """Crash durability for the stateful core (``docs/durability.md``).

    The reference stack delegates durability to Milvus; the TPU-native
    stores are volatile, so when this section is enabled every store
    mutation is write-ahead logged, snapshots are cut atomically on a
    record cadence, `/documents/bulk` jobs are journaled for restart
    resume, and startup recovers snapshot + WAL tail + unfinished jobs.
    """

    enabled: bool = configfield(
        "Write-ahead log store mutations, journal bulk-ingest jobs, and "
        "recover both on startup.",
        default=False,
    )
    directory: str = configfield(
        "Root directory for the WAL, snapshots, and the ingest journal.",
        default="/tmp/gaie-durability",
        env="GAIE_DURABILITY_DIR",
    )
    fsync_every: int = configfield(
        "WAL fsync cadence: 1 = synchronous fsync per record "
        "(strictest), N > 1 = a background flusher fsyncs every ~N "
        "records so appends never block on the disk, 0 = flush/close "
        "only.  A crash can lose the un-fsynced tail; the journal "
        "resume path re-ingests the affected file, so the trade buys "
        "clean-path latency, not correctness.",
        default=16,
    )
    snapshot_every_records: int = configfield(
        "Cut an atomic snapshot (and truncate the WAL) every N WAL "
        "records; 0 disables periodic snapshots (shutdown still cuts "
        "one).",
        default=4096,
    )
    keep_snapshots: int = configfield(
        "Snapshot generations retained on disk.", default=2
    )
    resume_jobs: bool = configfield(
        "Resume journaled bulk-ingest jobs interrupted by a restart.",
        default=True,
    )
    final_snapshot_on_shutdown: bool = configfield(
        "Cut a final snapshot during graceful shutdown.", default=True
    )


@configclass
class HealthConfig:
    """Gray-failure tolerance for the serving pool (``docs/resilience.md``).

    Continuous replica scoring (EWMA of tick latency, queue depth, and
    TTFT relative to the pool), outlier ejection with probation
    re-admission, and budget-capped hedged requests.  The binary
    dead/stalled monitor stays in charge of hard failures; this section
    covers the slow-but-alive replicas it cannot see.
    """

    enabled: bool = configfield(
        "Score replicas continuously and weight routing by score; when "
        "disabled every replica scores a constant 1.0 and ejection and "
        "hedging are inert.",
        default=True,
    )
    window_s: float = configfield(
        "TSDB lookback window for the per-replica scoring signals "
        "(tick latency, queue depth, TTFT).",
        default=5.0,
    )
    tick_tolerance: float = configfield(
        "Grace multiple on relative tick latency: a replica ticking at "
        "up to tick_tolerance x the median of its peers still scores "
        "1.0; the score decays toward 0 beyond that.",
        default=2.5,
    )
    score_smoothing: float = configfield(
        "EWMA alpha applied to the combined score per scoring pass "
        "(1.0 = no smoothing; smaller = slower, steadier transitions).",
        default=0.4,
    )
    eject_threshold: float = configfield(
        "Score at or below which a replica counts as browned out.",
        default=0.5,
    )
    eject_after_s: float = configfield(
        "How long a replica must stay at or below eject_threshold "
        "before it is ejected from the routable set.",
        default=3.0,
    )
    readmit_score: float = configfield(
        "Score an ejected replica must sustain to enter probation.",
        default=0.8,
    )
    readmit_after_s: float = configfield(
        "How long an ejected replica must sustain readmit_score before "
        "probation starts.",
        default=3.0,
    )
    probation_s: float = configfield(
        "Probation length: a re-admitted replica takes traffic but one "
        "relapse below eject_threshold re-ejects it immediately; after "
        "probation_s clean it is fully healthy again.",
        default=5.0,
    )
    max_eject_fraction: float = configfield(
        "Ceiling on the fraction of live replicas that may be ejected "
        "at once, so correlated slowness can never empty the pool.",
        default=0.5,
    )
    session_break_score: float = configfield(
        "Session affinity breaks (the session is remapped) when the "
        "sticky replica's score drops below this.",
        default=0.5,
    )
    max_sessions: int = configfield(
        "Bound on the router's session-affinity map; least-recently "
        "used entries are evicted past this (0 = unbounded).",
        default=10000,
    )
    hedge_enabled: bool = configfield(
        "Fire a backup copy of short non-streaming requests to the "
        "second-best replica when the primary is slow (first response "
        "wins, loser cancelled).",
        default=True,
    )
    hedge_budget_ratio: float = configfield(
        "Token-bucket hedge budget as a fraction of eligible traffic "
        "(0.05 = at most ~5% extra load from hedging).",
        default=0.05,
    )
    hedge_burst: float = configfield(
        "Token-bucket capacity: hedges that may fire back-to-back "
        "before the budget ratio throttles.",
        default=4.0,
    )
    hedge_min_delay_ms: float = configfield(
        "Floor on the hedge trigger delay; the effective delay is the "
        "EWMA-tracked p95 of eligible-request latency, never below "
        "this.",
        default=30.0,
    )
    hedge_max_tokens: int = configfield(
        "Only requests asking for at most this many output tokens are "
        "hedge-eligible (long generations double real work when "
        "duplicated).",
        default=32,
    )


@configclass
class TracingConfig:
    """OpenTelemetry export settings (reference ``common/tracing.py``)."""

    enabled: bool = configfield(
        "Emit OTel spans.", default=False, env="ENABLE_TRACING"
    )
    otlp_endpoint: str = configfield(
        "OTLP gRPC collector endpoint.",
        default="http://localhost:4317",
        env="OTEL_EXPORTER_OTLP_ENDPOINT",
    )


@configclass
class AppConfig:
    """Root config for the chain server (reference ``configuration.py:207-258``)."""

    vector_store: VectorStoreConfig = configfield(
        "Vector store section.", default_factory=VectorStoreConfig
    )
    fabric: FabricConfig = configfield(
        "Sharded retrieval fabric section (scatter-gather shards, "
        "host-RAM cold tier).",
        default_factory=FabricConfig,
    )
    collections: CollectionsConfig = configfield(
        "Named multi-tenant collections section (per-collection stores, "
        "quotas).",
        default_factory=CollectionsConfig,
    )
    llm: LLMConfig = configfield("LLM section.", default_factory=LLMConfig)
    text_splitter: TextSplitterConfig = configfield(
        "Text splitter section.", default_factory=TextSplitterConfig
    )
    embeddings: EmbeddingConfig = configfield(
        "Embeddings section.", default_factory=EmbeddingConfig
    )
    ranking: RankingConfig = configfield("Reranking section.", default_factory=RankingConfig)
    vlm: VLMConfig = configfield("Vision-language model section.", default_factory=VLMConfig)
    retriever: RetrieverConfig = configfield(
        "Retriever section.", default_factory=RetrieverConfig
    )
    ingest: IngestConfig = configfield(
        "Bulk-ingestion pipeline section.", default_factory=IngestConfig
    )
    cache: CacheConfig = configfield(
        "Result-cache section (exact + semantic tiers).",
        default_factory=CacheConfig,
    )
    prompts: PromptsConfig = configfield("Prompts section.", default_factory=PromptsConfig)
    resilience: ResilienceConfig = configfield(
        "Resilience section (deadlines, retries, breakers, degradation).",
        default_factory=ResilienceConfig,
    )
    observability: ObservabilityConfig = configfield(
        "Observability section (request traces, latency histograms, "
        "flight recorder).",
        default_factory=ObservabilityConfig,
    )
    slo: SLOConfig = configfield(
        "SLO section (objectives, burn-rate alert rules).",
        default_factory=SLOConfig,
    )
    autoscale: AutoscaleConfig = configfield(
        "Autoscaler section (replica-count control loop).",
        default_factory=AutoscaleConfig,
    )
    admission: AdmissionConfig = configfield(
        "Admission-control section (traffic classes, quotas, shedding).",
        default_factory=AdmissionConfig,
    )
    durability: DurabilityConfig = configfield(
        "Durability section (write-ahead log, snapshots, ingest journal, "
        "crash recovery).",
        default_factory=DurabilityConfig,
    )
    health: HealthConfig = configfield(
        "Gray-failure tolerance section (replica scoring, straggler "
        "ejection, hedged requests).",
        default_factory=HealthConfig,
    )
    tracing: TracingConfig = configfield("Tracing section.", default_factory=TracingConfig)


@functools.lru_cache(maxsize=1)
def get_config() -> AppConfig:
    """Load the app config once per process.

    File location comes from ``APP_CONFIG_FILE`` (same knob as the
    reference); env vars overlay file values.
    """
    path = os.environ.get("APP_CONFIG_FILE", "")
    if path and not os.path.exists(path):
        from generativeaiexamples_tpu_torch.core.config import ConfigError

        raise ConfigError(f"APP_CONFIG_FILE points at a missing file: {path}")
    return load_config(AppConfig, path=path or None)


def reset_config_cache() -> None:
    """Testing hook: force :func:`get_config` to re-read its sources."""
    get_config.cache_clear()
