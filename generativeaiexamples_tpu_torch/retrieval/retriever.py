"""Retriever: embedder + vector store + relevance policy.

The equivalent of the reference's ``get_doc_retriever`` + score-threshold
search + token-budget postprocessor stack (``common/utils.py:97-122,256-260``;
``examples/nvidia_api_catalog/chains.py:117-127``).

Resilience (see ``docs/resilience.md``): every stage honors the request
deadline, runs under its dependency's circuit breaker with jittered
retries, and degrades instead of failing where a cheaper rung exists:

  1. low budget → skip the cross-encoder (``rerank``) and cap ``top_k``
     (``shrink_k``);
  2. reranker fault/breaker-open → return vector-search order
     (``rerank``);
  3. store fault/breaker-open → exact host-side scan via the store's
     ``search_fallback`` (``index_fallback``);
  4. embedder hard-down → the *chain* answers LLM-only (``retrieval``) —
     the retriever raises, since without query embeddings there is no
     cheaper rung here.

A copy of the JAX package's ``retrieval/retriever.py``; the port imports
nothing of it.  Every stage returns host values (``embed_queries`` lists,
``search_batch`` host hits, the ring lookup's ``tolist``, ``score_pairs``
floats), so each trace stage ends with its device work done.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from generativeaiexamples_tpu_torch.cache.log import CacheLog, current_cache_log
from generativeaiexamples_tpu_torch.cache.metrics import (
    record_cache_hit,
    record_cache_miss,
)
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.obs.trace import RequestTrace, current_request_trace
from generativeaiexamples_tpu_torch.resilience.breaker import CircuitOpenError, get_breaker
from generativeaiexamples_tpu_torch.resilience.deadline import (
    Deadline,
    DeadlineExceeded,
    current_deadline,
)
from generativeaiexamples_tpu_torch.resilience.degrade import (
    DegradeLog,
    current_degrade_log,
    mark_degraded,
)
from generativeaiexamples_tpu_torch.resilience.faults import inject
from generativeaiexamples_tpu_torch.resilience.retry import RetryPolicy
from generativeaiexamples_tpu_torch.retrieval.base import ScoredChunk, VectorStore

logger = get_logger(__name__)


@dataclasses.dataclass
class Retriever:
    store: VectorStore
    embedder: "object"  # Embedder protocol (embed_query/embed_documents)
    top_k: int = 4
    score_threshold: float = 0.25
    # Token budget for assembled context (reference LimitRetrievedNodesLength
    # caps at 1500 tokens, ``utils.py:97-122``). Approximated at 4 chars per
    # token when no tokenizer is provided.
    max_context_tokens: int = 1500
    reranker: Optional[object] = None  # optional cross-encoder
    # Over-fetch multiplier when a reranker is active: the vector search
    # returns top_k * fetch_k_multiplier candidates for the cross-encoder
    # to re-order (reference fm-asr retriever fetches 4x for reranking).
    fetch_k_multiplier: int = 4
    # Degradation-ladder budget floors (milliseconds of remaining deadline;
    # factory sizes these from resilience.* config).
    min_rerank_budget_ms: float = 150.0
    min_full_k_budget_ms: float = 75.0
    embed_retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(name="embed")
    )
    search_retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(name="store-search")
    )
    # Optional two-tier result cache (``cache.RetrievalCache``).  The
    # chain label partitions entries between pipelines sharing one cache;
    # ``cache_serve_stale`` enables the ``cache_stale`` degradation rung
    # (version-ignoring cached results when the store is hard-down and
    # has no host-side fallback).
    cache: Optional[object] = None
    cache_chain: str = "rag"
    cache_serve_stale: bool = True

    def retrieve(self, query: str, top_k: Optional[int] = None) -> list[ScoredChunk]:
        return self.retrieve_many([query], top_k=top_k)[0]

    def retrieve_many(
        self,
        queries: Sequence[str],
        top_k: Optional[int] = None,
        *,
        deadline: Optional[Deadline] = None,
        degrade_logs: Optional[Sequence[Optional[DegradeLog]]] = None,
        cache_logs: Optional[Sequence[Optional[CacheLog]]] = None,
        traces: Optional[Sequence[Optional[RequestTrace]]] = None,
    ) -> list[list[ScoredChunk]]:
        """Answer many queries with shared device dispatches.

        The batched hot path behind the cross-request micro-batcher: one
        embed forward per length bucket (``embed_queries``), one corpus
        matmul for the whole query batch (``search_batch``), and — with a
        reranker — all requests' (query, passage) pairs scored in shared
        cross-encoder forwards (``score_pairs``).  Result ``i`` answers
        ``queries[i]``; semantics per query match :meth:`retrieve`.

        With a :class:`~..cache.RetrievalCache` attached the batch first
        drains against the exact tier (no device work at all), then the
        semantic tier (reusing the embed forward this method runs
        anyway), and only the residual misses pay search + rerank.  A
        semantic hit at a *smaller* ``top_k`` than the stored entry still
        rides the shared rerank dispatch over the entry's candidate set
        — cached ordering is never trusted across ``top_k`` values when
        a reranker is active.

        ``deadline`` defaults to the context deadline; ``degrade_logs``,
        ``cache_logs`` and ``traces`` carry one per-request object per
        query (the micro-batcher fans a batch over many requests, so a
        batch-level degradation — or a cache hit, or a shared stage
        timing — must mark that member's response).
        """
        if not queries:
            return []
        if deadline is None:
            deadline = current_deadline()
        k = self.top_k if top_k is None else top_k
        if k <= 0:
            return [[] for _ in queries]

        # ``degraded_here`` gates cache admission: a result produced on
        # any degraded rung this call must never be cached as truth.
        degraded_here = False

        def mark(stage: str) -> None:
            nonlocal degraded_here
            degraded_here = True
            self._mark(stage, degrade_logs)

        # -- budget-driven rungs decided up front ---------------------------
        skip_rerank = False
        want_rerank = self.reranker is not None
        if deadline is not None and not deadline.is_unlimited:
            deadline.check("retrieve admission")
            remaining_ms = deadline.remaining_ms()
            if remaining_ms < self.min_full_k_budget_ms:
                shrunk = max(1, min(k, 2))
                if shrunk < k:
                    k = shrunk
                    mark("shrink_k")
            if want_rerank and remaining_ms < self.min_rerank_budget_ms:
                skip_rerank = True
                mark("rerank")

        cache = self.cache
        # Version captured BEFORE any device work: a store mutation that
        # lands mid-flight leaves the admitted entry stamped with the
        # pre-mutation version, so the next lookup invalidates it rather
        # than serving a result that straddles the mutation.
        store_version = self.store.version() if cache is not None else 0
        n = len(queries)
        results: list[Optional[list[ScoredChunk]]] = [None] * n

        # -- tier 0: exact (zero dispatches) --------------------------------
        if cache is not None:
            self._trace_attr(range(n), traces, "store_version", store_version)
            t_stage = time.perf_counter()
            for i, q in enumerate(queries):
                entry = cache.lookup_exact(q, k, self.cache_chain, store_version)
                if entry is not None:
                    results[i] = list(entry.hits[:k])
                    self._mark_cache_hit(i, "exact", entry, cache_logs)
            self._stage_at(
                "cache_lookup", t_stage, range(n), traces, tier="exact"
            )

        pending = [i for i in range(n) if results[i] is None]
        if not pending:
            return [results[i] for i in range(n)]
        pend_queries = [queries[i] for i in pending]

        # -- embed residual (breaker 'embedder'; no cheaper rung) -----------
        def _embed() -> list[list[float]]:
            inject("embedder")
            if hasattr(self.embedder, "embed_queries"):
                return self.embedder.embed_queries(list(pend_queries))
            return [self.embedder.embed_query(q) for q in pend_queries]

        t_stage = time.perf_counter()
        qs = self.embed_retry.call(
            _embed, deadline=deadline, breaker=get_breaker("embedder")
        )
        self._stage_at(
            "embed", t_stage, pending, traces, batch_size=len(pend_queries)
        )

        # -- tier 1: semantic (one batched matmul over the ring) ------------
        # ``compute_j`` indexes into ``pending``/``qs``; ``rerank_cached``
        # holds semantic hits whose stored top_k differs from k and so
        # must re-run the rerank stage over the entry's candidates.
        compute_j = list(range(len(pending)))
        rerank_cached: list[tuple[int, object]] = []
        if cache is not None and getattr(cache, "semantic_enabled", False):
            t_stage = time.perf_counter()
            sem = cache.lookup_semantic_many(qs, self.cache_chain, store_version)
            self._stage_at(
                "cache_lookup", t_stage, pending, traces, tier="semantic"
            )
            compute_j = []
            for j, found in enumerate(sem):
                i = pending[j]
                if found is None:
                    compute_j.append(j)
                    continue
                entry, _sim = found
                if entry.top_k == k or (
                    k < entry.top_k and (not want_rerank or skip_rerank)
                ):
                    results[i] = list(entry.hits[:k])
                    cache.record_semantic_hit(entry)
                    self._mark_cache_hit(i, "semantic", entry, cache_logs)
                    # Alias this exact (query, k) into tier 0 (no ring
                    # slot: embedding=None) so the next identical query
                    # is a zero-dispatch exact hit.
                    if not degraded_here and not self._request_degraded(
                        i, degrade_logs
                    ):
                        cache.admit(
                            pend_queries[j], k, self.cache_chain,
                            store_version, None, entry.candidates,
                            results[i],
                        )
                elif k < entry.top_k:
                    rerank_cached.append((j, entry))
                else:
                    # Cached set is shallower than requested: miss.
                    compute_j.append(j)

        # -- vector search for residual misses (rung: host fallback,
        #    then version-ignoring stale cache) -----------------------------
        mult = max(1, self.fetch_k_multiplier)
        fetch_k = k * mult if (want_rerank and not skip_rerank) else k
        many_fresh: list[list[ScoredChunk]] = []
        if compute_j:
            qs_search = [qs[j] for j in compute_j]
            # Capture members now: the stale-serve path clears compute_j,
            # but those requests still spent the search-stage wall time.
            search_members = [pending[j] for j in compute_j]
            t_stage = time.perf_counter()

            def _search() -> list[list[ScoredChunk]]:
                inject("store")
                return self.store.search_batch(qs_search, fetch_k)

            try:
                many = self.search_retry.call(
                    _search, deadline=deadline, breaker=get_breaker("store")
                )
            except DeadlineExceeded:
                raise
            except Exception as exc:
                fallback = getattr(self.store, "search_fallback", None)
                if fallback is not None:
                    logger.warning(
                        "vector search failed (%s: %s); serving exact host-side fallback",
                        type(exc).__name__, exc,
                    )
                    many = fallback(qs_search, fetch_k)
                    mark("index_fallback")
                else:
                    stale = self._stale_entries(cache, compute_j, pend_queries, qs)
                    if stale is None:
                        raise
                    logger.warning(
                        "vector search failed (%s: %s); serving stale cached results",
                        type(exc).__name__, exc,
                    )
                    for j, entry in zip(compute_j, stale):
                        i = pending[j]
                        results[i] = list(entry.hits[:k])
                        record_cache_hit("stale")
                        self._mark_cache_hit(i, "stale", entry, cache_logs)
                    self._mark_at(
                        "cache_stale",
                        [pending[j] for j in compute_j],
                        degrade_logs,
                    )
                    degraded_here = True
                    compute_j = []
                    many = []
            self._stage_at(
                "search", t_stage, search_members, traces,
                batch_size=len(qs_search), fetch_k=fetch_k,
            )
            many_fresh = [
                [h for h in hits if h.score >= self.score_threshold]
                for hits in many
            ]
            # One miss per query that actually computed the pipeline
            # (stale serves above cleared compute_j and count as hits).
            if cache is not None:
                for _ in compute_j:
                    record_cache_miss()

        # -- rerank (breaker 'reranker'; rung: vector-search order) ---------
        rerank_ok = False
        if want_rerank and not skip_rerank and (compute_j or rerank_cached):
            rr_queries = [pend_queries[j] for j in compute_j]
            rr_lists: list[list[ScoredChunk]] = list(many_fresh)
            for j, entry in rerank_cached:
                rr_queries.append(pend_queries[j])
                rr_lists.append(list(entry.candidates))
            if not any(rr_lists):
                reranked = [hits[:k] for hits in rr_lists]
                rerank_ok = True
            else:
                rerank_members = [pending[j] for j in compute_j]
                rerank_members += [pending[j] for j, _ in rerank_cached]
                t_stage = time.perf_counter()
                rerank_breaker = get_breaker("reranker")
                try:
                    rerank_breaker.check()
                    if deadline is not None:
                        deadline.check("rerank")
                    inject("reranker")
                    reranked = self._rerank_many(rr_queries, rr_lists, k)
                    rerank_ok = True
                except (DeadlineExceeded, CircuitOpenError):
                    mark("rerank")
                    reranked = [hits[:k] for hits in rr_lists]
                except Exception as exc:
                    rerank_breaker.record_failure()
                    logger.warning(
                        "rerank failed (%s: %s); serving vector-search order",
                        type(exc).__name__, exc,
                    )
                    mark("rerank")
                    reranked = [hits[:k] for hits in rr_lists]
                else:
                    rerank_breaker.record_success()
                self._stage_at(
                    "rerank", t_stage, rerank_members, traces,
                    batch_size=len(rr_queries), ok=rerank_ok,
                )
            for m, j in enumerate(compute_j):
                results[pending[j]] = reranked[m]
            base = len(compute_j)
            for off, (j, entry) in enumerate(rerank_cached):
                i = pending[j]
                if rerank_ok:
                    results[i] = reranked[base + off]
                else:
                    # Rerank rung fired: the entry's stored ordering (a
                    # deeper-k rerank) is the best available fallback.
                    results[i] = list(entry.hits[:k])
                cache.record_semantic_hit(entry)
                self._mark_cache_hit(i, "semantic", entry, cache_logs)
        else:
            for m, j in enumerate(compute_j):
                results[pending[j]] = many_fresh[m][:k]

        # -- admission ------------------------------------------------------
        # Only clean results become cache truth: no degraded rung fired
        # in this call, the request's own log is empty, and the deadline
        # has not expired (an expired-deadline result may be partial).
        if (
            cache is not None
            and not degraded_here
            and not (deadline is not None and deadline.expired())
        ):
            for m, j in enumerate(compute_j):
                i = pending[j]
                if self._request_degraded(i, degrade_logs):
                    continue
                admitted = cache.admit(
                    pend_queries[j], k, self.cache_chain, store_version,
                    qs[j], many_fresh[m], results[i],
                )
                self._note_entry(i, admitted, cache_logs)
            if rerank_ok:
                for j, entry in rerank_cached:
                    i = pending[j]
                    if self._request_degraded(i, degrade_logs):
                        continue
                    admitted = cache.admit(
                        pend_queries[j], k, self.cache_chain, store_version,
                        qs[j], entry.candidates, results[i],
                    )
                    self._note_entry(i, admitted, cache_logs)

        return [results[i] if results[i] is not None else [] for i in range(n)]

    def _stale_entries(
        self,
        cache: Optional[object],
        compute_j: Sequence[int],
        pend_queries: Sequence[str],
        qs: Sequence[Sequence[float]],
    ) -> Optional[list]:
        """Version-ignoring cached entries for every residual query, or
        ``None`` when any query has no stale match (all-or-raise: a
        partially stale batch would leave some members with no result
        at all, which the caller cannot express)."""
        if cache is None or not self.cache_serve_stale:
            return None
        out = []
        for j in compute_j:
            entry = cache.lookup_stale(
                pend_queries[j], self.cache_chain, embedding=qs[j]
            )
            if entry is None:
                return None
            out.append(entry)
        return out

    @staticmethod
    def _stage_at(
        stage: str,
        t_start: float,
        indices: Sequence[int],
        traces: Optional[Sequence[Optional[RequestTrace]]],
        **attrs,
    ) -> None:
        """Record one shared stage timing (begun at perf-counter stamp
        ``t_start``) on every listed request's trace, falling back to the
        context trace when the caller didn't fan out (same contract as
        ``_mark``/``_mark_cache_hit``)."""
        duration_ms = (time.perf_counter() - t_start) * 1000.0
        if traces:
            for i in indices:
                if i < len(traces) and traces[i] is not None:
                    traces[i].add_stage(
                        stage, duration_ms, start=t_start, **attrs
                    )
            return
        trace = current_request_trace()
        if trace is not None:
            trace.add_stage(stage, duration_ms, start=t_start, **attrs)

    @staticmethod
    def _trace_attr(
        indices: Sequence[int],
        traces: Optional[Sequence[Optional[RequestTrace]]],
        key: str,
        value,
    ) -> None:
        if traces:
            for i in indices:
                if i < len(traces) and traces[i] is not None:
                    traces[i].set_attr(key, value)
            return
        trace = current_request_trace()
        if trace is not None:
            trace.set_attr(key, value)

    @staticmethod
    def _request_degraded(
        i: int, degrade_logs: Optional[Sequence[Optional[DegradeLog]]]
    ) -> bool:
        """True when request ``i``'s own log already carries marks (e.g.
        an earlier stage of this request degraded before the batcher)."""
        log = None
        if degrade_logs and i < len(degrade_logs):
            log = degrade_logs[i]
        if log is None:
            log = current_degrade_log()
        return bool(log)

    @staticmethod
    def _note_entry(
        i: int,
        entry: object,
        cache_logs: Optional[Sequence[Optional[CacheLog]]],
    ) -> None:
        """Hand request ``i`` a reference to its freshly admitted entry
        (NOT a hit) so the chain layer can attach an answer to it."""
        log = None
        if cache_logs and i < len(cache_logs):
            log = cache_logs[i]
        if log is None:
            log = current_cache_log()
        if log is not None:
            log.note_entry(entry)

    @staticmethod
    def _mark_cache_hit(
        i: int,
        tier: str,
        entry: object,
        cache_logs: Optional[Sequence[Optional[CacheLog]]],
    ) -> None:
        log = None
        if cache_logs and i < len(cache_logs):
            log = cache_logs[i]
        if log is None:
            log = current_cache_log()
        if log is not None:
            log.mark_hit(tier, entry)

    @staticmethod
    def _mark(
        stage: str, degrade_logs: Optional[Sequence[Optional[DegradeLog]]]
    ) -> None:
        """Record a ladder activation on every affected request's log (or
        the context log when the caller didn't fan out)."""
        if degrade_logs:
            for log in degrade_logs:
                mark_degraded(stage, log)
        else:
            mark_degraded(stage)

    @staticmethod
    def _mark_at(
        stage: str,
        indices: Sequence[int],
        degrade_logs: Optional[Sequence[Optional[DegradeLog]]],
    ) -> None:
        """Mark only the listed requests' logs — a stale-cache serve
        degrades the residual misses, not the members that hit."""
        if degrade_logs:
            for i in indices:
                if i < len(degrade_logs):
                    mark_degraded(stage, degrade_logs[i])
        else:
            mark_degraded(stage)

    def _rerank_many(
        self,
        queries: Sequence[str],
        many: list[list[ScoredChunk]],
        k: int,
    ) -> list[list[ScoredChunk]]:
        """Cross-encoder re-ordering for a query batch, flattened into
        one ``score_pairs`` call when the reranker supports it."""
        if hasattr(self.reranker, "score_pairs"):
            pairs = [
                (q, h.chunk.text)
                for q, hits in zip(queries, many)
                for h in hits
            ]
            flat = self.reranker.score_pairs(pairs)
            scores: list[list[float]] = []
            at = 0
            for hits in many:
                scores.append(flat[at : at + len(hits)])
                at += len(hits)
        else:
            scores = [
                self.reranker.score(q, [h.chunk.text for h in hits])
                if hits
                else []
                for q, hits in zip(queries, many)
            ]
        out: list[list[ScoredChunk]] = []
        for hits, ss in zip(many, scores):
            reranked = [
                ScoredChunk(h.chunk, float(s)) for h, s in zip(hits, ss)
            ]
            reranked.sort(key=lambda h: -h.score)
            out.append(reranked[:k])
        return out

    def build_context(self, hits: Sequence[ScoredChunk]) -> str:
        """Concatenate retrieved chunks under the token budget."""
        budget_chars = self.max_context_tokens * 4
        parts: list[str] = []
        used = 0
        for h in hits:
            text = h.chunk.text
            if used + len(text) > budget_chars:
                remaining = budget_chars - used
                if remaining > 0:
                    parts.append(text[:remaining])
                break
            parts.append(text)
            used += len(text)
        return "\n\n".join(parts)
