"""Canonical QA chatbot pipeline (port of the JAX package's
``chains/developer_rag.py``).

ingest = load → token-split → embed → store; rag = retrieve →
token-capped context → grounded prompt → streamed generation; llm = plain
chat.  Every component comes from the factory's singletons
(``chains/factory.py``), built on the device of their first build: the
server builds them before it serves (``server/app.py::create_app``).
"""

from __future__ import annotations

import time
from typing import Any, Generator, Optional, Sequence

from generativeaiexamples_tpu_torch.cache.core import normalize_query
from generativeaiexamples_tpu_torch.cache.log import current_cache_log
from generativeaiexamples_tpu_torch.chains.base import BaseExample, ChatTurn
from generativeaiexamples_tpu_torch.chains.factory import (
    get_chat_llm,
    get_embedder,
    get_retrieval_batcher,
    get_retrieval_cache,
    get_retriever,
    get_splitter,
    get_store,
)
from generativeaiexamples_tpu_torch.chains.llm import guarded_stream
from generativeaiexamples_tpu_torch.core.configuration import get_config
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.core.tracing import traced
from generativeaiexamples_tpu_torch.ingest.loaders import load_document
from generativeaiexamples_tpu_torch.obs.trace import current_request_trace, traced_stream
from generativeaiexamples_tpu_torch.resilience.deadline import DeadlineExceeded
from generativeaiexamples_tpu_torch.resilience.degrade import (
    current_degrade_log,
    mark_degraded,
)
from generativeaiexamples_tpu_torch.retrieval.base import Chunk

logger = get_logger(__name__)


def _llm_params(llm_settings: dict[str, Any]) -> dict[str, Any]:
    """Extract the generation knobs the connectors understand."""
    out: dict[str, Any] = {}
    for key in ("temperature", "top_p", "max_tokens", "stop", "session_id"):
        if key in llm_settings and llm_settings[key] is not None:
            out[key] = llm_settings[key]
    return out


def _answer_params_key(params: dict[str, Any]) -> tuple:
    """Hashable generation-settings key for answer replay.

    ``session_id`` is identity, not a sampling knob — two sessions asking
    the same single-turn question may share a cached answer."""
    return tuple(
        (key, tuple(value) if isinstance(value, list) else value)
        for key, value in sorted(params.items())
        if key != "session_id"
    )


class QAChatbot(BaseExample):
    """Upload documents, ask grounded questions, stream answers."""

    def __init__(self) -> None:
        # Shared singleton, not a per-pipeline instance: the server builds
        # one pipeline object per request, and cross-request micro-batching
        # only coalesces retrievals that reach the same Retriever.
        self._retriever = get_retriever()

    def _retrieve(self, query: str, top_k: Optional[int] = None) -> list:
        """Retrieval through the cross-request micro-batcher when enabled.

        Concurrent ``/generate`` and ``/search`` handlers calling this on
        their worker threads share one embed → search → rerank dispatch
        chain per ``batch_wait_ms`` window (O(batches) device dispatches
        for N requests); with batching disabled it is a plain retrieve.
        """
        k = self._retriever.top_k if top_k is None else top_k
        trace = current_request_trace()
        # Exact-tier check BEFORE the batcher: a hit costs one dict probe
        # — no queue wait, no embed/search/rerank dispatch, and no
        # rag_requests_total/rag_batches_total increment at all.
        cache = get_retrieval_cache()
        if cache is not None:
            t0 = time.perf_counter()
            entry = cache.lookup_exact(
                query, k, self._retriever.cache_chain, get_store().version()
            )
            if trace is not None:
                trace.add_stage(
                    "cache_lookup",
                    (time.perf_counter() - t0) * 1000.0,
                    start=t0,
                    tier="exact",
                    hit=entry is not None,
                )
            if entry is not None:
                clog = current_cache_log()
                if clog is not None:
                    clog.mark_hit("exact", entry)
                return list(entry.hits[:k])
        batcher = get_retrieval_batcher()
        if batcher is not None:
            # The batcher worker runs outside this request's contextvars
            # scope: the degrade/cache logs and the request trace ride
            # the item, the deadline rides the queue entry
            # (MicroBatcher.call picks it up here, and records the
            # queue-wait stage onto the same trace).
            return batcher.call(
                (query, k, current_degrade_log(), current_cache_log(), trace)
            )
        return self._retriever.retrieve(query, top_k=k)

    @staticmethod
    def parse_chunks(file_path: str, filename: str) -> list[Chunk]:
        """Load + split one document into store-ready chunks.

        The parse stage shared by the per-upload path below and the bulk
        pipeline (``ingest/pipeline.py`` runs this on its CPU pool; the
        server's ``POST /documents/bulk`` feature-detects this hook to
        pick the staged path over per-file ``ingest_docs``)."""
        text = load_document(file_path)
        pieces = get_splitter().split(text)
        return [Chunk(text=p, source=filename) for p in pieces]

    @traced("ingest_docs")
    def ingest_docs(self, file_path: str, filename: str) -> None:
        chunks = self.parse_chunks(file_path, filename)
        if not chunks:
            logger.warning("%s produced no chunks", filename)
            return
        embeddings = get_embedder().embed_documents([c.text for c in chunks])
        get_store().add(chunks, embeddings)
        logger.info("ingested %s: %d chunks", filename, len(chunks))

    def llm_chain(
        self, query: str, chat_history: Sequence[ChatTurn], **llm_settings: Any
    ) -> Generator[str, None, None]:
        cfg = get_config()
        messages = [("system", cfg.prompts.chat_template)]
        messages += [(r, c) for r, c in chat_history]
        messages.append(("user", query))
        yield from traced_stream(
            guarded_stream(get_chat_llm(), messages, **_llm_params(llm_settings))
        )

    def rag_chain(
        self,
        query: str,
        chat_history: Sequence[ChatTurn],
        *,
        hits: Optional[Sequence[Any]] = None,
        **llm_settings: Any,
    ) -> Generator[str, None, None]:
        """``hits`` (pre-retrieved ScoredChunks) skips the internal
        retrieval — app wrappers that already searched for attribution or
        guardrails pass them to avoid embedding the query twice."""
        cfg = get_config()
        params = _llm_params(llm_settings)
        # Answer replay rides the retrieval cache entry: single-turn
        # requests whose retrieval came from (or was admitted to) the
        # cache can reuse a fully streamed answer keyed by the
        # generation settings (``cache.answer_enabled``, default OFF).
        answer_cacheable = (
            cfg.cache.answer_enabled and not chat_history and hits is None
        )
        params_key = _answer_params_key(params) if answer_cacheable else None
        if hits is None:
            try:
                hits = self._retrieve(query)
            except DeadlineExceeded:
                raise  # no budget left for generation either: fast 504
            except Exception as exc:
                # Final ladder rung: retrieval is hard-down (embedder
                # breaker open, store with no fallback, ...) but the LLM
                # may still be healthy — answer ungrounded rather than
                # fail the request.
                logger.warning(
                    "retrieval unavailable (%s: %s); answering LLM-only",
                    type(exc).__name__, exc,
                )
                mark_degraded("retrieval")
                yield from self.llm_chain(query, chat_history, **llm_settings)
                return
        clog = current_cache_log()
        entry = clog.entry if (answer_cacheable and clog is not None) else None
        if (
            entry is not None
            and clog.tier == "exact"
            and entry.get_answer(params_key) is not None
        ):
            clog.mark_answer()
            yield entry.get_answer(params_key)
            return
        context = self._retriever.build_context(hits)
        logger.info("retrieved %d chunks (%d chars) for query", len(hits), len(context))
        system = cfg.prompts.rag_template.format(context=context)
        messages = [("system", system)]
        messages += [(r, c) for r, c in chat_history]
        messages.append(("user", query))
        pieces: list[str] = []
        for piece in traced_stream(guarded_stream(get_chat_llm(), messages, **params)):
            if answer_cacheable:
                pieces.append(piece)
            yield piece
        # Attach only a CLEAN, fully streamed answer to the request's own
        # entry — degraded requests (including LLM-stage degradation
        # inside guarded_stream) must never become replayable truth.
        if (
            answer_cacheable
            and entry is not None
            and entry.query == normalize_query(query)
            and not current_degrade_log()
        ):
            cache = get_retrieval_cache()
            if cache is not None:
                cache.attach_answer(entry, params_key, "".join(pieces))

    def document_search(self, content: str, num_docs: int) -> list[dict[str, Any]]:
        hits = self._retrieve(content, top_k=num_docs)
        return [
            {
                "source": h.chunk.source,
                "content": h.chunk.text,
                "score": h.score,
            }
            for h in hits
        ]

    def get_documents(self) -> list[str]:
        return get_store().sources()

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        ok = True
        for name in filenames:
            removed = get_store().delete_source(name)
            logger.info("deleted %d chunks of %s", removed, name)
            ok = ok and removed >= 0
        return ok
