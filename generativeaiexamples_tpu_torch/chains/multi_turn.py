"""Multi-turn conversational RAG with vector-store memory (port of the JAX
package's ``chains/multi_turn.py``; the memory store is a second
``GPUVectorStore`` on the card, ``chains/factory.py::get_memory_store``).

Parity with the reference ``multi_turn_rag`` example
(``examples/multi_turn_rag/chains.py``): two collections — documents and a
conversation store; each answer retrieves from both in parallel; after the
answer streams, the Q/A pair is written back into the conversation store
(``chains.py:60-68,183-185``), so history scales by retrieval rather than
prompt growth (SURVEY.md §5.7).
"""

from __future__ import annotations

from typing import Any, Generator, Sequence

from generativeaiexamples_tpu_torch.chains.base import ChatTurn
from generativeaiexamples_tpu_torch.chains.developer_rag import QAChatbot, _llm_params
from generativeaiexamples_tpu_torch.chains.factory import (
    get_chat_llm,
    get_embedder,
    get_memory_store,
)
from generativeaiexamples_tpu_torch.core.configuration import get_config
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.retriever import Retriever

logger = get_logger(__name__)

MEMORY_SOURCE = "__conversation__"


class MultiTurnChatbot(QAChatbot):
    """Document RAG + retrieved conversational memory."""

    @staticmethod
    def prepare(device=None) -> None:
        """Build the memory store on ``device`` before serving (the chain
        server calls this with its own device; a request builds nothing)."""
        get_memory_store(device)

    def __init__(self) -> None:
        super().__init__()
        cfg = get_config()
        self._memory = Retriever(
            store=get_memory_store(),
            embedder=get_embedder(),
            top_k=cfg.retriever.top_k,
            score_threshold=cfg.retriever.score_threshold,
        )

    def _remember(self, query: str, answer: str) -> None:
        text = f"User: {query}\nAssistant: {answer}"
        get_memory_store().add(
            [Chunk(text=text, source=MEMORY_SOURCE)],
            get_embedder().embed_documents([text]),
        )

    def rag_chain(
        self, query: str, chat_history: Sequence[ChatTurn], **llm_settings: Any
    ) -> Generator[str, None, None]:
        cfg = get_config()
        # Document retrieval rides the shared cross-request micro-batcher;
        # conversation memory stays direct (its store is per-process and
        # tiny — batching would only add the wait window).
        doc_hits = self._retrieve(query)
        mem_hits = self._memory.retrieve(query)
        context = self._retriever.build_context(doc_hits)
        history = "\n".join(h.chunk.text for h in mem_hits)
        logger.info(
            "multi-turn: %d doc chunks, %d memory chunks", len(doc_hits), len(mem_hits)
        )
        system = cfg.prompts.multi_turn_rag_template.format(
            context=context, history=history
        )
        messages = [("system", system)]
        messages += [(r, c) for r, c in chat_history]
        messages.append(("user", query))

        # Stream while accumulating, then write the turn back into memory
        # (reference generator-style accumulation, chains.py:168-185).
        parts: list[str] = []
        for chunk in get_chat_llm().stream(messages, **_llm_params(llm_settings)):
            parts.append(chunk)
            yield chunk
        answer = "".join(parts)
        if answer.strip():
            self._remember(query, answer)

    def llm_chain(
        self, query: str, chat_history: Sequence[ChatTurn], **llm_settings: Any
    ) -> Generator[str, None, None]:
        parts: list[str] = []
        for chunk in super().llm_chain(query, chat_history, **llm_settings):
            parts.append(chunk)
            yield chunk
        answer = "".join(parts)
        if answer.strip():
            self._remember(query, answer)
