"""API-catalog-style chat pipeline (port of the JAX package's
``chains/api_catalog.py``).

Parity with the reference ``nvidia_api_catalog`` example
(``examples/nvidia_api_catalog/chains.py``): same canonical RAG flow as
``developer_rag`` but aimed at remote hosted model endpoints — the LLM
connector defaults to the OpenAI-compatible HTTP client, retrieval uses a
similarity-score-threshold search with a graceful empty-store fallback
(``chains.py:117-127``), and the context is concatenated score-ordered.
"""

from __future__ import annotations

from typing import Any, Generator, Sequence

from generativeaiexamples_tpu_torch.chains.base import ChatTurn
from generativeaiexamples_tpu_torch.chains.developer_rag import QAChatbot, _llm_params
from generativeaiexamples_tpu_torch.chains.factory import get_chat_llm
from generativeaiexamples_tpu_torch.core.configuration import get_config
from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


class APICatalogChatbot(QAChatbot):
    """RAG chat against catalog/hosted model endpoints."""

    def rag_chain(
        self, query: str, chat_history: Sequence[ChatTurn], **llm_settings: Any
    ) -> Generator[str, None, None]:
        cfg = get_config()
        try:
            hits = self._retriever.retrieve(query)
        except Exception:
            # Reference behavior: retrieval backend errors degrade to an
            # answer-without-context rather than a 500 (chains.py:117-127).
            logger.exception("retrieval failed; answering without context")
            hits = []
        context = "\n\n".join(h.chunk.text for h in hits)
        system = cfg.prompts.rag_template.format(context=context)
        messages = [("system", system)]
        messages += [(r, c) for r, c in chat_history]
        messages.append(("user", query))
        yield from get_chat_llm().stream(messages, **_llm_params(llm_settings))
