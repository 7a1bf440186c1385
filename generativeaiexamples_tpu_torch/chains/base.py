"""Pipeline plugin contract (a copy of the JAX package's ``chains/base.py``).

Mirror of the reference plugin ABC (``common/base.py:21-33``) plus the three
optional document-management hooks the server probes for
(``common/server.py:345-427``).  Any class implementing the three required
methods is discoverable by the chain server — pipelines are drop-in.
"""

from __future__ import annotations

import abc
from typing import Any, Generator, Sequence

# (role, content) turns; the server converts its Message models to these.
ChatTurn = tuple[str, str]


class BaseExample(abc.ABC):
    """Interface for RAG pipeline examples."""

    @abc.abstractmethod
    def ingest_docs(self, file_path: str, filename: str) -> None:
        """Ingest one uploaded document into the vector store."""

    @abc.abstractmethod
    def llm_chain(
        self, query: str, chat_history: Sequence[ChatTurn], **llm_settings: Any
    ) -> Generator[str, None, None]:
        """Answer without retrieval (knowledge base off)."""

    @abc.abstractmethod
    def rag_chain(
        self, query: str, chat_history: Sequence[ChatTurn], **llm_settings: Any
    ) -> Generator[str, None, None]:
        """Answer grounded in retrieved context (knowledge base on)."""

    # Optional hooks — implemented by pipelines that support them.

    def document_search(self, content: str, num_docs: int) -> list[dict[str, Any]]:
        """Search for document chunks: [{"source": ..., "content": ...,
        "score": ...}] (reference ``server.py:345-375``)."""
        raise NotImplementedError

    def get_documents(self) -> list[str]:
        """List ingested source documents."""
        raise NotImplementedError

    def delete_documents(self, filenames: Sequence[str]) -> bool:
        """Delete all chunks of the given source documents."""
        raise NotImplementedError
