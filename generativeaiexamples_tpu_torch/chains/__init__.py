"""RAG pipeline plugins and their factories (port of the JAX package's
``chains/``: ``developer_rag``, ``multi_turn``, ``query_decomposition`` and
``api_catalog``; the structured-data and multimodal chains are not ported
yet, ``ROADMAP.md``)."""

from generativeaiexamples_tpu_torch.chains.base import BaseExample

__all__ = ["BaseExample"]
