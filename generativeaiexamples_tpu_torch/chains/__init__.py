"""RAG pipeline plugins and their factories (port of the JAX package's
``chains/``: the ``developer_rag`` pipeline; the other chains are not
ported yet, ``ROADMAP.md``)."""

from generativeaiexamples_tpu_torch.chains.base import BaseExample

__all__ = ["BaseExample"]
