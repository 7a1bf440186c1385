"""Vector-store factory keyed by config (port of the JAX package's
``retrieval/factory.py``).

The same ``vector_store.*`` keys pick the backend.  ``tpu`` names the exact
store on the card (``GPUVectorStore``; as in the reference, ``index_type``
does not apply to it) and ``memory`` the numpy store.  The port has one
device and no mesh.  Every other backend raises ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports it.
"""

from __future__ import annotations

from typing import Optional

from generativeaiexamples_tpu_torch.core.configuration import AppConfig, get_config
from generativeaiexamples_tpu_torch.retrieval.base import VectorStore
from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore

# Backends of the reference that the port does not have yet, and the
# ``ROADMAP.md`` Queue 1 item that ports each.
_NOT_PORTED = {
    "auto": "item 4 (the adaptive exact-to-IVF store)",
    "tpu-ivf": "item 4 (the IVF store)",
    "fabric": "item 8 (scale-out retrieval: the sharded fabric)",
    "native": "item 8 (scale-out retrieval: the C++ CPU store)",
    "milvus": "item 8 (scale-out retrieval: external stores)",
    "elasticsearch": "item 8 (scale-out retrieval: external stores)",
    "pgvector": "item 8 (scale-out retrieval: external stores)",
}


def get_vector_store(
    config: Optional[AppConfig] = None,
    *,
    dimensions: Optional[int] = None,
    device=None,
    collection: str = "default",
    overrides: Optional[dict] = None,
) -> VectorStore:
    """Instantiate the configured backend on ``device``: the card
    (``None``) or ``"cpu"``, as for every entry point of the port.

    ``overrides`` is the reference's per-collection escape hatch
    (``CollectionManager.create``): ``backend`` replaces the configured
    name and ``quantization`` the scoring mode (any mode but ``none``
    raises, naming ``ROADMAP.md`` Queue 1 item 4).  ``collection`` names
    the collection; the reference gives it to the external stores, which
    the port does not have, so the in-process backends here ignore it.
    """
    config = config or get_config()
    overrides = overrides or {}
    name = str(overrides.get("backend", config.vector_store.name)).lower()
    dim = dimensions or config.embeddings.dimensions
    # The widest query batch the retrieval micro-batcher dispatches; with
    # batching off, the store's default bound applies.
    qcap = config.retriever.batch_max_size if config.retriever.batch_max_size > 1 else 128
    if name == "memory":
        return MemoryVectorStore(dim)
    if name == "tpu":
        from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

        # A compressed scan raises NotImplementedError in the constructor.
        quantization = overrides.get("quantization", config.vector_store.quantization)
        return GPUVectorStore(dim, device=device, max_query_batch=qcap, quantization=quantization)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"vector store backend {name!r} is not ported to the PyTorch package yet "
            f"(ROADMAP.md, Queue 1 {_NOT_PORTED[name]})"
        )
    raise ValueError(f"unknown vector store backend {name!r}")
