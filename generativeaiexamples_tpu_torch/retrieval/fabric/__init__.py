"""Named multi-tenant collections and the fabric's ``/metrics`` families
(port of the JAX package's ``retrieval/fabric/``, without its sharded
scatter-gather store and host-RAM cold tier: each collection is an
ordinary store from ``retrieval/factory.py``, and the ``rag_shard_*`` and
``rag_coldtier_*`` families export their zeros)."""

from generativeaiexamples_tpu_torch.retrieval.fabric.collections import (
    DEFAULT_COLLECTION,
    CollectionManager,
    CollectionQuotaExceeded,
    UnknownCollection,
)

__all__ = [
    "CollectionManager",
    "CollectionQuotaExceeded",
    "DEFAULT_COLLECTION",
    "UnknownCollection",
]
