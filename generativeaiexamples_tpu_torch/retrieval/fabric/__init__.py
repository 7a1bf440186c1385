"""Sharded scatter-gather retrieval fabric (port of the JAX package's
``retrieval/fabric/``): :class:`ShardedVectorStore` (hash-routed
partitions, parallel fan-out, exact-score top-k merge), the host-RAM PQ
cold tier (``coldtier``), named multi-tenant collections with quotas
(``collections``), and the fabric's ``/metrics`` families (``metrics``).
"""

from generativeaiexamples_tpu_torch.retrieval.fabric.coldtier import (
    ColdPartition,
    HostPrefetcher,
)
from generativeaiexamples_tpu_torch.retrieval.fabric.collections import (
    DEFAULT_COLLECTION,
    CollectionManager,
    CollectionQuotaExceeded,
    UnknownCollection,
)
from generativeaiexamples_tpu_torch.retrieval.fabric.sharded import (
    ShardedVectorStore,
)

__all__ = [
    "ColdPartition",
    "CollectionManager",
    "CollectionQuotaExceeded",
    "DEFAULT_COLLECTION",
    "HostPrefetcher",
    "ShardedVectorStore",
    "UnknownCollection",
]
