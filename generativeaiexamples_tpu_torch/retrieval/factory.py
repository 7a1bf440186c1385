"""Vector-store factory keyed by config (port of the JAX package's
``retrieval/factory.py``).

The same ``vector_store.*`` keys pick the backend: ``tpu`` (the exact or
compressed store on the card, ``GPUVectorStore``; as in the reference,
``index_type`` does not apply to it), ``tpu-ivf`` (``GPUIVFVectorStore``),
``auto`` (on the card the IVF store with the measured exact-to-IVF
crossover as its training floor; on the CPU the C++ IVF store with it as
its build threshold, or the IVF store where the C++ library does not
build, as in the reference), ``fabric`` (the sharded scatter-gather store
over ``fabric.child_backend`` children, ``retrieval/fabric/``), ``native``
(the C++ CPU store), ``memory`` (numpy), and the external services
``milvus``, ``elasticsearch`` and ``pgvector``.  The port has one device
and no mesh.
"""

from __future__ import annotations

import os
from typing import Optional

from generativeaiexamples_tpu_torch.core.configuration import AppConfig, get_config
from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.retrieval.base import VectorStore
from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore

# Rows above which the IVF store's clustered search replaces the exact
# scan (the ``auto`` store's training floor), by (device type, dim range):
#   cpu: the reference's CPU sweep (perf/bench_retrieval_sweep.py,
#        PERF_NOTES.md): 6,000 at dim <= 512, 16,000 above; ``auto`` on the
#        CPU builds the C++ store with it as the IVF build threshold, as
#        the reference does.
#   cuda: chip_smoke.py's ``store_crossover`` line (NVIDIA H100 80GB HBM3,
#        700.00 W; PERF.md section 6): at dim 1024 the exact scan took 1.30
#        ms of device per 128 queries at 131,072 rows and 5.86 ms at
#        1,000,000, the IVF store (nlist 64, nprobe 16) 73.8 and 313.5 ms.
#        Each IVF query reads nprobe / nlist of the padded lists (~half the
#        corpus), where the exact scan reads the corpus once per 32-query
#        chunk, so IVF moves more bytes at every size: the switch sits where
#        the exact bf16 buffer no longer fits the card's 80 GB, 2^25 rows
#        above dim 512 (64 GiB) and 2^26 at or below it.
_CROSSOVER_ROWS = {
    ("cpu", "narrow"): 6_000,
    ("cpu", "wide"): 16_000,
    ("cuda", "narrow"): 1 << 26,
    ("cuda", "wide"): 1 << 25,
}


def crossover_rows(dim: int, platform: str) -> int:
    """Corpus size above which clustered (IVF) search beats the exact scan
    for this dim on this device type (``cpu`` or ``cuda``);
    ``GAIE_RETRIEVAL_CROSSOVER`` pins another value."""
    env = os.environ.get("GAIE_RETRIEVAL_CROSSOVER")
    if env:
        try:
            value = int(env)
        except ValueError:
            raise ValueError(f"GAIE_RETRIEVAL_CROSSOVER={env!r} is not an integer row count") from None
        if value <= 0:
            raise ValueError(f"GAIE_RETRIEVAL_CROSSOVER must be positive, got {value}")
        return value
    return _CROSSOVER_ROWS[(platform, "narrow" if dim <= 512 else "wide")]


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
    name, ``quantization`` / ``pq_m`` / ``rescore_multiplier`` /
    ``recall_target`` the scoring knobs, and ``num_shards`` /
    ``hot_shard_budget`` / ``child_backend`` the fabric's topology.
    ``collection`` names the collection: the external stores and the
    fabric's children carry it in their names.  The host stores
    (``memory``, ``native``, the external services) take no device; the
    fabric gives its children ``device``.
    """
    config = config or get_config()
    overrides = overrides or {}
    name = str(overrides.get("backend", config.vector_store.name)).lower()
    dim = dimensions or config.embeddings.dimensions
    # The widest query batch the retrieval micro-batcher dispatches; with
    # batching off, the store's default bound applies.
    qcap = config.retriever.batch_max_size if config.retriever.batch_max_size > 1 else 128
    vs = config.vector_store
    quant_kw = dict(quantization=vs.quantization, pq_m=vs.pq_m, rescore_multiplier=vs.rescore_multiplier,
                    recall_target=vs.recall_target)
    for key in quant_kw:
        if key in overrides:
            quant_kw[key] = overrides[key]
    if name == "fabric":
        from generativeaiexamples_tpu_torch.retrieval.fabric.sharded import ShardedVectorStore

        fab = config.fabric
        child_backend = str(overrides.get("child_backend", fab.child_backend)).lower()
        if child_backend == "fabric":
            raise ValueError("fabric.child_backend cannot itself be 'fabric' (shards do not nest)")

        def _child(idx: int) -> VectorStore:
            return get_vector_store(config, dimensions=dim, device=device, collection=f"{collection}-shard{idx}",
                                    overrides={**overrides, "backend": child_backend})

        return ShardedVectorStore(
            dim,
            num_shards=int(overrides.get("num_shards", fab.num_shards)),
            shard_factory=_child,
            rescore_multiplier=quant_kw["rescore_multiplier"],
            margin=fab.margin,
            fanout_max_batch=fab.fanout_max_batch,
            fanout_wait_ms=fab.fanout_wait_ms,
            hot_shard_budget=int(overrides.get("hot_shard_budget", fab.hot_shard_budget)),
            ewma_alpha=fab.ewma_alpha,
            pq_m=quant_kw["pq_m"],
            name=f"fabric-{collection}",
            device=device,
        )
    if name == "memory":
        return MemoryVectorStore(dim)
    if name == "native":
        from generativeaiexamples_tpu_torch.retrieval.native import NativeVectorStore

        return NativeVectorStore(dim, index_type=vs.index_type, nlist=vs.nlist, nprobe=vs.nprobe)
    if name == "milvus":
        from generativeaiexamples_tpu_torch.retrieval.milvus_compat import _COLLECTION, MilvusVectorStore

        return MilvusVectorStore(dim, url=vs.url, collection=f"{_COLLECTION}_{collection}")
    if name == "elasticsearch":
        from generativeaiexamples_tpu_torch.retrieval.elastic_compat import _INDEX, ElasticsearchVectorStore

        return ElasticsearchVectorStore(dim, url=vs.url or "http://localhost:9200",
                                        index=f"{_INDEX}-{collection}".lower())
    if name == "pgvector":
        from generativeaiexamples_tpu_torch.retrieval.pgvector_compat import PgVectorStore

        return PgVectorStore(dim, url=vs.url, table_suffix=collection)
    if name == "tpu":
        from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

        return GPUVectorStore(dim, device=device, max_query_batch=qcap, **quant_kw)
    if name in ("tpu-ivf", "auto"):
        from generativeaiexamples_tpu_torch.retrieval.gpu import GPUIVFVectorStore

        ivf_kw = dict(nlist=vs.nlist, nprobe=vs.nprobe, max_query_batch=qcap, retrain_growth=vs.retrain_growth)
        if name == "auto":
            # Exact below the crossover, clustered above it: the corpus grows
            # through the switch point without a migration.
            device = resolve_device(device)
            cross = crossover_rows(dim, device.type)
            ivf_kw["min_train_size"] = cross
            if device.type == "cpu":
                # On the CPU the C++ IVF store, as the reference picks it;
                # the IVF store serves only where the library does not build.
                import subprocess

                try:
                    from generativeaiexamples_tpu_torch.retrieval.native import NativeVectorStore

                    return NativeVectorStore(dim, index_type="ivf", nlist=vs.nlist, nprobe=vs.nprobe,
                                             ivf_build_threshold=cross)
                except (OSError, subprocess.CalledProcessError):
                    pass
        return GPUIVFVectorStore(dim, device=device, **ivf_kw, **quant_kw)
    raise ValueError(f"unknown vector store backend {name!r}")
