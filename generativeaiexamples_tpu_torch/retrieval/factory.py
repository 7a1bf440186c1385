"""Vector-store factory keyed by config (port of the JAX package's
``retrieval/factory.py``).

The same ``vector_store.*`` keys pick the backend: ``tpu`` (the exact or
compressed store on the card, ``GPUVectorStore``; as in the reference,
``index_type`` does not apply to it), ``tpu-ivf`` (``GPUIVFVectorStore``),
``auto`` (the IVF store with the measured exact-to-IVF crossover as its
training floor) and ``memory`` (numpy).  The port has one device and no
mesh.  The scale-out backends raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

import os
from typing import Optional

from generativeaiexamples_tpu_torch.core.configuration import AppConfig, get_config
from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.retrieval.base import VectorStore
from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore

# Backends of the reference that the port does not have yet, and the
# ``ROADMAP.md`` Queue 1 item that ports each.
_NOT_PORTED = {
    "fabric": "item 8 (scale-out retrieval: the sharded fabric)",
    "native": "item 8 (scale-out retrieval: the C++ CPU store)",
    "milvus": "item 8 (scale-out retrieval: external stores)",
    "elasticsearch": "item 8 (scale-out retrieval: external stores)",
    "pgvector": "item 8 (scale-out retrieval: external stores)",
}

# Rows above which the IVF store's clustered search replaces the exact
# scan (the ``auto`` store's training floor), by (device type, dim range):
#   cpu: the reference's CPU sweep (perf/bench_retrieval_sweep.py,
#        PERF_NOTES.md): 6,000 at dim <= 512, 16,000 above.  ``auto`` on
#        the CPU gives what the reference gives without its native library.
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
    name, and ``quantization`` / ``pq_m`` / ``rescore_multiplier`` /
    ``recall_target`` the scoring knobs.  ``collection`` names the
    collection; the reference gives it to the external stores, which the
    port does not have, so the in-process backends here ignore it.
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
    if name == "memory":
        return MemoryVectorStore(dim)
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
            ivf_kw["min_train_size"] = crossover_rows(dim, device.type)
        return GPUIVFVectorStore(dim, device=device, **ivf_kw, **quant_kw)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"vector store backend {name!r} is not ported to the PyTorch package yet "
            f"(ROADMAP.md, Queue 1 {_NOT_PORTED[name]})"
        )
    raise ValueError(f"unknown vector store backend {name!r}")
