"""Batch embedding inference (port of ``engine/embedder.py``).

All implementations share the LangChain-flavoured interface the vector
stores consume: ``embed_documents`` / ``embed_query`` (and, where a batch
forward can answer many queries, ``embed_queries``).

Implementations:
  * :class:`GPUEmbedder`: the arctic-embed-l-class BERT encoder
    (``models.bert``) on the card, in length- and batch-bucketed forwards.
  * :class:`HashEmbedder`: deterministic, dependency-free fake for hermetic
    tests (a copy of the reference's).

The reference's ``STEmbedder`` (sentence-transformers on the CPU) is not
ported: the card machine has no sentence-transformers (``ROADMAP.md``).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
from generativeaiexamples_tpu_torch.models import bert
from generativeaiexamples_tpu_torch.utils.buckets import bucket_size

logger = get_logger(__name__)

# arctic-embed models expect this prefix on queries (not on documents).
QUERY_PREFIX = "Represent this sentence for searching relevant passages: "

# Smallest batch bucket a call pays for (the reference's floor without a mesh).
BATCH_FLOOR = 4


class Embedder(Protocol):
    dimensions: int

    def embed_documents(self, texts: Sequence[str]) -> list[list[float]]: ...

    def embed_query(self, text: str) -> list[float]: ...

    # Optional batched-query surface: implementations that can answer many
    # queries in shared device forwards expose ``embed_queries``; callers
    # (the micro-batcher) feature-detect it and fall back to a per-query
    # loop otherwise.


class GPUEmbedder:
    """BERT-encoder embeddings on the card (counterpart of the reference's
    ``TPUEmbedder``; no mesh).

    A batch pads its length to a bucket of its longest text and its rows
    to a power of two between 4 and ``batch_size``; ``bucket_batch=False``
    pads every call to ``batch_size`` (the reference's A/B switch).  Runs
    on ``cuda`` unless ``device="cpu"`` is passed; random params (no
    ``params``) come from seed 0, as the reference's ``PRNGKey(0)``.
    """

    def __init__(
        self,
        cfg: Optional[bert.BertConfig] = None,
        params=None,
        *,
        tokenizer=None,
        batch_size: int = 32,
        max_length: int = 512,
        query_prefix: str = QUERY_PREFIX,
        bucket_batch: bool = True,
        device=None,
    ) -> None:
        self.cfg = cfg or bert.arctic_embed_l()
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.bucket_batch = bucket_batch
        self.max_length = min(max_length, self.cfg.max_positions)
        self.query_prefix = query_prefix
        self.dimensions = self.cfg.d_model
        self.tokenizer = tokenizer or get_tokenizer(None)
        if params is None:
            logger.info("initializing random embedder params (%s, seed 0)", self.cfg)
            params = bert.init_params(self.cfg, torch.Generator(device=self.device).manual_seed(0), self.device)
        self.params = params

    def _encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        ids = [self.tokenizer.encode(t, add_bos=True)[: self.max_length] for t in texts]
        longest = max(len(i) for i in ids)
        s = bucket_size(longest, maximum=self.max_length)
        n = len(ids)
        if self.bucket_batch:
            b = bucket_size(n, minimum=min(self.batch_size, BATCH_FLOOR), maximum=self.batch_size)
        else:
            b = self.batch_size
        tokens = np.zeros((b, s), dtype=np.int32)
        mask = np.zeros((b, s), dtype=np.int32)
        for i, row in enumerate(ids):
            tokens[i, : len(row)] = row
            mask[i, : len(row)] = 1
        mask[n:, 0] = 1  # dummy rows need one valid token for mean pooling
        with torch.inference_mode():
            out = bert.embed(
                self.params, self.cfg, torch.from_numpy(tokens).to(self.device), torch.from_numpy(mask).to(self.device)
            )
            return out[:n].cpu().numpy()

    def _embed_chunks(self, texts: Sequence[str]) -> list[list[float]]:
        out: list[list[float]] = []
        for i in range(0, len(texts), self.batch_size):
            out.extend(self._encode_batch(texts[i : i + self.batch_size]).tolist())
        return out

    def embed_documents(self, texts: Sequence[str]) -> list[list[float]]:
        return self._embed_chunks(texts)

    def embed_query(self, text: str) -> list[float]:
        return self._encode_batch([self.query_prefix + text])[0].tolist()

    def embed_queries(self, texts: Sequence[str]) -> list[list[float]]:
        """N queries in ceil(N / batch_size) forwards instead of N batch-1
        forwards (the micro-batcher's path)."""
        return self._embed_chunks([self.query_prefix + t for t in texts])


class HashEmbedder:
    """Deterministic unit-norm embeddings from a SHA-256 seed.

    Hermetic stand-in for tests: equal texts map to equal vectors,
    different texts to near-orthogonal ones.
    """

    def __init__(self, dimensions: int = 1024) -> None:
        self.dimensions = dimensions

    def _vec(self, text: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")
        rng = np.random.default_rng(seed)
        v = rng.standard_normal(self.dimensions)
        return v / np.linalg.norm(v)

    def embed_documents(self, texts: Sequence[str]) -> list[list[float]]:
        return [self._vec(t).tolist() for t in texts]

    def embed_query(self, text: str) -> list[float]:
        return self._vec(text).tolist()

    def embed_queries(self, texts: Sequence[str]) -> list[list[float]]:
        return [self._vec(t).tolist() for t in texts]
