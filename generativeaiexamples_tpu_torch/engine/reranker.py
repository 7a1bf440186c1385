"""Cross-encoder reranking (port of ``engine/reranker.py``): scores (query,
passage) pairs with the BERT cross-encoder (``models.bert.rerank_score``)
on the card.

The port has the byte tokenizer only, so a pair is the query's ids (with
BOS) followed by the passage's, all in segment 0, as the reference does
for a tokenizer without ``encode_pair``.  The two-segment WordPiece
encoding comes with the HF tokenizer (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.core.device import resolve_device
from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
from generativeaiexamples_tpu_torch.models import bert
from generativeaiexamples_tpu_torch.utils.buckets import bucket_size

logger = get_logger(__name__)


class GPUReranker:
    """Cross-encoder on the card: rank passages by relevance to a query
    (counterpart of the reference's ``TPUReranker``).

    Every forward pads its rows to the fixed ``batch_size`` (the reranker
    does not bucket its batch) and its length to a bucket of its longest
    pair.  Runs on ``cuda`` unless ``device="cpu"`` is passed; random
    params and head come from seeds 1 and 2, as the reference's
    ``PRNGKey(1)`` and ``PRNGKey(2)``.
    """

    def __init__(
        self,
        cfg: Optional[bert.BertConfig] = None,
        params=None,
        head=None,
        *,
        tokenizer=None,
        batch_size: int = 16,
        max_length: int = 512,
        device=None,
    ) -> None:
        self.cfg = cfg or bert.arctic_embed_l()
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.max_length = min(max_length, self.cfg.max_positions)
        self.tokenizer = tokenizer or get_tokenizer(None)
        if params is None:
            logger.info("initializing random reranker params (%s)", self.cfg)
            params = bert.init_params(self.cfg, torch.Generator(device=self.device).manual_seed(1), self.device)
        if head is None:
            head = bert.init_rerank_head(self.cfg, torch.Generator(device=self.device).manual_seed(2), self.device)
        self.params = params
        self.head = head

    def _encode_pair(self, query_ids: list[int], passage: str) -> tuple[list[int], list[int]]:
        """(token ids, segment ids) of one pair: the query's ids then the
        passage's, truncated to ``max_length``, all in segment 0."""
        ids = (query_ids + self.tokenizer.encode(" " + passage, add_bos=False))[: self.max_length]
        return ids, [0] * len(ids)

    def _score_rows(self, rows: list[tuple[list[int], list[int]]]) -> list[float]:
        """Encoded (token, segment) rows through the cross-encoder in
        ``batch_size`` slices."""
        out: list[float] = []
        for start in range(0, len(rows), self.batch_size):
            batch = rows[start : start + self.batch_size]
            s = bucket_size(max(len(r) for r, _ in batch), maximum=self.max_length)
            b = self.batch_size
            tokens = np.zeros((b, s), dtype=np.int32)
            mask = np.zeros((b, s), dtype=np.int32)
            types = np.zeros((b, s), dtype=np.int32)
            for i, (r, tt) in enumerate(batch):
                tokens[i, : len(r)] = r
                mask[i, : len(r)] = 1
                types[i, : len(tt)] = tt
            mask[len(batch):, 0] = 1
            with torch.inference_mode():
                scores = bert.rerank_score(
                    self.params, self.head, self.cfg, *(torch.from_numpy(a).to(self.device) for a in (tokens, mask, types))
                )
                out.extend(scores[: len(batch)].cpu().tolist())
        return out

    def score(self, query: str, passages: Sequence[str]) -> list[float]:
        """Relevance score per passage (higher = more relevant)."""
        if not passages:
            return []
        query_ids = self.tokenizer.encode(query, add_bos=True)
        return self._score_rows([self._encode_pair(query_ids, p) for p in passages])

    def score_pairs(self, pairs: Sequence[tuple[str, str]]) -> list[float]:
        """Score (query, passage) pairs, from one request or many, in shared
        batched forwards; each distinct query tokenizes once."""
        if not pairs:
            return []
        query_ids: dict[str, list[int]] = {}
        rows = []
        for q, p in pairs:
            if q not in query_ids:
                query_ids[q] = self.tokenizer.encode(q, add_bos=True)
            rows.append(self._encode_pair(query_ids[q], p))
        return self._score_rows(rows)

    def rerank(self, query: str, passages: Sequence[str], top_k: int) -> list[tuple[int, float]]:
        """(original_index, score) of the top_k passages, best first."""
        scores = self.score(query, passages)
        order = sorted(range(len(scores)), key=lambda i: -scores[i])[:top_k]
        return [(i, scores[i]) for i in order]
