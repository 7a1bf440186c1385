"""The retrieval side on the card against the same code on the CPU: the
exact store's f32 scan, BERT at arctic-embed-l's width, and a query
embedded alone against the same query inside a batch.

These skip without a card (the decision is made inside the fixture).  On a
machine with one:

    python -m pytest --noconftest tests/test_torch_retrieval_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import BERT_TOL, EMBED_TOL
from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
from generativeaiexamples_tpu_torch.models import bert
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore, scores_f32

pytestmark = pytest.mark.cuda

D = 1024


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((64, D)).astype(np.float32)
    vecs = centres[rng.integers(0, 64, n)] + 0.5 * rng.standard_normal((n, D), dtype=np.float32)
    return (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).astype(np.float32), rng


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_f32_scores_on_card_match_cpu(dev, dtype):
    """Card products of bf16 (or f32, never TF32) operands come out in f32,
    within 1e-5 of the CPU's f32 products: a bf16-rounded result would be
    off by up to 2^-9 of each score."""
    torch.set_float32_matmul_precision("high")  # TF32 allowed globally: the store must pin it off
    try:
        vecs, rng = _corpus(3000)
        t = getattr(torch, dtype)
        Q = torch.from_numpy(vecs[rng.integers(0, 3000, 16)]).to(t)
        rows = torch.from_numpy(vecs).to(t)
        got = scores_f32(Q.to(dev), rows.to(dev))
        want = scores_f32(Q, rows)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
        assert not torch.equal(got.cpu(), want.to(torch.bfloat16).float())
    finally:
        torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_store_on_card_matches_cpu(dev, dtype):
    vecs, rng = _corpus(20000)
    stores = [GPUVectorStore(D, dtype=dtype, device=d) for d in (dev, "cpu")]
    for s in stores:
        s.add([Chunk(text=f"t{i}", source=f"s{i % 9}", id=str(i)) for i in range(18000)], vecs[:18000])
        s.search(vecs[0], 1)
        s.add([Chunk(text=f"t{i}", source="tail", id=str(i)) for i in range(18000, 20000)], vecs[18000:])
        s.delete_source("s3")
    queries = np.concatenate([vecs[rng.integers(0, 20000, 40)], _corpus(24, seed=1)[0]])
    for k in (4, 10):
        got, want = (s.search_batch(queries, k) for s in stores)
        for g, w in zip(got, want):
            # Equal ids wherever the CPU's scores leave a gap above the sums'
            # noise at that rank.
            ws = [h.score for h in w]
            for j in range(k - 1):
                if ws[j] - ws[j + 1] > 1e-5:
                    assert {h.chunk.id for h in g[: j + 1]} == {h.chunk.id for h in w[: j + 1]}
            np.testing.assert_allclose([h.score for h in g], ws, atol=1e-5, rtol=0)
            assert all(h.chunk.source != "s3" for h in g)


def _bert_inputs():
    rng = np.random.default_rng(0)
    lengths = [200, 37, 1, 120, 256, 64, 9, 150]
    tokens = rng.integers(0, 30522, (8, 256)).astype(np.int64)
    mask = (np.arange(256)[None, :] < np.array(lengths)[:, None]).astype(np.int64)
    types = (np.arange(256)[None, :] >= np.array(lengths)[:, None] // 2).astype(np.int64) * mask
    return [torch.from_numpy(a) for a in (tokens, mask, types)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bert_on_card_matches_cpu(dev, dtype):
    """Two layers at arctic-embed-l's width, the same weights on both."""
    cfg = bert.arctic_embed_l(n_layers=2, dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params, head = bert.init_params(cfg, gen, "cpu"), bert.init_rerank_head(cfg, gen, "cpu")
    on_dev = {k: v.to(dev) for k, v in params.items() if k != "layers"}
    on_dev["layers"] = {k: v.to(dev) for k, v in params["layers"].items()}
    head_dev = {k: v.to(dev) for k, v in head.items()}
    tokens, mask, types = _bert_inputs()
    tol = BERT_TOL if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    with torch.inference_mode():
        emb = bert.embed(on_dev, cfg, tokens.to(dev), mask.to(dev)).cpu()
        score = bert.rerank_score(on_dev, head_dev, cfg, tokens.to(dev), mask.to(dev), types.to(dev)).cpu()
        torch.testing.assert_close(emb, bert.embed(params, cfg, tokens, mask), **tol)
        torch.testing.assert_close(score, bert.rerank_score(params, head, cfg, tokens, mask, types), **tol)
    assert torch.isfinite(emb).all() and torch.isfinite(score).all()


def test_query_alone_matches_the_query_in_a_batch(dev):
    embedder = GPUEmbedder(bert.arctic_embed_l(n_layers=4), device=dev)
    queries = [f"query {i}: " + "words " * (i % 7) for i in range(32)]
    batch = np.asarray(embedder.embed_queries(queries))
    alone = np.asarray([embedder.embed_query(q) for q in queries])
    np.testing.assert_allclose(alone, batch, **EMBED_TOL)
    np.testing.assert_allclose(np.linalg.norm(batch, axis=1), 1.0, atol=1e-3)
