"""The retrieval chain's device parts on the card against the CPU: the
result cache's semantic ring and the store's host fallback.

These skip without a card (the decision is made inside the fixture).  On a
machine with one:

    python -m pytest --noconftest tests/test_torch_retriever_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import RANK_EPS
from generativeaiexamples_tpu_torch.cache.core import RetrievalCache, ring_best
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

pytestmark = pytest.mark.cuda

D = 1024
# The ring's similarities on the card and on the CPU: both are f64 products
# rounded once to f32, so they differ by at most an f32 ulp or two.
SIM_TOL = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def test_ring_on_card_matches_cpu(dev):
    """A full 512 x 1024 ring, 128 lookups near stored vectors and 128
    random ones, under a TF32-allowing global setting: the same argmax,
    similarities within SIM_TOL and the same hit/miss at 0.98 on both."""
    rng = np.random.default_rng(0)
    stored = _unit(rng.standard_normal((600, D)))
    near = _unit(stored[rng.integers(88, 600, 128)] + 0.1 / np.sqrt(D) * rng.standard_normal((128, D)))
    queries = np.concatenate([near, _unit(rng.standard_normal((128, D)))]).tolist()
    caches = [RetrievalCache(D, device=d) for d in (dev, "cpu")]
    for c in caches:
        for i, v in enumerate(stored):  # 600 admits: the ring wraps
            c.admit(f"q{i}", 4, "rag", 0, v, [i], [i])
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got, want = (c.lookup_semantic_many(queries, "rag", 0) for c in caches)
        best = [ring_best(c._ring, c._ring_valid, torch.tensor(queries, device=c.device)) for c in caches]
    finally:
        torch.set_float32_matmul_precision(prev)
    assert [g is None for g in got] == [w is None for w in want]
    assert sum(g is not None for g in got) == 128
    for g, w in zip(got, want):
        if g is not None:
            assert g[0].query == w[0].query and abs(g[1] - w[1]) <= SIM_TOL
    assert torch.equal(best[0][0].cpu(), best[1][0])
    torch.testing.assert_close(best[0][1].cpu(), best[1][1], atol=SIM_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_search_fallback_matches_the_device_search(dev, dtype):
    """The host fallback ranks as the card's search wherever the gap below a
    rank exceeds RANK_EPS, with scores within 1e-5, masks honoured."""
    rng = np.random.default_rng(1)
    centres = _unit(rng.standard_normal((64, D)))
    vecs = _unit(centres[rng.integers(0, 64, 20000)] + 0.8 / np.sqrt(D) * rng.standard_normal((20000, D)))
    store = GPUVectorStore(D, dtype=dtype, device=dev)
    store.add([Chunk(text=f"t{i}", source=f"s{i % 9}", id=str(i)) for i in range(18000)], vecs[:18000])
    store.search(vecs[0], 1)
    store.add([Chunk(text=f"t{i}", source="tail", id=str(i)) for i in range(18000, 20000)], vecs[18000:])
    store.delete_source("s4")
    queries = np.concatenate([vecs[rng.integers(0, 20000, 24)], _unit(rng.standard_normal((8, D)))])
    checked = 0
    for k in (4, 16):
        got, device = store.search_fallback(queries, k), store.search_batch(queries, k)
        for g, w in zip(got, device):
            ws = [h.score for h in w]
            np.testing.assert_allclose([h.score for h in g], ws, atol=1e-5, rtol=0)
            for j in range(k - 1):
                if ws[j] - ws[j + 1] > RANK_EPS:
                    checked += 1
                    assert {h.chunk.id for h in g[: j + 1]} == {h.chunk.id for h in w[: j + 1]}
            assert all(h.chunk.source != "s4" for h in g)
    assert checked > 100
