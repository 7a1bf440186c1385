"""The port's two-tier result cache against the JAX package's on the CPU.

One seeded sequence of ``admit``, ``lookup_exact``,
``lookup_semantic_many``, ``lookup_stale``, version bumps and ``clear``
runs through both caches; every answer, the hit/miss/invalidation
counters and the ring occupancy must be equal after every step.  The
sequence wraps the semantic ring (4 slots) and evicts from the exact LRU
(6 entries).  Similarities must agree within ``SIM_TOL``: the port's ring
product accumulates in f64 and rounds to f32, the reference's is an f32
dot (``cache/core.py`` of each package).
"""

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.cache import core as jcore
from generativeaiexamples_tpu.cache.metrics import cache_snapshot as j_snapshot
from generativeaiexamples_tpu.cache.metrics import reset_cache_metrics as j_reset
from generativeaiexamples_tpu_torch.cache import core as tcore
from generativeaiexamples_tpu_torch.cache.metrics import cache_snapshot as t_snapshot
from generativeaiexamples_tpu_torch.cache.metrics import reset_cache_metrics as t_reset

DIM = 16
SIM_TOL = 1e-6
CAP = dict(max_entries=6, semantic_entries=4)


@pytest.fixture(autouse=True)
def _clean_counters():
    j_reset()
    t_reset()
    yield
    j_reset()
    t_reset()


def _pair(**kw):
    return jcore.RetrievalCache(DIM, **kw), tcore.RetrievalCache(DIM, device="cpu", **kw)


def _key(entry):
    if entry is None:
        return None
    return (entry.query, entry.top_k, entry.chain, entry.store_version, tuple(entry.hits), tuple(entry.candidates))


def _unit(v):
    v = np.asarray(v, dtype=np.float32)
    return v / np.linalg.norm(v)


def _near(v, rng, cos=0.995):
    """A unit vector at cosine ``cos`` from unit ``v``."""
    w = rng.standard_normal(DIM).astype(np.float32)
    w -= w.dot(v) * v
    w /= np.linalg.norm(w)
    return _unit(cos * v + np.sqrt(1 - cos * cos) * w)


def _counters(snap):
    return {k: snap[k] for k in ("hits", "misses", "invalidations", "semantic_scan_count")}


def _same_semantic(got_j, got_t):
    assert len(got_j) == len(got_t)
    for a, b in zip(got_j, got_t):
        assert (a is None) == (b is None)
        if a is not None:
            assert _key(a[0]) == _key(b[0])
            assert abs(a[1] - b[1]) <= SIM_TOL


def test_seeded_sequence_matches_reference():
    rng = np.random.default_rng(7)
    jc, tc = _pair(**CAP)
    version = 0
    admitted = []  # (query, top_k, chain, embedding)
    for step in range(160):
        ops = ["admit", "admit", "exact", "semantic", "stale", "bump"] + (["clear"] if step % 50 == 49 else [])
        op = rng.choice(ops)
        if op == "admit":
            q = f"Query  number {int(rng.integers(0, 12))}"
            k = int(rng.choice([2, 4]))
            chain = str(rng.choice(["rag", "rag", "other"]))
            if admitted and rng.random() < 0.3:
                emb = _near(admitted[int(rng.integers(0, len(admitted)))][3], rng)
            else:
                emb = _unit(rng.standard_normal(DIM))
            emb_arg = None if rng.random() < 0.15 else emb
            hits = [f"hit {step} {i}" for i in range(k)]
            ja = jc.admit(q, k, chain, version, emb_arg, hits + ["extra"], hits)
            ta = tc.admit(q, k, chain, version, emb_arg, hits + ["extra"], hits)
            assert _key(ja) == _key(ta)
            admitted.append((q, k, chain, emb))
        elif op == "exact" and admitted:
            q, k, chain, _ = admitted[int(rng.integers(0, len(admitted)))]
            q = "  " + q.upper() + " " if rng.random() < 0.5 else q
            assert _key(jc.lookup_exact(q, k, chain, version)) == _key(tc.lookup_exact(q, k, chain, version))
        elif op == "semantic":
            embs = []
            for _ in range(int(rng.integers(1, 6))):
                if admitted and rng.random() < 0.6:
                    embs.append(_near(admitted[int(rng.integers(0, len(admitted)))][3], rng, cos=0.99))
                else:
                    embs.append(_unit(rng.standard_normal(DIM)))
            chain = str(rng.choice(["rag", "other"]))
            embs = [e.tolist() for e in embs]
            _same_semantic(jc.lookup_semantic_many(embs, chain, version), tc.lookup_semantic_many(embs, chain, version))
        elif op == "stale" and admitted:
            q, _, chain, emb = admitted[int(rng.integers(0, len(admitted)))]
            q = q if rng.random() < 0.5 else "never asked"
            emb = _near(emb, rng) if rng.random() < 0.5 else None
            assert _key(jc.lookup_stale(q, chain, emb)) == _key(tc.lookup_stale(q, chain, emb))
        elif op == "bump":
            version += 1
        elif op == "clear":
            jc.clear()
            tc.clear()
        assert jc.stats() == tc.stats()
        assert len(jc) == len(tc)
        assert _counters(j_snapshot()) == _counters(t_snapshot())
    snap = t_snapshot()
    assert snap["hits"].get("exact", 0) and snap["hits"].get("semantic", 0) == 0  # semantic hits are the caller's
    assert snap["invalidations"] and snap["semantic_scan_count"]


def test_ring_wraps_and_lru_evicts_like_the_reference():
    rng = np.random.default_rng(1)
    jc, tc = _pair(**CAP)
    vecs = [_unit(rng.standard_normal(DIM)) for _ in range(9)]
    for i, v in enumerate(vecs):
        for c in (jc, tc):
            c.admit(f"q{i}", 2, "rag", 0, v, [i], [i])
    # 9 admits: the exact tier keeps the last 6, the ring the last 4.
    assert jc.stats() == tc.stats() == {"entries": 6, "ring_entries": 4}
    for c in (jc, tc):
        assert c.lookup_exact("q2", 2, "rag", 0) is None and c.lookup_exact("q3", 2, "rag", 0) is not None
    got_j = jc.lookup_semantic_many([v.tolist() for v in vecs], "rag", 0)
    got_t = tc.lookup_semantic_many([v.tolist() for v in vecs], "rag", 0)
    _same_semantic(got_j, got_t)
    assert [g is not None for g in got_t] == [False] * 5 + [True] * 4
    assert bool(tc._ring_valid.all()) and tc._ring_next == 9 % 4


def test_version_mismatch_invalidates_both_tiers():
    rng = np.random.default_rng(2)
    jc, tc = _pair()
    v = _unit(rng.standard_normal(DIM))
    for c in (jc, tc):
        c.admit("q", 2, "rag", 3, v, ["a"], ["a"])
    _same_semantic(jc.lookup_semantic_many([v.tolist()], "rag", 4), tc.lookup_semantic_many([v.tolist()], "rag", 4))
    assert jc.stats() == tc.stats() == {"entries": 0, "ring_entries": 0}
    for c in (jc, tc):
        c.admit("q", 2, "rag", 3, v, ["a"], ["a"])
        assert c.lookup_exact("q", 2, "rag", 4) is None
    assert _counters(j_snapshot()) == _counters(t_snapshot())
    assert t_snapshot()["invalidations"] == 2


@pytest.mark.parametrize("tied_admits", [(1, 3), (3, 4)])
def test_planted_ties_take_the_first_slot(tied_admits):
    """Two ring slots hold the same vector: both argmaxes take the lower
    slot, whether it holds the older entry (admits 1 and 3: slots 1 and 3)
    or, after the ring wrapped, the newer (admits 3 and 4: slots 3 and 0)."""
    rng = np.random.default_rng(3)
    jc, tc = _pair(semantic_entries=4, max_entries=16)
    tie = _unit(rng.standard_normal(DIM))
    for i in range(5):
        v = tie if i in tied_admits else _unit(rng.standard_normal(DIM))
        for c in (jc, tc):
            c.admit(f"q{i}", 2, "rag", 0, v, [i], [i])
    tied = [s for s, e in enumerate(tc._ring_entries) if np.array_equal(e.embedding, tie)]
    assert tied == sorted(i % 4 for i in tied_admits)
    got_j = jc.lookup_semantic_many([tie.tolist()], "rag", 0)
    got_t = tc.lookup_semantic_many([tie.tolist()], "rag", 0)
    _same_semantic(got_j, got_t)
    assert got_t[0][0] is tc._ring_entries[tied[0]]
    best, sim = tcore.ring_best(tc._ring, tc._ring_valid, torch.from_numpy(np.stack([tie, tie])))
    assert best.tolist() == [tied[0]] * 2 and sim[0] == sim[1]


def test_lookup_holding_a_snapshot_across_an_admit(monkeypatch):
    """An admit that lands while a lookup scores its captured (ring, valid)
    pair does not change what that lookup sees: the new vector goes into a
    copy.  Same interleaving in both packages, same answer."""
    rng = np.random.default_rng(4)
    jc, tc = _pair(semantic_entries=2, max_entries=16)
    old = [_unit(rng.standard_normal(DIM)) for _ in range(2)]
    for c in (jc, tc):
        for i, v in enumerate(old):
            c.admit(f"old{i}", 2, "rag", 0, v, [i], [i])
    query = _unit(rng.standard_normal(DIM))
    held = {}

    def interleave(mod, name, cache):
        orig = getattr(mod, name)

        def wrapped(ring, valid, qs):
            held[mod] = (ring, ring.clone() if isinstance(ring, torch.Tensor) else np.asarray(ring).copy())
            cache.admit("new", 2, "rag", 0, query, ["n"], ["n"])  # lands in slot 0, over old0
            return orig(ring, valid, qs)

        monkeypatch.setattr(mod, name, wrapped)

    interleave(jcore, "_ring_best", jc)
    interleave(tcore, "ring_best", tc)
    got_j = jc.lookup_semantic_many([query.tolist()], "rag", 0)
    got_t = tc.lookup_semantic_many([query.tolist()], "rag", 0)
    _same_semantic(got_j, got_t)
    assert got_t == [None]  # the pre-admit ring: no slot near the query
    ring, before = held[tcore]
    assert torch.equal(ring, before) and tc._ring is not ring
    monkeypatch.undo()
    assert tc.lookup_semantic_many([query.tolist()], "rag", 0)[0][0].query == "new"


def test_ring_lookup_ignores_the_matmul_precision_setting():
    """The hit test never runs in TF32: the ring product is f64 whatever
    ``torch.set_float32_matmul_precision`` says."""
    rng = np.random.default_rng(5)
    ring = torch.from_numpy(np.stack([_unit(rng.standard_normal(DIM)) for _ in range(8)]))
    qs = torch.from_numpy(np.stack([_unit(rng.standard_normal(DIM)) for _ in range(3)]))
    valid = torch.ones(8, dtype=torch.bool)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        best, sim = tcore.ring_best(ring, valid, qs)
    finally:
        torch.set_float32_matmul_precision(prev)
    exact = qs.double() @ ring.double().T
    assert best.tolist() == exact.argmax(1).tolist()
    assert torch.equal(sim, exact.max(1).values.float())
