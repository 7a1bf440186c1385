"""The port's exact vector store (``retrieval/gpu.py``) against the JAX
package's ``TPUVectorStore`` on the CPU, in float32 and in bfloat16.

Both stores take the same numpy corpora (clustered unit vectors from a
seed) through the same adds, deletes, appends and compactions.  Ids must
be equal (the corpora have no ties except where a test plants them) and
scores within 1e-5 (f32 sums in another order).  The bf16 device buffers
must hold the same bits, ties must rank the lower row first as
``lax.top_k`` does, and a snapshot saved by either package loads into the
other.
"""

import threading

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.retrieval.base import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.tpu import TPUIVFVectorStore, TPUVectorStore
from generativeaiexamples_tpu_torch.retrieval import gpu as gpu_mod
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

DIM = 64
SCORE_TOL = 1e-5
DTYPES = ["float32", "bfloat16"]


def _clustered(n, dim=DIM, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((16, dim))
    vecs = centres[rng.integers(0, 16, n)] + 0.4 * rng.standard_normal((n, dim))
    return (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).astype(np.float32), rng


class Pair:
    """The JAX store and the port's store, driven alike."""

    def __init__(self, dtype, **kw):
        self.ref = TPUVectorStore(DIM, dtype=dtype, **kw)
        self.port = GPUVectorStore(DIM, dtype=dtype, device="cpu", **kw)

    def add(self, texts, sources, vecs):
        a = self.ref.add([JChunk(text=t, source=s) for t, s in zip(texts, sources)], vecs)
        b = self.port.add([Chunk(text=t, source=s) for t, s in zip(texts, sources)], vecs)
        assert len(a) == len(b) == len(texts)

    def delete(self, source):
        assert self.ref.delete_source(source) == self.port.delete_source(source)

    def check(self, queries, k=10):
        """Single and batched search give the reference's ids, in order,
        and its scores within SCORE_TOL."""
        for got, want in ((self.port.search_batch(queries, k), self.ref.search_batch(queries, k)),
                          ([self.port.search(q, k) for q in queries], [self.ref.search(q, k) for q in queries])):
            assert [[h.chunk.text for h in r] for r in got] == [[h.chunk.text for h in r] for r in want]
            np.testing.assert_allclose([h.score for r in got for h in r], [h.score for r in want for h in r],
                                       atol=SCORE_TOL, rtol=0)
        assert len(self.port) == len(self.ref)
        assert self.port.sources() == self.ref.sources()
        assert self.port.capacity_stats() == self.ref.capacity_stats()
        assert self.port.scanned_bytes_per_query(k) == self.ref.scanned_bytes_per_query(k)


def _texts(prefix, lo, hi):
    return [f"{prefix}{i}" for i in range(lo, hi)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_add_search_and_search_batch_match_reference(dtype):
    vecs, rng = _clustered(1500)
    pair = Pair(dtype)
    pair.add(_texts("t", 0, 1500), [f"s{i % 7}" for i in range(1500)], vecs)
    queries = np.concatenate([vecs[rng.integers(0, 1500, 5)], _clustered(6, seed=1)[0]])
    for k in (1, 4, 10):
        pair.check(queries, k)
    assert pair.port.search(queries[0], 0) == [] and pair.port.search_batch([], 4) == []
    assert GPUVectorStore(DIM, device="cpu").search(queries[0], 4) == []


@pytest.mark.parametrize("dtype", DTYPES)
def test_capacity_growth_and_compaction(dtype):
    """Past the capacity the main buffer doubles (a rebuild); past the tail
    the tail folds into a rebuilt main buffer."""
    vecs, rng = _clustered(3000)
    pair = Pair(dtype)
    pair.add(_texts("a", 0, 900), ["a"] * 900, vecs[:900])
    pair.check(vecs[:3])
    assert int(pair.port._device_buf.shape[0]) == 1024
    pair.add(_texts("b", 900, 1300), ["b"] * 400, vecs[900:1300])  # capacity 1024 -> 2048
    pair.check(vecs[[5, 950, 1299]])
    for store in (pair.port, pair.ref):
        assert int(store._device_buf.shape[0]) == 2048 and store._base == 1300
    pair.add(_texts("c", 1300, 1500), ["c"] * 200, vecs[1300:1500])  # rides the 1024-row tail
    pair.check(vecs[[1400, 7]])
    assert pair.port._base == pair.ref._base == 1300
    pair.add(_texts("d", 1500, 2500), ["d"] * 1000, vecs[1500:2500])  # 1200 > the tail: compaction
    pair.check(vecs[[2400, 1450, 3]])
    assert pair.port._base == pair.ref._base == 2500


@pytest.mark.parametrize("dtype", DTYPES)
def test_tail_appends_equal_non_incremental_store(dtype):
    """After interleaved adds and deletes, the incremental store (appends in
    the tail, deletes by mask) answers as a store rebuilt on every sync, and
    as the reference; the main buffer is never rebuilt."""
    vecs, rng = _clustered(420)
    pair = Pair(dtype)
    full = GPUVectorStore(DIM, dtype=dtype, device="cpu", incremental=False)
    queries = vecs[rng.integers(0, 420, 4)]

    def add(prefix, lo, hi):
        pair.add(_texts(prefix, lo, hi), [prefix] * (hi - lo), vecs[lo:hi])
        full.add([Chunk(text=t, source=prefix) for t in _texts(prefix, lo, hi)], vecs[lo:hi])

    def compare():
        pair.check(queries)
        got = [[(h.chunk.text, h.score) for h in r] for r in full.search_batch(queries, 10)]
        assert got == [[(h.chunk.text, h.score) for h in r] for r in pair.port.search_batch(queries, 10)]

    add("a", 0, 300)
    compare()
    buf0 = pair.port._device_buf
    add("b", 300, 340)
    compare()
    pair.delete("a")
    full.delete_source("a")
    compare()
    add("c", 340, 420)
    compare()
    assert pair.port._device_buf is buf0 and pair.port._base == 300
    assert pair.port.capacity_stats()["tail_rows"] == 120


@pytest.mark.parametrize("dtype", DTYPES)
def test_tail_overflow_compacts(dtype, monkeypatch):
    from generativeaiexamples_tpu.retrieval import tpu as tpu_mod

    monkeypatch.setattr(tpu_mod, "_MIN_TAIL", 32)
    monkeypatch.setattr(gpu_mod, "_MIN_TAIL", 32)
    vecs, _ = _clustered(300)
    pair = Pair(dtype)
    pair.add(_texts("t", 0, 100), ["s"] * 100, vecs[:100])
    pair.check(vecs[:2])
    buf0 = pair.port._device_buf
    assert int(pair.port._tail_buf.shape[0]) == 128  # capacity 1024 // 8
    pair.add(_texts("t", 100, 300), ["s2"] * 200, vecs[100:300])
    pair.check(vecs[[150, 299]])
    assert pair.port.search(vecs[150], 1)[0].chunk.text == "t150"
    assert pair.port._device_buf is not buf0 and pair.port._base == 300


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_delete_uploads_only_masks(dtype):
    vecs, _ = _clustered(600)
    pair = Pair(dtype)
    pair.add(_texts("t", 0, 500), [f"s{i % 5}" for i in range(500)], vecs[:500])
    pair.check(vecs[:3])
    pair.add(_texts("n", 500, 600), ["new"] * 100, vecs[500:600])
    pair.check(vecs[[550]])
    port = pair.port
    held = (port._device_buf, port._tail_buf, port._device_valid, port._tail_valid)
    pair.delete("s0")
    pair.delete("new")
    pair.check(vecs[[0, 5, 550, 551]])
    assert port._device_buf is held[0] and port._tail_buf is held[1]  # no vector re-upload
    assert port._device_valid is not held[2] and port._tail_valid is not held[3]
    for hits in port.search_batch(vecs[[0, 5, 550]], 10):
        assert all(h.chunk.source not in ("s0", "new") for h in hits)
    assert port.delete_source("absent") == 0
    pair.add(_texts("r", 600, 610), ["s0"] * 10, vecs[:10])  # re-added rows are live again
    pair.check(vecs[[0, 1]])


def test_query_bucket_and_max_query_batch_chunks(monkeypatch):
    """Batches split into max_query_batch chunks, each padded to a power of
    two of at least 4 rows; the results are the reference's."""
    vecs, rng = _clustered(800)
    pair = Pair("float32", max_query_batch=8)
    pair.add(_texts("t", 0, 800), ["s"] * 800, vecs)
    shapes = []
    scan = GPUVectorStore.scan

    def spy(snap, Q):
        shapes.append(tuple(Q.shape))
        return scan(snap, Q)

    monkeypatch.setattr(GPUVectorStore, "scan", staticmethod(spy))
    queries = vecs[rng.integers(0, 800, 21)]
    pair.check(queries, 5)
    shapes.clear()
    pair.port.search_batch(queries, 5)
    pair.port.search_batch(queries[:3], 5)
    pair.port.search_batch(queries[:1], 5)
    pair.port.search(queries[0], 5)
    assert shapes == [(8, DIM), (8, DIM), (8, DIM), (4, DIM), (4, DIM), (1, DIM)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_equal_scores_rank_the_lower_row_first(dtype):
    """Equal vectors, in the main buffer and in the tail: the order and,
    where k cuts a group of equal scores, the selection are lax.top_k's."""
    vecs, _ = _clustered(1200)
    same = vecs[5]
    for i in (17, 40, 41, 300, 999):
        vecs[i] = same
    pair = Pair(dtype)
    pair.add(_texts("t", 0, 1000), ["s"] * 1000, vecs[:1000])
    for k in (2, 4, 10):
        pair.check(same[None, :], k)
    assert [h.chunk.text for h in pair.port.search(same, 4)] == ["t5", "t17", "t40", "t41"]
    vecs[1100] = same
    vecs[1050] = same
    pair.add(_texts("t", 1000, 1200), ["u"] * 200, vecs[1000:1200])
    for k in (7, 8):
        pair.check(same[None, :], k)
    assert [h.chunk.text for h in pair.port.search(same, 8)][-2:] == ["t1050", "t1100"]
    pair.delete("s")
    pair.check(same[None, :], 3)
    # A zero query ties every live row: the lowest rows come first.
    pair.check(np.zeros((1, DIM), np.float32), 5)


def test_bf16_buffer_has_the_reference_bits():
    """Round to nearest even, as jnp.asarray(f32, bfloat16): halfway values
    (low 16 bits 0x8000) with even and odd bf16 mantissas included."""
    vecs, _ = _clustered(1100)
    bits = vecs.view(np.uint32)
    bits[:40, :16] = (bits[:40, :16] & 0xFFFF0000) | 0x8000
    bits[40:80, 16:32] = (bits[40:80, 16:32] & 0xFFFE0000) | 0x18000
    pair = Pair("bfloat16")
    pair.add(_texts("t", 0, 1000), ["s"] * 1000, vecs[:1000])
    pair.check(vecs[:2])
    pair.add(_texts("t", 1000, 1100), ["s"] * 100, vecs[1000:1100])
    pair.check(vecs[[1050]])
    for ours, ref in ((pair.port._device_buf, pair.ref._device_buf), (pair.port._tail_buf, pair.ref._tail_buf)):
        assert ours.dtype == torch.bfloat16
        assert np.array_equal(ours.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_loads_across_packages(direction, tmp_path):
    vecs, rng = _clustered(700)
    pair = Pair("bfloat16")
    pair.add(_texts("t", 0, 600), [f"s{i % 3}" for i in range(600)], vecs[:600])
    pair.add(_texts("n", 600, 700), ["new"] * 100, vecs[600:700])
    pair.delete("s1")  # save compacts: deleted rows are not written
    saver = pair.ref if direction == "jax_to_port" else pair.port
    saver.save(str(tmp_path))
    version = saver.version()
    loaded = (GPUVectorStore.load(str(tmp_path), device="cpu") if direction == "jax_to_port"
              else TPUVectorStore.load(str(tmp_path)))
    assert len(loaded) == len(pair.ref) and loaded.version() == version
    queries = vecs[rng.integers(0, 700, 5)]
    for got, want in zip(loaded.search_batch(queries, 10), saver.search_batch(queries, 10)):
        assert [h.chunk.text for h in got] == [h.chunk.text for h in want]
        assert [h.chunk.id for h in got] == [h.chunk.id for h in want]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], atol=SCORE_TOL, rtol=0)


def test_search_snapshot_is_copy_on_write():
    """A search that snapshotted the device tensors before an append, a
    delete or a compaction scores exactly what the store held then: writes
    make new tensors and leave the snapshot's alone."""
    vecs, _ = _clustered(2600)
    store = GPUVectorStore(DIM, dtype="bfloat16", device="cpu")
    store.add([Chunk(text=f"t{i}", source="a") for i in range(900)], vecs[:900])
    store.add([Chunk(text=f"t{i}", source="b") for i in range(900, 1000)], vecs[900:1000])
    q = torch.from_numpy(vecs[[950, 3]])
    snap = store._prepared()
    before = [t.clone() for t in store.scan(snap, q)]
    store.add([Chunk(text=f"t{i}", source="c") for i in range(1000, 1100)], vecs[1000:1100])
    store.delete_source("b")
    store.search(vecs[0], 1)  # syncs: a tail append and a mask upload
    assert store._tail_buf is not snap[2] and store._device_valid is not snap[1]
    store.add([Chunk(text=f"t{i}", source="d") for i in range(1100, 2600)], vecs[1100:2600])
    store.search(vecs[0], 1)  # syncs: a full rebuild at capacity 4096
    assert int(store._device_buf.shape[0]) == 4096
    for a, b in zip(before, store.scan(snap, q)):
        assert torch.equal(a, b)
    assert [h.chunk.text for h in store.search(vecs[950], 1)] != ["t950"]  # b deleted since


def test_concurrent_ingest_while_search():
    """Ingest on one thread while another searches: no torn sync state, every
    search answers, and the end state is the reference's."""
    vecs, _ = _clustered(600)
    store = GPUVectorStore(DIM, dtype="float32", device="cpu")
    ref = TPUVectorStore(DIM, dtype="float32")
    for s, C in ((store, Chunk), (ref, JChunk)):
        s.add([C(text=f"seed{i}", source="seed") for i in range(100)], vecs[:100])
    assert store.search(vecs[0], 1)
    errors: list = []

    def writer():
        try:
            for lo in range(100, 600, 50):
                store.add([Chunk(text=f"w{i}", source=f"src{lo}") for i in range(lo, lo + 50)], vecs[lo : lo + 50])
                if lo == 300:
                    store.delete_source("src100")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=writer)
    t.start()
    try:
        while t.is_alive():
            hits = store.search(vecs[0], 5)
            assert hits and hits[0].chunk.text == "seed0"
    finally:
        t.join(10)
    assert not t.is_alive() and not errors
    for lo in range(100, 600, 50):
        ref.add([JChunk(text=f"w{i}", source=f"src{lo}") for i in range(lo, lo + 50)], vecs[lo : lo + 50])
    ref.delete_source("src100")
    assert store.search(vecs[550], 1)[0].chunk.text == "w550"
    assert len(store) == len(ref) == 550
    got, want = store.search_batch(vecs[[0, 120, 550]], 10), ref.search_batch(vecs[[0, 120, 550]], 10)
    assert [[h.chunk.text for h in r] for r in got] == [[h.chunk.text for h in r] for r in want]


def test_add_validates_eagerly():
    store = GPUVectorStore(DIM, device="cpu")
    with pytest.raises(ValueError, match="chunks but"):
        store.add([Chunk(text="x", source="s")], [])
    with pytest.raises(ValueError, match="shape"):
        store.add([Chunk(text="x", source="s")], [[0.0] * (DIM + 1)])
    with pytest.raises(ValueError, match="ragged|shape"):
        store.add([Chunk(text="x", source="s"), Chunk(text="y", source="s")], [[0.0] * DIM, [0.0] * 3])
    assert store.add([], []) == [] and len(store) == 0


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 10"):
        GPUVectorStore(DIM, device="cpu", mesh=object())


def test_unported_snapshots_raise(tmp_path):
    """The JAX IVF and int8 snapshots that raised before the compressed and
    IVF stores were ported now load (an IVF one as ``GPUIVFVectorStore``,
    through ``GPUVectorStore.load``) and search like the reference's own
    load of them."""
    vecs, _ = _clustered(50)
    for name, ref in (("ivf", TPUIVFVectorStore(DIM)), ("int8", TPUVectorStore(DIM, quantization="int8"))):
        ref.add([JChunk(text=f"t{i}", source="s") for i in range(50)], vecs)
        ref.save(str(tmp_path / name))
        port = GPUVectorStore.load(str(tmp_path / name), device="cpu")
        assert type(port).__name__ == {"ivf": "GPUIVFVectorStore", "int8": "GPUVectorStore"}[name]
        assert port.quantization == ("int8" if name == "int8" else "none")
        want = type(ref).load(str(tmp_path / name)).search_batch(vecs[:3], 5)
        got = port.search_batch(vecs[:3], 5)
        assert [[h.chunk.id for h in r] for r in got] == [[h.chunk.id for h in r] for r in want]
        np.testing.assert_allclose([h.score for r in got for h in r], [h.score for r in want for h in r],
                                   atol=SCORE_TOL, rtol=0)
    with pytest.raises(ValueError):
        GPUVectorStore(DIM, device="cpu", quantization="fp4")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GPUVectorStore(DIM)


@pytest.mark.parametrize("dtype", DTYPES)
def test_search_fallback_matches_the_device_search_and_reference(dtype):
    """The host-mirror fallback (the ``index_fallback`` rung) answers as the
    device search does: it scores the store's dtype, honours the masks and
    ranks ties by lower row.  In float32 it is also the reference's
    ``search_fallback``; in bfloat16 the reference scores its f32 mirror,
    the port the bf16 values its device search scores."""
    vecs, rng = _clustered(1500)
    pair = Pair(dtype)
    pair.add(_texts("t", 0, 1200), [f"s{i % 7}" for i in range(1200)], vecs[:1200])
    pair.port.search(vecs[0], 1)  # device build: the next rows ride the tail
    pair.ref.search(vecs[0], 1)
    pair.add(_texts("t", 1200, 1500), ["tail"] * 300, vecs[1200:])
    pair.delete("s3")
    queries = np.concatenate([vecs[rng.integers(0, 1500, 6)], _clustered(6, seed=1)[0]])
    for k in (1, 4, 10):
        got = pair.port.search_fallback(queries, k)
        device = pair.port.search_batch(queries, k)
        assert [[h.chunk.text for h in r] for r in got] == [[h.chunk.text for h in r] for r in device]
        np.testing.assert_allclose([h.score for r in got for h in r], [h.score for r in device for h in r],
                                   atol=SCORE_TOL, rtol=0)
        assert all(h.chunk.source != "s3" for r in got for h in r)
        if dtype == "float32":
            want = pair.ref.search_fallback(queries, k)
            assert [[h.chunk.text for h in r] for r in got] == [[h.chunk.text for h in r] for r in want]
            np.testing.assert_allclose([h.score for r in got for h in r], [h.score for r in want for h in r],
                                       atol=SCORE_TOL, rtol=0)
    assert pair.port.search_fallback([], 4) == [] and pair.port.search_fallback(queries[:2], 0) == [[], []]
    # Planted ties: equal rows rank the lower row first, as the device does.
    tie = GPUVectorStore(DIM, dtype=dtype, device="cpu")
    tie.add([Chunk(text=f"d{i}", source="s") for i in range(6)], np.repeat(vecs[:2], 3, axis=0))
    assert [h.chunk.text for h in tie.search_fallback(vecs[:1], 3)[0]] == ["d0", "d1", "d2"]
    assert [h.chunk.text for h in tie.search_batch(vecs[:1], 3)[0]] == ["d0", "d1", "d2"]
