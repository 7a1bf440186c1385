"""The port's durability layer (``durability/``) against the JAX package's
on the CPU.

The same mutations go through both packages: the WAL frames must be byte
for byte equal and each package must replay the other's log; torn and
corrupt tails are quarantined alike; snapshots, manifests and pruning
leave the same directories; the port's ``DurableVectorStore`` over
``GPUVectorStore(device="cpu")`` recovers what the JAX one over
``TPUVectorStore`` recovers (search results equal, scores within
``SCORE_TOL``), also from a directory the other package wrote; the ingest
journal's ``unfinished_jobs`` and ``compact`` agree; a journaled job
resumes with every file exactly once; ``hydrate_store`` and the
``rag_wal_*`` / ``rag_recovery_*`` lines agree.
"""

import json
import os
import time

import numpy as np
import pytest

from generativeaiexamples_tpu.durability import journal as jjournal
from generativeaiexamples_tpu.durability import metrics as jmetrics
from generativeaiexamples_tpu.durability import store as jstore
from generativeaiexamples_tpu.durability import wal as jwal
from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JHashEmbedder
from generativeaiexamples_tpu.ingest.pipeline import IngestPipeline as JIngestPipeline
from generativeaiexamples_tpu.retrieval.base import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.memory import MemoryVectorStore as JMemoryVectorStore
from generativeaiexamples_tpu.retrieval.tpu import TPUVectorStore
from generativeaiexamples_tpu_torch.durability import journal as tjournal
from generativeaiexamples_tpu_torch.durability import metrics as tmetrics
from generativeaiexamples_tpu_torch.durability import store as tstore
from generativeaiexamples_tpu_torch.durability import wal as twal
from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder
from generativeaiexamples_tpu_torch.ingest.pipeline import IngestPipeline
from generativeaiexamples_tpu_torch.obs.recorder import get_flight_recorder
from generativeaiexamples_tpu_torch.retrieval.base import Chunk
from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore
from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore
from generativeaiexamples_tpu_torch.server import schema

DIM = 64
# Scores of the same vectors in the two stores: f32 sums of bf16 products
# in another order.
SCORE_TOL = 1e-5

# Each package's modules, driven alike.
JAX = dict(wal=jwal, store=jstore, journal=jjournal, metrics=jmetrics, Chunk=JChunk, Memory=JMemoryVectorStore,
           Pipeline=JIngestPipeline, Hash=JHashEmbedder, Exact=lambda: TPUVectorStore(DIM))
PORT = dict(wal=twal, store=tstore, journal=tjournal, metrics=tmetrics, Chunk=Chunk, Memory=MemoryVectorStore,
            Pipeline=IngestPipeline, Hash=HashEmbedder, Exact=lambda: GPUVectorStore(DIM, device="cpu"))
SIDES = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True)
def _fresh_metrics():
    jmetrics.reset_durability_metrics()
    tmetrics.reset_durability_metrics()
    yield
    jmetrics.reset_durability_metrics()
    tmetrics.reset_durability_metrics()


def _vecs(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _chunks(side, n, src, tag):
    # Fixed ids: the WAL carries them, and two packages' uuids would differ.
    return [side["Chunk"](text=f"{tag}{i} ünï", source=src, metadata={"i": i}, id=f"{src}-{tag}-{i}")
            for i in range(n)]


# The mutation script both packages run: (op, args).
SCRIPT = [("add", ("a", "x", 5, 0)), ("add", ("b", "y", 3, 1)), ("delete", "a"), ("add", ("c", "z", 4, 2)),
          ("add", ("a", "w", 2, 3)), ("delete", "ghost"), ("add", ("d", "v", 6, 4))]


def _run_script(side, store, script=SCRIPT):
    for op, args in script:
        if op == "add":
            src, tag, n, seed = args
            store.add(_chunks(side, n, src, tag), _vecs(n, seed))
        else:
            store.delete_source(args)


def _write_wal(side, path):
    wal = side["wal"].WriteAheadLog(path, fsync_every=0)
    for op, args in SCRIPT:
        if op == "add":
            src, tag, n, seed = args
            chunks = _chunks(side, n, src, tag)
            wal.append({"op": "add", "ids": [c.id for c in chunks], "texts": [c.text for c in chunks],
                        "sources": [c.source for c in chunks], "metas": [c.metadata for c in chunks]},
                       _vecs(n, seed))
        else:
            wal.append({"op": "delete", "source": args})
    wal.append({"op": "index_swap", "rows": 9})
    wal.close()


def _records(records):
    return [(r.seq, r.header, None if r.vectors is None else r.vectors.tobytes(), r.offset) for r in records]


def test_wal_frames_are_byte_equal_to_the_reference(tmp_path):
    _write_wal(JAX, str(tmp_path / "jax.log"))
    _write_wal(PORT, str(tmp_path / "port.log"))
    jbytes, tbytes = (tmp_path / "jax.log").read_bytes(), (tmp_path / "port.log").read_bytes()
    assert tbytes.startswith(b"GWAL0001") and tbytes == jbytes
    assert tmetrics.durability_snapshot() == jmetrics.durability_snapshot()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_replays_the_others_log(tmp_path, writer, reader):
    path = str(tmp_path / "wal.log")
    _write_wal(SIDES[writer], path)
    got, ginfo = SIDES[reader]["wal"].replay(path)
    want, winfo = SIDES[writer]["wal"].replay(path)
    assert _records(got) == _records(want) and ginfo == winfo
    assert [r.header["op"] for r in got] == ["add", "add", "delete", "add", "add", "delete", "add", "index_swap"]


def _torn(path):
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 7)


def _flip(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x40
    open(path, "wb").write(bytes(data))


def _bad_magic(path):
    data = bytearray(open(path, "rb").read())
    data[:8] = b"NOTAWAL!"
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("damage", [_torn, _flip, _bad_magic], ids=["torn_tail", "checksum", "bad_magic"])
def test_damaged_tails_are_quarantined_like_the_reference(tmp_path, damage):
    out = {}
    for name, side in SIDES.items():
        d = tmp_path / name
        d.mkdir()
        path = str(d / "wal.log")
        _write_wal(side, path)
        damage(path)
        records, info = side["wal"].replay(path, repair=True)
        quarantined = info.pop("quarantined")
        out[name] = (_records(records), info, open(path, "rb").read(),
                     os.path.basename(quarantined), open(quarantined, "rb").read() if quarantined else b"")
    assert out["port"] == out["jax"]
    assert out["port"][1]["torn"] is True


def _durable(side, directory, inner=None, **kw):
    kw.setdefault("fsync_every", 0)
    kw.setdefault("snapshot_every_records", 0)
    return side["store"].DurableVectorStore(inner if inner is not None else side["Memory"](DIM), str(directory), **kw)


def _manifest(directory):
    m = json.load(open(os.path.join(directory, "MANIFEST.json")))
    m.pop("saved_at")
    return m


def _snapshot_content(path):
    vecs = np.load(os.path.join(path, "vectors.npz"))
    return (json.load(open(os.path.join(path, "chunks.json"))), {k: vecs[k].tobytes() for k in vecs.files})


def test_snapshots_manifest_and_pruning_match_the_reference(tmp_path):
    out = {}
    for name, side in SIDES.items():
        d = tmp_path / name
        store = _durable(side, d, snapshot_every_records=2, keep_snapshots=2)
        _run_script(side, store)
        store.snapshot()
        listing = sorted(os.listdir(d))
        snaps = [n for n in listing if n.startswith("snap-")]
        out[name] = (listing, _manifest(d), open(d / "wal.log", "rb").read(),
                     [_snapshot_content(str(d / n)) for n in snaps], tmetrics.durability_snapshot()["snapshots"]
                     if side is PORT else jmetrics.durability_snapshot()["snapshots"])
        store.close()
    assert out["port"] == out["jax"]
    listing, manifest, wal_bytes = out["port"][:3]
    assert manifest["wal_seq"] == len(SCRIPT) and wal_bytes == b"GWAL0001"
    assert [n for n in listing if n.startswith("snap-")] == ["snap-0000000006", "snap-0000000007"]


def _hits(results):
    return [[(h.chunk.id, h.chunk.text, h.chunk.source) for h in r] for r in results], \
        [h.score for r in results for h in r]


def _same_search(port_store, jax_store, queries, k=6):
    (pt, ps), (jt, js) = _hits(port_store.search_batch(queries, k)), _hits(jax_store.search_batch(queries, k))
    assert pt == jt and pt and all(pt)
    np.testing.assert_allclose(ps, js, atol=SCORE_TOL, rtol=0)


_STAT_KEYS = ("snapshot_restored", "snapshot", "base_seq", "replayed_records", "skipped_records", "torn_tail",
              "last_seq")


@pytest.mark.parametrize("snapshot_at", [None, 4], ids=["wal_only", "snapshot_plus_tail"])
def test_gpu_store_recovery_matches_the_reference(tmp_path, snapshot_at):
    """A crash (no close, no final snapshot) after the script, with or
    without a snapshot part way, recovers the same corpus in both."""
    stores = {}
    for name, side in SIDES.items():
        store = _durable(side, tmp_path / name, inner=side["Exact"]())
        for i, step in enumerate(SCRIPT):
            _run_script(side, store, [step])
            if i == snapshot_at:
                store.snapshot()
        store.flush()
        stores[name] = store  # left open: the process "died"
    queries = _vecs(5, seed=7)
    before = stores["port"].search_batch(queries, 6)
    _same_search(stores["port"], stores["jax"], queries)
    jax_version = stores["jax"].version()
    recovered = {name: _durable(side, tmp_path / name, inner=side["Exact"]()) for name, side in SIDES.items()}
    port, ref = recovered["port"], recovered["jax"]
    assert {k: port.last_recovery[k] for k in _STAT_KEYS} == {k: ref.last_recovery[k] for k in _STAT_KEYS}
    assert port.last_recovery["rows"] == len(port) == len(ref) and port.last_recovery["version"] == port.version()
    assert port.last_recovery["device"] == "cpu"
    assert isinstance(port.inner, GPUVectorStore) and port.inner.device.type == "cpu"
    assert sorted(port.sources()) == sorted(ref.sources()) and port.version() == ref.version() == jax_version
    _same_search(port, ref, queries)
    # Bit for bit against the port's own store before the crash.
    after = port.search_batch(queries, 6)
    assert [[(h.chunk.id, h.score) for h in r] for r in after] == [[(h.chunk.id, h.score) for h in r] for r in before]
    for store in list(stores.values()) + list(recovered.values()):
        store.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_recovery_from_the_other_packages_directory(tmp_path, writer, reader):
    """Snapshot + WAL tail written by one package, recovered by the other."""
    w, r = SIDES[writer], SIDES[reader]
    store = _durable(w, tmp_path, inner=w["Exact"]())
    _run_script(w, store, SCRIPT[:4])
    store.snapshot()
    _run_script(w, store, SCRIPT[4:])
    store.close()
    queries = _vecs(4, seed=9)
    control = _durable(w, tmp_path, inner=w["Exact"]())
    other = _durable(r, tmp_path, inner=r["Exact"]())
    assert other.last_recovery["snapshot_restored"] and other.last_recovery["replayed_records"] == 3
    port, ref = (other, control) if reader == "port" else (control, other)
    _same_search(port, ref, queries)
    assert len(other) == len(control) and other.version() == control.version()
    other.close()
    control.close()


def _journal_events(side, path):
    j = side["journal"].IngestJournal(path)
    files = [("/stage/a", "a.txt"), ("/stage/b", "b.txt"), ("/stage/c", "c.txt")]
    j.job_submitted("j1", files)
    j.file_done("j1", "a.txt", 3)
    j.job_submitted("j2", files[:2])
    j.file_done("j2", "a.txt", 1)
    j.file_failed("j2", "b.txt", "ValueError: " + "x" * 600)
    j.job_finished("j2", "partial")
    j.job_submitted("j3", files[1:])
    j.file_failed("j3", "b.txt", "boom")
    j.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"ev": "file_done", "job": "j3", "na')  # a torn last line
    return side["journal"].IngestJournal(path)


def test_journal_unfinished_jobs_and_compact_match_the_reference(tmp_path):
    out = {}
    for name, side in SIDES.items():
        path = str(tmp_path / f"{name}.log")
        j = _journal_events(side, path)
        before = j.unfinished_jobs()
        j.compact(drop_jobs={"j3"})
        out[name] = (before, open(path, "rb").read(), j.unfinished_jobs())
        j.close()
    assert out["port"] == out["jax"]
    before, compacted, after = out["port"]
    assert [i["job_id"] for i in before] == ["j1", "j3"] and [i["job_id"] for i in after] == ["j1"]
    assert before[0]["pending"] == [("/stage/b", "b.txt"), ("/stage/c", "c.txt")]


def _resume(side, tmp_path):
    """A journaled job interrupted after two durable files, with a third
    half-applied in the WAL, resumed by a new pipeline."""
    embedder = side["Hash"](dimensions=DIM)
    staging = tmp_path / "staging"
    staging.mkdir()
    files = []
    for i in range(5):
        p = staging / f"f{i}.txt"
        p.write_text("\n".join(f"file {i} line {j}" for j in range(3)))
        files.append((str(p), f"f{i}.txt"))

    def parse(path, name):
        with open(path) as fh:
            return [side["Chunk"](text=line.strip(), source=name) for line in fh if line.strip()]

    store = _durable(side, tmp_path / "store")
    journal = side["journal"].IngestJournal(str(tmp_path / "journal.log"))
    jid = "crashjob00001"
    journal.job_submitted(jid, files)
    for path, name in files[:2]:
        chunks = parse(path, name)
        store.add(chunks, embedder.embed_documents([c.text for c in chunks]))
        store.flush()
        journal.file_done(jid, name, len(chunks))
    partial = parse(*files[2])[:1]
    store.add(partial, embedder.embed_documents([c.text for c in partial]))
    store.close()
    journal.close()

    store = _durable(side, tmp_path / "store")
    rows_recovered = len(store)
    journal = side["journal"].IngestJournal(str(tmp_path / "journal.log"))
    pipe = side["Pipeline"](parse_fn=parse, embed_fn=embedder.embed_documents, append_fn=store.add,
                            parse_workers=2, journal=journal, delete_source_fn=store.delete_source,
                            durable_flush_fn=store.flush)
    resumed = pipe.resume()
    deadline = time.monotonic() + 30
    while pipe.status(jid)["status"] == "running" and time.monotonic() < deadline:
        time.sleep(0.02)
    status = pipe.status(jid)
    status.pop("docs_per_sec")
    texts = sorted(c.text for c in store.inner._chunks)
    ids = [c.id for c in store.inner._chunks]
    pipe.close()
    journal.close()
    store.close()
    return resumed, rows_recovered, status, texts, len(ids) == len(set(ids)), side["metrics"].durability_snapshot()


def test_journaled_resume_is_idempotent_like_the_reference(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    got, want = _resume(PORT, tmp_path / "port"), _resume(JAX, tmp_path / "jax")
    for snap in (got[5], want[5]):
        snap.pop("recovery_last_ms")
    assert got == want
    resumed, rows, status, texts, unique, metrics = got
    assert resumed == ["crashjob00001"] and rows == 7 and status["status"] == "done" and status["files_done"] == 5
    assert texts == sorted(f"file {i} line {j}" for i in range(5) for j in range(3)) and unique
    assert metrics["recovery_resumed_jobs"] == 1


def test_hydrate_store_matches_the_reference(tmp_path):
    out = {}
    for name, side in SIDES.items():
        d = tmp_path / name
        store = _durable(side, d)
        _run_script(side, store, SCRIPT[:3])
        store.snapshot()
        _run_script(side, store, SCRIPT[3:])
        store.close()
        hydrated, stats = side["store"].hydrate_store(str(d), side["Memory"](DIM))
        stats.pop("duration_ms")
        stats.pop("rows", None)
        stats.pop("version", None)
        stats.pop("device", None)
        out[name] = (stats, len(hydrated), sorted(hydrated.sources()), hydrated.version(),
                     side["metrics"].durability_snapshot()["replica_bootstraps"])
    assert out["port"] == out["jax"]
    assert out["port"][0]["snapshot_restored"] and out["port"][-1] == 1
    # hydrate_store takes no WAL ownership: the log is as the store left it.
    assert twal.replay(str(tmp_path / "port" / "wal.log"))[0]


def _lines(text):
    """The rag_wal_* / rag_recovery_* lines with their duration gauges
    masked (wall times differ between the two runs)."""
    return [line.rsplit(" ", 1)[0] if "duration_ms " in line else line for line in text]


def test_durability_metrics_lines_match_the_reference(tmp_path):
    assert tmetrics.durability_metrics_lines() == jmetrics.durability_metrics_lines()  # from zero
    for name, side in SIDES.items():
        store = _durable(side, tmp_path / name, inner=side["Memory"](DIM), fsync_every=1)
        _run_script(side, store)
        store.snapshot()
        _run_script(side, store, SCRIPT[:2])
        store.close()
        _durable(side, tmp_path / name).close()
    assert _lines(tmetrics.durability_metrics_lines()) == _lines(jmetrics.durability_metrics_lines())
    assert "rag_recovery_total 1" in tmetrics.durability_metrics_lines()


def test_recovery_event_is_pinned_in_the_flight_recorder(tmp_path):
    store = _durable(PORT, tmp_path)
    _run_script(PORT, store)
    store.close()
    with open(tmp_path / "wal.log", "ab") as fh:
        fh.write(b"\x05\x00")  # a torn frame header
    recovered = _durable(PORT, tmp_path)
    events = [r for r in get_flight_recorder().snapshot(None) if r.get("route") == "startup.recovery"]
    assert events and events[0]["pinned"]
    assert events[0]["degraded"] == ["durability:startup_recovery", "durability:torn_tail_quarantined"]
    assert events[0]["attrs"]["recovery"]["replayed_records"] == len(SCRIPT)
    schema.RequestTraceRecord(**events[0])  # stays valid for GET /debug/requests
    recovered.close()
