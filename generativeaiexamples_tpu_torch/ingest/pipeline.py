"""Staged bulk-ingestion pipeline: parse pool → embed dispatcher → appends
(port of the JAX package's ``ingest/pipeline.py``).

The serial ``POST /documents`` path ingests one document per upload:
load, split, one padded embed forward, one store append, so a corpus
upload is serial end to end and the card idles between per-doc forwards.

This module is the bulk path.  Three stages, each owning the resource it
saturates:

  1. **Parse/split pool** — a CPU thread pool runs ``load_document`` +
     splitter per file (pure host work).
  2. **Embed dispatcher** — a SINGLE thread owns the card: it drains
     parsed docs from a bounded queue, coalesces their chunks into
     device-sized batches (``embed_batch_chunks``), and feeds the
     embedder's bucketed forwards back to back.  One owner means full
     batches instead of one forward per doc.
  3. **Chunked store appends** — embedded chunks append to the vector
     store in bounded slices; the store's incremental sync
     (``retrieval/gpu.py``'s tail buffer) makes each append O(new rows),
     so ingestion never triggers a full-corpus device rebuild.

Jobs are asynchronous: ``submit()`` returns a job id immediately,
``status()`` reports progress (the ``GET /documents/status`` payload),
and process-wide counters feed the ``ingest_*`` series on ``/metrics``.
Per-file errors are isolated — a poisoned document fails alone, its
batch-mates land.  A failure of the card itself (a CUDA error, out of
device memory) is not a file's fault: it fails every file of the batch
(met during a per-file retry, the file it hit and the rest), takes back
the batch's slices that were already appended, and marks the job
``failed`` whatever else lands, instead of being isolated to one file
(the reference has no such distinction).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import torch

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.retrieval.base import Chunk

logger = get_logger(__name__)

_STOP = object()

_DEVICE_ERRORS = tuple(
    t for t in (getattr(torch, "AcceleratorError", None), torch.cuda.OutOfMemoryError) if t is not None
)


def _is_device_error(exc: BaseException) -> bool:
    """A failure of the card (a CUDA error or out of device memory), which
    no retry of one file can isolate."""
    return isinstance(exc, _DEVICE_ERRORS) or (isinstance(exc, RuntimeError) and "CUDA error" in str(exc))


@dataclasses.dataclass
class IngestJob:
    """Progress record for one bulk submission."""

    id: str
    files_total: int
    status: str = "queued"  # queued | running | done | partial | failed
    files_done: int = 0
    files_failed: int = 0
    chunks_total: int = 0  # split so far
    chunks_ingested: int = 0  # embedded + appended
    errors: list = dataclasses.field(default_factory=list)
    started_at: float = 0.0
    finished_at: float = 0.0
    _pending: int = 0  # files not yet fully processed
    _device_failed: bool = False  # a device error hit one of its batches

    def snapshot(self) -> dict:
        elapsed = (
            (self.finished_at or time.monotonic()) - self.started_at
            if self.started_at
            else 0.0
        )
        return {
            "job_id": self.id,
            "status": self.status,
            "files_total": self.files_total,
            "files_done": self.files_done,
            "files_failed": self.files_failed,
            "chunks_total": self.chunks_total,
            "chunks_ingested": self.chunks_ingested,
            "docs_per_sec": round(self.files_done / elapsed, 2)
            if elapsed > 0
            else 0.0,
            "errors": list(self.errors[:8]),
        }


class IngestStats:
    """Process-wide counters behind the ``ingest_*`` Prometheus series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.jobs_total = 0
        self.docs_total = 0
        self.doc_failures_total = 0
        self.chunks_total = 0
        self.embed_batches_total = 0
        self.append_batches_total = 0
        self.last_job_docs_per_sec = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "jobs_total": self.jobs_total,
                "docs_total": self.docs_total,
                "doc_failures_total": self.doc_failures_total,
                "chunks_total": self.chunks_total,
                "embed_batches_total": self.embed_batches_total,
                "append_batches_total": self.append_batches_total,
                "last_job_docs_per_sec": self.last_job_docs_per_sec,
            }


def ingest_metrics_lines(
    snap: Optional[dict], active_jobs: int = 0
) -> list[str]:
    """Prometheus lines for the bulk-ingestion pipeline.

    ``snap`` is an ``IngestStats.snapshot()`` (or ``None`` before any
    pipeline exists — the series still export, at zero, so dashboards
    need no existence checks).  ``ingest_docs_total`` growing while
    ``ingest_embed_batches_total`` grows slower is the staging win:
    documents per device dispatch.
    """
    s = snap or {}
    return [
        "# TYPE ingest_jobs_total counter",
        f"ingest_jobs_total {s.get('jobs_total', 0)}",
        "# TYPE ingest_jobs_active gauge",
        f"ingest_jobs_active {active_jobs}",
        "# TYPE ingest_docs_total counter",
        f"ingest_docs_total {s.get('docs_total', 0)}",
        "# TYPE ingest_doc_failures_total counter",
        f"ingest_doc_failures_total {s.get('doc_failures_total', 0)}",
        "# TYPE ingest_chunks_total counter",
        f"ingest_chunks_total {s.get('chunks_total', 0)}",
        "# TYPE ingest_embed_batches_total counter",
        f"ingest_embed_batches_total {s.get('embed_batches_total', 0)}",
        "# TYPE ingest_append_batches_total counter",
        f"ingest_append_batches_total {s.get('append_batches_total', 0)}",
        "# TYPE ingest_last_job_docs_per_sec gauge",
        f"ingest_last_job_docs_per_sec {s.get('last_job_docs_per_sec', 0.0)}",
    ]


class IngestPipeline:
    """Parse-pool → single embed dispatcher → chunked store appends.

    Stage functions are injected so the pipeline serves any pipeline
    example (and hermetic tests):

      * ``parse_fn(path, filename) -> list[Chunk]`` — load + split.
      * ``embed_fn(texts) -> list[list[float]]`` — batch embeddings.
      * ``append_fn(chunks, embeddings)`` — store append.

    A job whose files carry ``ingest_fn`` (direct mode, used for
    pipeline plugins with bespoke ingest logic) skips the embed stage:
    the parse pool calls it per file and only completion is tracked.
    """

    def __init__(
        self,
        *,
        parse_fn: Callable[[str, str], Sequence[Chunk]],
        embed_fn: Callable[[Sequence[str]], Sequence[Sequence[float]]],
        append_fn: Callable[[Sequence[Chunk], Sequence[Sequence[float]]], object],
        parse_workers: int = 4,
        embed_batch_chunks: int = 128,
        append_batch_chunks: int = 1024,
        queue_depth: int = 16,
        delete_files: bool = False,
        journal=None,
        delete_source_fn: Optional[Callable[[str], int]] = None,
        durable_flush_fn: Optional[Callable[[], None]] = None,
        admit_fn: Optional[
            Callable[[Sequence[Chunk], Sequence[Sequence[float]]], None]
        ] = None,
    ) -> None:
        self._parse_fn = parse_fn
        self._embed_fn = embed_fn
        self._append_fn = append_fn
        # Admission gate (collection quotas): called before every store
        # append; a refusal raises and fails only the offending file(s),
        # never the batch-mates (the per-file retry path isolates it).
        self._admit_fn = admit_fn
        self._embed_batch = max(1, int(embed_batch_chunks))
        self._append_batch = max(1, int(append_batch_chunks))
        self._delete_files = bool(delete_files)
        # Durability hooks (all optional; see ``durability/``):
        #   * journal — IngestJournal recording job/file progress so an
        #     interrupted job survives a process crash;
        #   * delete_source_fn — used by ``resume()`` to drop a possibly
        #     half-applied file before re-ingesting it (idempotence), and
        #     to take back the landed slices of an append the card failed;
        #   * durable_flush_fn — WAL fsync barrier invoked BEFORE a file
        #     is journaled done, so "done" always implies "chunks are on
        #     disk" whatever the WAL's group-commit cadence.
        self._journal = journal
        self._delete_source_fn = delete_source_fn
        self._durable_flush_fn = durable_flush_fn
        self._journaled_ids: set[str] = set()
        self.stats = IngestStats()
        self._jobs: dict[str, IngestJob] = {}
        self._jobs_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(parse_workers)),
            thread_name_prefix="ingest-parse",
        )
        # Bounded: backpressure parsing when the device stage lags, so a
        # giant job cannot hold every parsed chunk in memory at once.
        self._queue: queue.Queue = queue.Queue(maxsize=max(2, queue_depth))
        self._closed = False
        self._dispatcher = threading.Thread(
            target=self._embed_loop, name="ingest-embed", daemon=True
        )
        self._dispatcher.start()

    @property
    def journal(self):
        """The attached IngestJournal, or None when durability is off."""
        return self._journal

    # -- submission --------------------------------------------------------

    def submit(
        self,
        files: Sequence[tuple[str, str]],
        *,
        ingest_fn: Optional[Callable[[str, str], None]] = None,
    ) -> str:
        """Queue ``(path, logical_filename)`` pairs; returns the job id.

        ``ingest_fn`` switches the job to direct mode (per-file custom
        ingest on the parse pool, no staged embed).
        """
        if self._closed:
            raise RuntimeError("ingest pipeline is closed")
        job = IngestJob(
            id=uuid.uuid4().hex[:12],
            files_total=len(files),
            _pending=len(files),
            started_at=time.monotonic(),
            status="running" if files else "done",
        )
        with self._jobs_lock:
            self._jobs[job.id] = job
            self.stats.jobs_total += 1
        if not files:
            job.finished_at = job.started_at
            return job.id
        # Journal before any work starts (direct-mode jobs are excluded:
        # their ingest_fn closure cannot be reconstructed on restart).
        if self._journal is not None and ingest_fn is None:
            try:
                self._journal.job_submitted(job.id, list(files))
                self._journaled_ids.add(job.id)
            except Exception:  # noqa: BLE001 — journal loss != job loss
                logger.exception("ingest journal write failed")
        for path, name in files:
            self._pool.submit(self._parse_one, job, path, name, ingest_fn)
        return job.id

    def resume(self) -> list[str]:
        """Re-queue journaled jobs interrupted by a crash/restart.

        Each unfinished job resumes from the last durably-applied file:
        already-done files keep their counts (so ``/documents/status``
        shows cumulative progress under the SAME job id), and each still
        -pending file is deleted from the store first and re-ingested —
        idempotent, so a crash between the WAL append and the journal
        mark can produce neither duplicates nor losses.  Staged files
        lost with the machine are recorded as per-file failures rather
        than wedging the job.  Returns the resumed job ids.
        """
        if self._journal is None:
            return []
        resumed: list[str] = []
        for info in self._journal.unfinished_jobs():
            pending = [
                (p, n) for p, n in info["pending"] if os.path.exists(p)
            ]
            missing = [
                n for p, n in info["pending"] if not os.path.exists(p)
            ]
            job = IngestJob(
                id=info["job_id"],
                files_total=len(info["files"]),
                files_done=len(info["done"]),
                files_failed=len(info["failed"]) + len(missing),
                chunks_total=sum(info["done"].values()),
                chunks_ingested=sum(info["done"].values()),
                _pending=max(len(pending), 1),
                started_at=time.monotonic(),
                status="running",
            )
            for name in missing:
                job.errors.append(f"{name}: staged file lost in restart")
            for name, error in info["failed"].items():
                job.errors.append(f"{name}: {error}"[:300])
            with self._jobs_lock:
                self._jobs[job.id] = job
                self.stats.jobs_total += 1
            self._journaled_ids.add(job.id)
            # Drop possibly half-applied chunks BEFORE re-ingesting: the
            # WAL may already hold a prefix of an unmarked file.
            for _, name in pending:
                if self._delete_source_fn is not None:
                    try:
                        self._delete_source_fn(name)
                    except Exception:  # noqa: BLE001
                        logger.exception(
                            "resume: delete_source(%r) failed", name
                        )
            if not pending:
                with self._jobs_lock:
                    self._maybe_finish(job)
            else:
                for path, name in pending:
                    self._pool.submit(self._parse_one, job, path, name, None)
            try:
                from generativeaiexamples_tpu_torch.durability import metrics

                metrics.record_resumed_job()
            except Exception:  # pragma: no cover - metrics must not block
                pass
            resumed.append(job.id)
            logger.info(
                "resumed ingest job %s: %d files pending, %d done, "
                "%d lost", job.id, len(pending), len(info["done"]),
                len(missing),
            )
        return resumed

    def _parse_one(
        self,
        job: IngestJob,
        path: str,
        name: str,
        ingest_fn: Optional[Callable[[str, str], None]],
    ) -> None:
        # Journaled jobs defer staged-file deletion until the file is
        # durably marked done: the file IS the resume payload.
        journaled = job.id in self._journaled_ids
        try:
            if ingest_fn is not None:
                ingest_fn(path, name)
                self._cleanup(path)
                self._file_done(job, name, chunks_ingested=0)
                return
            chunks = list(self._parse_fn(path, name))
            if not journaled:
                self._cleanup(path)
            with self._jobs_lock:
                job.chunks_total += len(chunks)
                self.stats.chunks_total += len(chunks)
            if not chunks:
                logger.warning("%s produced no chunks", name)
                self._file_done(
                    job, name, chunks_ingested=0,
                    path=path if journaled else None,
                )
                return
            # Blocks when the embed stage lags: backpressure, not OOM.
            self._queue.put((job, name, chunks, path if journaled else None))
        except Exception as exc:  # noqa: BLE001 — per-file isolation
            logger.exception("parse failed for %s", name)
            self._cleanup(path)
            if _is_device_error(exc):
                job._device_failed = True
            self._file_failed(job, name, exc)

    def _cleanup(self, path: str) -> None:
        if self._delete_files:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- dispatcher --------------------------------------------------------

    def _embed_loop(self) -> None:
        """Single device owner: coalesce parsed docs into full embed
        batches, flush on batch-size or idleness, append in slices."""
        buf: list[tuple[IngestJob, str, list[Chunk], Optional[str]]] = []
        buffered = 0
        while True:
            try:
                item = self._queue.get(timeout=0.05 if buf else 0.25)
            except queue.Empty:
                if buf:
                    self._flush(buf)
                    buf, buffered = [], 0
                # NOTE: do NOT exit on _closed here — close() drains the
                # parse pool first, and a parse worker blocked on a full
                # queue needs this loop alive until the _STOP sentinel
                # (exiting early would deadlock pool.shutdown).
                continue
            if item is _STOP:
                if buf:
                    self._flush(buf)
                break
            buf.append(item)
            buffered += len(item[2])
            if buffered >= self._embed_batch:
                self._flush(buf)
                buf, buffered = [], 0

    def _flush(
        self, buf: list[tuple[IngestJob, str, list[Chunk], Optional[str]]]
    ) -> None:
        chunks = [c for _, _, doc_chunks, _ in buf for c in doc_chunks]
        try:
            embeddings = self._embed_fn([c.text for c in chunks])
            self._append(chunks, embeddings)
        except Exception as exc:  # noqa: BLE001 — isolate the poisoned doc
            if _is_device_error(exc):
                self._device_failure(buf, exc)
                return
            logger.exception(
                "bulk embed of %d chunks failed; retrying per file",
                len(chunks),
            )
            for i, (job, name, doc_chunks, path) in enumerate(buf):
                try:
                    embeddings = self._embed_fn(
                        [c.text for c in doc_chunks]
                    )
                    self._append(doc_chunks, embeddings)
                except Exception as exc:  # noqa: BLE001
                    if _is_device_error(exc):
                        # No retry isolates the card: this file and the
                        # rest of the batch fail with it.
                        self._device_failure(buf[i:], exc)
                        return
                    logger.exception("embed failed for %s", name)
                    self._file_failed(job, name, exc)
                else:
                    self._file_done(job, name, len(doc_chunks), path=path)
            return
        with self._jobs_lock:
            self.stats.embed_batches_total += 1
        for job, name, doc_chunks, path in buf:
            self._file_done(job, name, len(doc_chunks), path=path)

    def _append(self, chunks, embeddings) -> None:
        if self._admit_fn is not None:
            # Quota admission before any store write.  In the bulk path a
            # refusal unwinds into _flush's per-file retry, where each
            # file is re-admitted alone — only the file(s) that actually
            # breach the quota fail.
            self._admit_fn(chunks, embeddings)
        for lo in range(0, len(chunks), self._append_batch):
            hi = lo + self._append_batch
            try:
                self._append_fn(chunks[lo:hi], embeddings[lo:hi])
            except Exception as exc:
                if lo and _is_device_error(exc):
                    # The batch's files fail as a whole: take back the
                    # slices that already landed.
                    self._roll_back(chunks[:lo])
                raise
            with self._jobs_lock:
                self.stats.append_batches_total += 1

    def _roll_back(self, chunks) -> None:
        # By source, as resume() drops a half-applied file: rows an
        # earlier upload of the same name left go with them.
        if self._delete_source_fn is None:
            logger.error("%d rows of a failed append remain: no delete_source_fn", len(chunks))
            return
        for source in dict.fromkeys(c.source for c in chunks):
            try:
                self._delete_source_fn(source)
            except Exception:  # noqa: BLE001
                logger.exception("rows of %s may remain after a failed append", source)

    def _device_failure(self, buf, exc: Exception) -> None:
        """The card failed, not a file: fail every file of ``buf`` and mark
        their jobs failed, so no per-file isolation hides it."""
        logger.error("bulk embed of %d files failed on the device: %s", len(buf), exc)
        for job, name, _, _ in buf:
            job._device_failed = True
            self._file_failed(job, name, exc)

    # -- accounting --------------------------------------------------------

    def _file_done(
        self,
        job: IngestJob,
        name: str,
        chunks_ingested: int,
        path: Optional[str] = None,
    ) -> None:
        # Durability ordering: WAL fsync barrier → journal mark → staged
        # file deletion → in-memory accounting.  The mark must not claim
        # a file whose chunks a crash could still lose, and the staged
        # file (the resume payload) must outlive everything but the mark.
        if self._journal is not None and job.id in self._journaled_ids:
            try:
                if self._durable_flush_fn is not None:
                    self._durable_flush_fn()
                self._journal.file_done(job.id, name, chunks_ingested)
            except Exception:  # noqa: BLE001
                logger.exception("ingest journal write failed")
        if path is not None:
            self._cleanup(path)
        with self._jobs_lock:
            job.files_done += 1
            job.chunks_ingested += chunks_ingested
            self.stats.docs_total += 1
            self._maybe_finish(job)

    def _file_failed(self, job: IngestJob, name: str, exc: Exception) -> None:
        if self._journal is not None and job.id in self._journaled_ids:
            try:
                self._journal.file_failed(
                    job.id, name, f"{type(exc).__name__}: {exc}"
                )
            except Exception:  # noqa: BLE001
                logger.exception("ingest journal write failed")
        with self._jobs_lock:
            job.files_failed += 1
            job.errors.append(f"{name}: {type(exc).__name__}: {exc}"[:300])
            self.stats.doc_failures_total += 1
            self._maybe_finish(job)

    def _maybe_finish(self, job: IngestJob) -> None:
        # Called under _jobs_lock.
        job._pending -= 1
        if job._pending > 0:
            return
        job.finished_at = time.monotonic()
        if job._device_failed:
            job.status = "failed"
        elif job.files_failed == 0:
            job.status = "done"
        elif job.files_done == 0:
            job.status = "failed"
        else:
            job.status = "partial"
        elapsed = max(job.finished_at - job.started_at, 1e-9)
        self.stats.last_job_docs_per_sec = round(
            job.files_done / elapsed, 2
        )
        if self._journal is not None and job.id in self._journaled_ids:
            try:
                self._journal.job_finished(job.id, job.status)
            except Exception:  # noqa: BLE001
                logger.exception("ingest journal write failed")
        logger.info(
            "ingest job %s %s: %d/%d files, %d chunks in %.2fs",
            job.id, job.status, job.files_done, job.files_total,
            job.chunks_ingested, elapsed,
        )

    # -- introspection -----------------------------------------------------

    def status(self, job_id: Optional[str] = None) -> Optional[dict]:
        """Progress for one job, or all jobs (newest first) when None."""
        with self._jobs_lock:
            if job_id is not None:
                job = self._jobs.get(job_id)
                return job.snapshot() if job else None
            jobs = [j.snapshot() for j in reversed(self._jobs.values())]
            active = sum(
                1 for j in jobs if j["status"] in ("queued", "running")
            )
        return {"jobs": jobs, "active_jobs": active}

    def active_jobs(self) -> int:
        with self._jobs_lock:
            return sum(
                1
                for j in self._jobs.values()
                if j.status in ("queued", "running")
            )

    def wait(self, job_id: str, timeout: float = 60.0) -> dict:
        """Block until the job finishes (tests and benchmarks)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            snap = self.status(job_id)
            if snap is None:
                raise KeyError(f"unknown ingest job {job_id!r}")
            if snap["status"] not in ("queued", "running"):
                return snap
            time.sleep(0.01)
        raise TimeoutError(f"ingest job {job_id} still running")

    def close(self, timeout: float = 10.0) -> None:
        """Drain and stop: finish queued work, then stop the dispatcher."""
        if self._closed:
            return
        self._closed = True
        self._pool.shutdown(wait=True)
        self._queue.put(_STOP)
        self._dispatcher.join(timeout)
