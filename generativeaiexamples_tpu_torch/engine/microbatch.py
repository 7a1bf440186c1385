"""Cross-request dynamic micro-batching (port of ``engine/microbatch.py``).

:class:`MicroBatcher` is a worker-thread queue in front of any
``fn(list[item]) -> list[result]``.  Concurrent ``submit``/``call``
invocations enqueue items; the worker coalesces everything that arrives
within a ``max_wait_ms`` window (capped at ``max_batch``) into one ``fn``
dispatch and resolves the per-caller futures.  :class:`BatchedEmbedder`
puts one in front of an embedder's ``embed_queries``, so concurrent
single-query ``/v1/embeddings`` requests share one BERT forward.

Contract:
  * **Per-item error isolation**: a failed batch is retried item by item,
    so one poisoned input fails only its own future.
  * **Deadline awareness**: each queue entry carries its request's
    :class:`~..resilience.deadline.Deadline` and
    :class:`~..obs.trace.RequestTrace` (explicitly: contextvars do not
    cross into the worker thread).  An entry whose budget expired while
    queued fails with ``DeadlineExceeded`` before dispatch, and the batch
    runs under the loosest surviving member's deadline, so shared work is
    not cut short for members that still have budget.  Each member's trace
    gets its own ``queue_wait`` stage with the shared batch id.
  * **Crash guard**: if the worker thread dies outside the per-item
    dispatch path, every queued future is failed (not hung) and a fresh
    worker is started.
  * **Clean shutdown**: ``close()`` drains queued callers (they get
    answers) before the worker exits; only new submissions are refused.
  * **Stats**: batch-size and queue-wait counters for the ``rag_*`` series
    of ``/metrics``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Callable, Generic, Optional, Sequence, TypeVar

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.obs.trace import RequestTrace, current_request_trace
from generativeaiexamples_tpu_torch.resilience.deadline import (
    Deadline,
    DeadlineExceeded,
    current_deadline,
    deadline_scope,
)
from generativeaiexamples_tpu_torch.utils.buckets import bucket_size

logger = get_logger(__name__)

T = TypeVar("T")
R = TypeVar("R")


class BatcherClosed(RuntimeError):
    """Raised by submissions arriving after :meth:`MicroBatcher.close`."""


class _BatchStats:
    """Thread-safe counters exported through ``/metrics`` (rag_* series)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests_total = 0
        self.batches_total = 0
        self.batch_size_sum = 0
        self.batch_size_max = 0
        self.bucket_size_sum = 0  # pow2-padded sizes the device forwards see
        self.queue_wait_ms_sum = 0.0
        self.queue_wait_ms_max = 0.0
        self.errors_total = 0

    def record_batch(self, size: int, bucket: int, waits_ms: Sequence[float]) -> int:
        """Returns the batch's ordinal (1-based), used as its trace id."""
        with self._lock:
            self.batches_total += 1
            self.batch_size_sum += size
            self.batch_size_max = max(self.batch_size_max, size)
            self.bucket_size_sum += bucket
            for w in waits_ms:
                self.queue_wait_ms_sum += w
                self.queue_wait_ms_max = max(self.queue_wait_ms_max, w)
            return self.batches_total

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests_total": self.requests_total,
                "batches_total": self.batches_total,
                "batch_size_sum": self.batch_size_sum,
                "batch_size_max": self.batch_size_max,
                "bucket_size_sum": self.bucket_size_sum,
                "queue_wait_ms_sum": round(self.queue_wait_ms_sum, 3),
                "queue_wait_ms_max": round(self.queue_wait_ms_max, 3),
                "errors_total": self.errors_total,
            }


class MicroBatcher(Generic[T, R]):
    """Coalesce concurrent calls to ``fn`` into shared batched dispatches.

    Args:
      fn: batch function; must return one result per input item, in order.
        A short result list fails the whole batch (then each item alone).
      max_batch: dispatch cap; arrivals beyond it start the next batch.
      max_wait_ms: how long the first-arrived item waits for batch-mates
        before the batch dispatches anyway.
      name: label for the worker thread and log lines.
    """

    def __init__(
        self,
        fn: Callable[[list[T]], Sequence[R]],
        *,
        max_batch: int = 32,
        max_wait_ms: float = 3.0,
        name: str = "microbatch",
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self._fn = fn
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.name = name
        self.stats = _BatchStats()
        self._cond = threading.Condition()
        # Entries: (item, future, enqueue time on the perf_counter clock,
        # deadline, trace).
        self._queue: deque[tuple] = deque()
        self._inflight: list[tuple] = []
        self._closed = False
        self._thread = threading.Thread(target=self._worker, name=f"{name}-batcher", daemon=True)
        self._thread.start()

    # -- caller side -------------------------------------------------------

    def submit(
        self, item: T, *, deadline: Optional[Deadline] = None, trace: Optional[RequestTrace] = None
    ) -> "Future[R]":
        """Enqueue one item; returns a future resolving to its result.

        ``deadline`` and ``trace`` default to the submitting thread's
        context values and ride the queue entry.  An already-expired
        budget is refused here."""
        if deadline is None:
            deadline = current_deadline()
        if trace is None:
            trace = current_request_trace()
        if deadline is not None:
            deadline.check(f"{self.name} submit")
        fut: "Future[R]" = Future()
        with self._cond:
            if self._closed:
                raise BatcherClosed(f"{self.name}: batcher is closed")
            with self.stats._lock:
                self.stats.requests_total += 1
            self._queue.append((item, fut, time.perf_counter(), deadline, trace))
            self._cond.notify()
        return fut

    def call(
        self,
        item: T,
        timeout: Optional[float] = None,
        *,
        deadline: Optional[Deadline] = None,
        trace: Optional[RequestTrace] = None,
    ) -> R:
        """Blocking convenience wrapper around :meth:`submit`; the wait is
        capped by the deadline, and a wait cut by it raises
        ``DeadlineExceeded``."""
        if deadline is None:
            deadline = current_deadline()
        if deadline is not None:
            timeout = deadline.cap_timeout(timeout)
        fut = self.submit(item, deadline=deadline, trace=trace)
        try:
            return fut.result(timeout=timeout)
        except FuturesTimeoutError:
            if deadline is not None and deadline.expired():
                fut.cancel()
                deadline.check(f"{self.name} wait")
            raise

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting work, drain queued callers, join the worker.
        Idempotent."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    # -- worker side -------------------------------------------------------

    def _worker(self) -> None:
        try:
            self._worker_loop()
        except BaseException as exc:  # crash guard: never hang the queue
            self._on_worker_crash(exc)

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:
                    return  # closed and drained
                # The first item's arrival opens the window; dispatch when
                # it ends, the batch fills, or close() flushes.
                window_end = self._queue[0][2] + self.max_wait_ms / 1000.0
                while (
                    len(self._queue) < self.max_batch
                    and not self._closed
                    and (remaining := window_end - time.perf_counter()) > 0
                ):
                    self._cond.wait(timeout=remaining)
                entries = [self._queue.popleft() for _ in range(min(len(self._queue), self.max_batch))]
                # Popped entries are no longer queued: without this handoff
                # a crash mid-dispatch would strand their futures.
                self._inflight = entries
            self._dispatch(entries)
            with self._cond:
                self._inflight = []

    def _on_worker_crash(self, exc: BaseException) -> None:
        """Fail every queued future and (unless closed) restart the worker."""
        logger.exception("%s: worker thread crashed; failing queued callers", self.name)
        with self._cond:
            pending = self._inflight + list(self._queue)
            self._inflight = []
            self._queue.clear()
            if not self._closed:
                self._thread = threading.Thread(target=self._worker, name=f"{self.name}-batcher", daemon=True)
                self._thread.start()
        wrapped = RuntimeError(f"{self.name}: batcher worker crashed: {exc!r}")
        wrapped.__cause__ = exc
        for entry in pending:
            if not entry[1].done():
                self._fail_one(entry[1], wrapped)

    def _dispatch(self, entries: list[tuple]) -> None:
        now = time.perf_counter()
        # Cancel, don't compute: entries whose budget expired while queued
        # fail here, before any device work.
        live = []
        for entry in entries:
            if entry[3] is not None and entry[3].expired():
                self._fail_one(entry[1], DeadlineExceeded(f"deadline exceeded in {self.name} queue"),
                               deadline_expired=True)
            else:
                live.append(entry)
        if not live:
            return
        entries = live
        items = [e[0] for e in entries]
        waits_ms = [(now - e[2]) * 1000.0 for e in entries]
        batch_seq = self.stats.record_batch(
            len(items), bucket_size(len(items), minimum=1, maximum=self.max_batch), waits_ms
        )
        # Each member's queue wait onto its own trace; the shared batch id
        # ties the members' traces together.
        batch_id = f"{self.name}-{batch_seq}"
        for (_, _, enq, _, trace), wait_ms in zip(entries, waits_ms):
            if trace is not None:
                trace.add_stage("queue_wait", wait_ms, start=enq, batch_id=batch_id, batch_size=len(items))
        try:
            # Shared work runs under the loosest member's budget.
            with deadline_scope(Deadline.latest([e[3] for e in entries])):
                results = self._run(items)
        except Exception as exc:
            if len(entries) == 1:
                self._fail_one(entries[0][1], exc)
                return
            # Per-item error isolation: retry individually so only the
            # offender's future carries the exception.
            logger.warning("%s: batch of %d failed; retrying items individually", self.name, len(items))
            for item, fut, _, dl, _ in entries:
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    with deadline_scope(dl):
                        fut.set_result(self._run([item])[0])
                except Exception as item_exc:
                    with self.stats._lock:
                        self.stats.errors_total += 1
                    fut.set_exception(item_exc)
            return
        for (_, fut, _, _, _), res in zip(entries, results):
            if fut.set_running_or_notify_cancel():  # else cancelled while queued
                fut.set_result(res)

    def _run(self, items: list[T]) -> list[R]:
        results = list(self._fn(items))
        if len(results) != len(items):
            raise RuntimeError(f"{self.name}: batch fn returned {len(results)} results for {len(items)} items")
        return results

    def _fail_one(self, fut: Future, exc: BaseException, *, deadline_expired: bool = False) -> None:
        with self.stats._lock:
            self.stats.errors_total += 1
        if deadline_expired:
            from generativeaiexamples_tpu_torch.resilience.metrics import record_deadline_expired

            record_deadline_expired()
        if fut.set_running_or_notify_cancel():
            fut.set_exception(exc)


class BatchedEmbedder:
    """Embedder facade that micro-batches concurrent ``embed_query`` calls.

    N concurrent single-query calls (the per-request shape of
    ``/v1/embeddings``) share one ``embed_queries`` forward instead of N
    batch-1 forwards.  ``embed_queries`` (already a batch) and
    ``embed_documents`` pass through untouched.
    """

    def __init__(self, embedder, *, max_batch: int = 32, max_wait_ms: float = 3.0) -> None:
        self._inner = embedder
        self.dimensions = embedder.dimensions
        self.batcher: MicroBatcher[str, list[float]] = MicroBatcher(
            self._embed_query_batch, max_batch=max_batch, max_wait_ms=max_wait_ms, name="embed-query"
        )

    def _embed_query_batch(self, texts: list[str]) -> list[list[float]]:
        if hasattr(self._inner, "embed_queries"):
            return self._inner.embed_queries(texts)
        return [self._inner.embed_query(t) for t in texts]

    def embed_query(self, text: str) -> list[float]:
        return self.batcher.call(text)

    def embed_queries(self, texts: Sequence[str]) -> list[list[float]]:
        if not texts:
            return []
        return self._embed_query_batch(list(texts))

    def embed_documents(self, texts: Sequence[str]) -> list[list[float]]:
        return self._inner.embed_documents(texts)

    def close(self) -> None:
        self.batcher.close()
