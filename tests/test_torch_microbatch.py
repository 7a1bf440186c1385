"""The port's micro-batcher carries each request's deadline and trace on its
queue entry, as the JAX package's does (``engine/microbatch.py``).

The cases drive both packages' batchers with the same timings: a member
whose deadline passed while queued fails alone with ``DeadlineExceeded``
and never reaches the batch function, the batch runs under its loosest
surviving member's deadline, and each member's trace gets its own
``queue_wait`` stage tagged with the shared batch id.
"""

import threading
import time

import pytest

from generativeaiexamples_tpu.engine import microbatch as jmb
from generativeaiexamples_tpu.obs import trace as jtrace
from generativeaiexamples_tpu.resilience import deadline as jdl
from generativeaiexamples_tpu.resilience import metrics as jmetrics
from generativeaiexamples_tpu_torch.engine import microbatch as tmb
from generativeaiexamples_tpu_torch.obs import trace as ttrace
from generativeaiexamples_tpu_torch.resilience import deadline as tdl
from generativeaiexamples_tpu_torch.resilience import metrics as tmetrics

PACKAGES = {
    "jax": (jmb, jdl, jtrace, jmetrics),
    "torch": (tmb, tdl, ttrace, tmetrics),
}


@pytest.fixture(autouse=True)
def _clean():
    for _, _, _, metrics in PACKAGES.values():
        metrics.reset_resilience()
    yield
    for _, _, _, metrics in PACKAGES.values():
        metrics.reset_resilience()


def _both(fn):
    out = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert out["jax"] == out["torch"], out
    return out["torch"]


def test_expired_member_fails_alone():
    """Three members share a 150 ms window; one has a 20 ms budget.  It
    fails with DeadlineExceeded before dispatch, its batch-mates get their
    answers from one dispatch without it."""

    def run(mb, dl, _trace, metrics):
        dispatched = []
        batcher = mb.MicroBatcher(lambda items: dispatched.append(list(items)) or [i.upper() for i in items],
                                  max_batch=8, max_wait_ms=150.0, name="t")
        try:
            futs = [batcher.submit("a", deadline=dl.Deadline.after_ms(30_000)),
                    batcher.submit("b", deadline=dl.Deadline.after_ms(20)),
                    batcher.submit("c")]
            out = []
            for f in futs:
                try:
                    out.append(f.result(timeout=5))
                except dl.DeadlineExceeded as exc:
                    out.append(f"expired: {exc}")
            return out, dispatched, metrics.resilience_snapshot()["deadline_expired_total"], batcher.stats.snapshot()[
                "errors_total"]
        finally:
            batcher.close()

    out, dispatched, expired, errors = _both(run)
    assert out == ["A", "expired: deadline exceeded in t queue", "C"]
    assert dispatched == [["a", "c"]] and expired == errors == 1


def test_submit_refuses_an_expired_budget_and_call_caps_its_wait():
    def run(mb, dl, _trace, _metrics):
        release = threading.Event()
        batcher = mb.MicroBatcher(lambda items: release.wait(5) and items, max_batch=4, max_wait_ms=1.0, name="t")
        try:
            seen = []
            try:
                batcher.submit("x", deadline=dl.Deadline(time.monotonic() - 1))
            except dl.DeadlineExceeded as exc:
                seen.append(str(exc))
            t0 = time.monotonic()
            try:
                batcher.call("y", timeout=5, deadline=dl.Deadline.after_ms(100))
            except dl.DeadlineExceeded as exc:
                seen.append(str(exc))
            seen.append(time.monotonic() - t0 < 2.0)
            return seen
        finally:
            release.set()
            batcher.close()

    assert _both(run) == ["deadline exceeded at t submit", "deadline exceeded at t wait", True]


def test_loosest_member_deadline_governs_the_batch():
    """The batch function sees the latest of its members' deadlines, and no
    deadline at all when one member is unlimited; each item retried alone
    after a failed batch runs under its own."""

    def run(mb, dl, _trace, _metrics):
        seen = []

        def fn(items):
            d = dl.current_deadline()
            seen.append((list(items), None if d is None else round(d.remaining_ms(), -3)))
            if len(items) > 1 and "boom" in items:
                raise ValueError("poisoned")
            return items

        batcher = mb.MicroBatcher(fn, max_batch=8, max_wait_ms=100.0, name="t")
        try:
            with dl.deadline_scope(dl.Deadline.after_ms(10_000)):
                f1 = batcher.submit("a")
            f2 = batcher.submit("b", deadline=dl.Deadline.after_ms(30_000))
            f3 = batcher.submit("c", deadline=dl.Deadline.after_ms(20_000))
            results = [f.result(timeout=5) for f in (f1, f2, f3)]
            f4 = batcher.submit("d", deadline=dl.Deadline.after_ms(5_000))
            f5 = batcher.submit("e")
            results += [f.result(timeout=5) for f in (f4, f5)]
            f6 = batcher.submit("boom", deadline=dl.Deadline.after_ms(7_000))
            f7 = batcher.submit("f", deadline=dl.Deadline.after_ms(40_000))
            results.append(f7.result(timeout=5))
            results.append(f6.result(timeout=5))
            return results, seen
        finally:
            batcher.close()

    results, seen = _both(run)
    assert results == ["a", "b", "c", "d", "e", "f", "boom"]
    assert seen[0] == (["a", "b", "c"], 30_000.0) and seen[1] == (["d", "e"], None)
    assert seen[2:] == [(["boom", "f"], 40_000.0), (["boom"], 7_000.0), (["f"], 40_000.0)]


def test_each_member_gets_its_own_trace():
    def run(mb, _dl, trace, _metrics):
        batcher = mb.MicroBatcher(lambda items: items, max_batch=8, max_wait_ms=100.0, name="t")
        try:
            traces = [trace.RequestTrace(request_id=f"{i:032x}", route="/search") for i in range(3)]
            futs = [batcher.submit("x0", trace=traces[0])]
            with trace.trace_scope(traces[1]):
                futs.append(batcher.submit("x1"))  # the context's trace rides the entry
            futs.append(batcher.submit("x2", trace=traces[2]))
            futs.append(batcher.submit("untraced"))
            [f.result(timeout=5) for f in futs]
            batcher.submit("later", trace=traces[0]).result(timeout=5)
            out = []
            for tr in traces:
                waits = [s for s in tr.stages() if s["stage"] == "queue_wait"]
                out.append([(s["attrs"]["batch_id"], s["attrs"]["batch_size"], s["duration_ms"] > 0) for s in waits])
            return out
        finally:
            batcher.close()

    assert _both(run) == [[("t-1", 4, True), ("t-2", 1, True)], [("t-1", 4, True)], [("t-1", 4, True)]]
