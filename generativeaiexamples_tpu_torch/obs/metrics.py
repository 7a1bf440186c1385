"""Fixed-bucket latency histograms for the request hot path.

Two Prometheus histogram families, exported from BOTH ``/metrics``
endpoints (chain server and engine server) via :func:`obs_metrics_lines`:

  ``rag_stage_latency_ms{stage=...}``    per-stage wall time (cache
                                         lookup, batcher queue wait,
                                         embed, search, rerank, LLM TTFT
                                         and stream) as observed by each
                                         request's :class:`RequestTrace`
  ``rag_request_latency_ms{route=...}``  end-to-end request wall time per
                                         route

Buckets are fixed (log-spaced milliseconds) so server-side p50/p95
queries work without a bench run and series from different processes
aggregate.  The standard stages and routes are pre-registered so every
series exports from zero at process start (same contract as
``resilience_metrics_lines``).  Reset rides ``reset_factories`` /
``reset_resilience``.

A copy of the JAX package's ``obs/metrics.py``; the port imports nothing of it.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Sequence

# Stage vocabulary of the instrumented hot path (docs/observability.md
# has the table).  Unknown labels still export — these are just the
# from-zero set.
STAGES = (
    "cache_lookup",
    "queue_wait",
    "embed",
    "search",
    "rerank",
    "llm_ttft",
    "llm_stream",
)

ROUTES = ("/generate", "/search")

# Upper bounds in milliseconds; +Inf is implicit and always emitted last.
STAGE_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
)
REQUEST_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)

# Cardinality guard: beyond this many distinct label values per family,
# new labels fold into "other" instead of growing the exposition forever.
_MAX_LABELS = 64


def _fmt(value: float) -> str:
    """Prometheus-friendly float: '0.5', '1', '2.5', '1000'."""
    return f"{value:g}"


class _Histogram:
    """One (label value)'s fixed-bucket histogram; caller holds the lock."""

    __slots__ = ("counts", "total", "sum_ms")

    def __init__(self, bounds: Sequence[float]) -> None:
        self.counts = [0] * len(bounds)  # per-bucket (non-cumulative)
        self.total = 0
        self.sum_ms = 0.0

    def observe(self, bounds: Sequence[float], ms: float) -> None:
        idx = bisect.bisect_left(bounds, ms)
        if idx < len(self.counts):
            self.counts[idx] += 1
        self.total += 1
        self.sum_ms += ms


class _Family:
    """A labeled histogram family with pre-registered from-zero labels."""

    def __init__(
        self, label: str, bounds: Sequence[float], known: Sequence[str]
    ) -> None:
        self.label = label
        self.bounds = tuple(bounds)
        self.known = tuple(known)
        self._lock = threading.Lock()
        self._hists: Dict[str, _Histogram] = {}
        self.reset()

    def observe(self, value: str, ms: float) -> None:
        with self._lock:
            hist = self._hists.get(value)
            if hist is None:
                if len(self._hists) >= _MAX_LABELS:
                    value = "other"
                    hist = self._hists.get(value)
                if hist is None:
                    hist = _Histogram(self.bounds)
                    self._hists[value] = hist
            hist.observe(self.bounds, ms)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                value: {"count": h.total, "sum_ms": round(h.sum_ms, 3)}
                for value, h in self._hists.items()
            }

    def lines(self, name: str, help_text: str) -> list:
        out = [f"# HELP {name} {help_text}", f"# TYPE {name} histogram"]
        with self._lock:
            ordered = [v for v in self.known if v in self._hists]
            ordered += sorted(v for v in self._hists if v not in self.known)
            for value in ordered:
                hist = self._hists[value]
                label = f'{self.label}="{_escape(value)}"'
                acc = 0
                for bound, count in zip(self.bounds, hist.counts):
                    acc += count
                    out.append(
                        f'{name}_bucket{{{label},le="{_fmt(bound)}"}} {acc}'
                    )
                out.append(f'{name}_bucket{{{label},le="+Inf"}} {hist.total}')
                out.append(f"{name}_sum{{{label}}} {round(hist.sum_ms, 3)}")
                out.append(f"{name}_count{{{label}}} {hist.total}")
        return out

    def reset(self) -> None:
        with self._lock:
            self._hists = {value: _Histogram(self.bounds) for value in self.known}


def _escape(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


_STAGE = _Family("stage", STAGE_BUCKETS_MS, STAGES)
_REQUEST = _Family("route", REQUEST_BUCKETS_MS, ROUTES)

# Scheduler tick wall time (engine server only; fed by Scheduler._loop).
# Ticks are sub-millisecond when idle, so the buckets start finer than
# the stage family's.
TICK_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0,
)
_TICK = _Family("loop", TICK_BUCKETS_MS, ("tick",))


def observe_stage(stage: str, duration_ms: float) -> None:
    """Record one stage timing (called by ``RequestTrace.add_stage``)."""
    _STAGE.observe(stage, float(duration_ms))


def observe_request(route: str, duration_ms: float) -> None:
    """Record one end-to-end request timing (``RequestTrace.finish``)."""
    _REQUEST.observe(route, float(duration_ms))


def observe_engine_tick(duration_ms: float) -> None:
    """Record one scheduler tick duration (``Scheduler._loop``)."""
    _TICK.observe("tick", float(duration_ms))


def engine_tick_metrics_lines() -> list:
    """Prometheus lines for the engine scheduler tick histogram (appended
    to the ENGINE ``/metrics`` only — the chain server has no tick loop)."""
    return _TICK.lines(
        "engine_tick_duration_ms",
        "Scheduler tick loop wall time (prefill+decode step).",
    )


def obs_snapshot() -> dict:
    return {"stage": _STAGE.snapshot(), "request": _REQUEST.snapshot()}


def obs_metrics_lines() -> list:
    """Prometheus text lines for both latency-histogram families."""
    return _STAGE.lines(
        "rag_stage_latency_ms",
        "Per-stage hot-path latency observed by request traces.",
    ) + _REQUEST.lines(
        "rag_request_latency_ms",
        "End-to-end request latency per route.",
    )


def reset_obs_metrics() -> None:
    """Testing hook: zero all families back to the from-zero label set."""
    _STAGE.reset()
    _REQUEST.reset()
    _TICK.reset()
