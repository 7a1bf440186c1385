"""Process-wide resilience counters and their Prometheus text export
(port of the JAX package's ``resilience/metrics.py``).

Exports (appended to ``/metrics`` by the chain and engine servers):

  ``rag_retries_total``                 retries performed by any
                                        :class:`~.retry.RetryPolicy`
  ``rag_deadline_expired_total``        requests/stages cancelled on an
                                        expired :class:`~.deadline.Deadline`
  ``rag_degraded_total{stage=...}``     degradation-ladder activations,
                                        per stage, once per request
  ``rag_breaker_state{dep=...}``        0=closed 1=half-open 2=open
  ``rag_breaker_open_total{dep=...}``   times each breaker tripped

Gauges export zeros for the standard failure domains before first use
so dashboards see every series from process start.
"""

from __future__ import annotations

import threading
from typing import Dict

from generativeaiexamples_tpu_torch.resilience.breaker import (
    STANDARD_DEPS,
    all_breakers,
    get_breaker,
    reset_breakers,
)


class _ResilienceStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.retries_total = 0
        self.deadline_expired_total = 0
        self.degraded_total: Dict[str, int] = {}

    def record_retry(self) -> None:
        with self._lock:
            self.retries_total += 1

    def record_deadline_expired(self) -> None:
        with self._lock:
            self.deadline_expired_total += 1

    def record_degraded(self, stage: str) -> None:
        with self._lock:
            self.degraded_total[stage] = self.degraded_total.get(stage, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "retries_total": self.retries_total,
                "deadline_expired_total": self.deadline_expired_total,
                "degraded_total": dict(self.degraded_total),
            }

    def reset(self) -> None:
        with self._lock:
            self.retries_total = 0
            self.deadline_expired_total = 0
            self.degraded_total.clear()


_STATS = _ResilienceStats()


def record_retry() -> None:
    _STATS.record_retry()


def record_deadline_expired() -> None:
    _STATS.record_deadline_expired()


def record_degraded(stage: str) -> None:
    _STATS.record_degraded(stage)


def resilience_snapshot() -> dict:
    snap = _STATS.snapshot()
    snap["breakers"] = {
        name: breaker.state for name, breaker in sorted(all_breakers().items())
    }
    return snap


def resilience_metrics_lines() -> list:
    """Prometheus text lines for the resilience counters and breaker
    gauges (standard deps are instantiated so they export from zero)."""
    snap = _STATS.snapshot()
    lines = [
        "# HELP rag_retries_total Retries performed by resilience retry policies.",
        "# TYPE rag_retries_total counter",
        f"rag_retries_total {snap['retries_total']}",
        "# HELP rag_deadline_expired_total Work cancelled on an expired request deadline.",
        "# TYPE rag_deadline_expired_total counter",
        f"rag_deadline_expired_total {snap['deadline_expired_total']}",
        "# HELP rag_degraded_total Graceful-degradation ladder activations per stage.",
        "# TYPE rag_degraded_total counter",
    ]
    for stage in ("rerank", "shrink_k", "index_fallback", "cache_stale", "retrieval"):
        count = snap["degraded_total"].get(stage, 0)
        lines.append(f'rag_degraded_total{{stage="{stage}"}} {count}')
    for stage, count in sorted(snap["degraded_total"].items()):
        if stage not in ("rerank", "shrink_k", "index_fallback", "cache_stale", "retrieval"):
            lines.append(f'rag_degraded_total{{stage="{stage}"}} {count}')
    lines += [
        "# HELP rag_breaker_state Circuit breaker state (0=closed 1=half-open 2=open).",
        "# TYPE rag_breaker_state gauge",
    ]
    for dep in STANDARD_DEPS:
        get_breaker(dep)
    breakers = dict(sorted(all_breakers().items()))
    for dep, breaker in breakers.items():
        lines.append(f'rag_breaker_state{{dep="{dep}"}} {breaker.state_code()}')
    lines += [
        "# HELP rag_breaker_open_total Times each circuit breaker tripped open.",
        "# TYPE rag_breaker_open_total counter",
    ]
    for dep, breaker in breakers.items():
        lines.append(f'rag_breaker_open_total{{dep="{dep}"}} {breaker.open_total}')
    return lines


def reset_resilience() -> None:
    """Testing hook: zero the counters, drop breakers and fault points
    (plus the cache counters — stale serves land in both ledgers — and
    the stage/request latency histograms, which aggregate the same
    per-request telemetry).  The reference also resets its admission
    controller, which the port does not have yet."""
    from generativeaiexamples_tpu_torch.cache.metrics import reset_cache_metrics
    from generativeaiexamples_tpu_torch.obs.metrics import reset_obs_metrics
    from generativeaiexamples_tpu_torch.resilience.faults import reset_faults

    _STATS.reset()
    reset_breakers()
    reset_faults()
    reset_cache_metrics()
    reset_obs_metrics()
