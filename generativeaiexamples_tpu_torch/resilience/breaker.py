"""Per-dependency circuit breakers.

Classic three-state breaker (closed → open → half-open) over a sliding
count window of call outcomes.  One breaker per failure domain —
``embedder``, ``store``, ``reranker``, ``llm`` — shared process-wide
through a registry so every caller that touches a dependency feeds the
same failure window, and ``/metrics`` can export
``rag_breaker_state{dep=...}`` without threading breaker handles
around.

States:
  * **closed** — calls flow; outcomes recorded into the window.  Once
    the window holds ``min_calls`` outcomes and the failure rate
    reaches ``failure_threshold``, the breaker opens.
  * **open** — calls are refused instantly with
    :class:`CircuitOpenError` (no timeout paid, no load added to a
    struggling dependency).  After ``reset_timeout_s`` the next caller
    is admitted as a half-open probe.
  * **half-open** — up to ``half_open_max`` concurrent probes; one
    failure re-opens (fresh cool-down), ``half_open_max`` consecutive
    successes close and clear the window.

A copy of the JAX package's ``resilience/breaker.py``; the port imports nothing of it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, TypeVar

_R = TypeVar("_R")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Prometheus gauge encoding for rag_breaker_state{dep=...}.
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitOpenError(RuntimeError):
    """Refused instantly: the dependency's breaker is open."""

    def __init__(self, dep: str, retry_after_s: float = 0.0) -> None:
        super().__init__(
            f"circuit breaker for {dep!r} is open"
            + (f" (retry after {retry_after_s:.1f}s)" if retry_after_s > 0 else "")
        )
        self.dep = dep
        self.retry_after_s = max(retry_after_s, 0.0)


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker with a count window."""

    def __init__(
        self,
        name: str,
        *,
        window: int = 32,
        min_calls: int = 8,
        failure_threshold: float = 0.5,
        reset_timeout_s: float = 30.0,
        half_open_max: int = 2,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError(
                f"failure_threshold must be in (0, 1], got {failure_threshold}"
            )
        self.name = name
        self.min_calls = max(1, int(min_calls))
        self.failure_threshold = float(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_max = max(1, int(half_open_max))
        self._clock = clock
        self._lock = threading.Lock()
        self._window: deque[bool] = deque(maxlen=int(window))  # True = failure
        self._state = CLOSED
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self._half_open_successes = 0
        self.open_total = 0  # times the breaker tripped (metrics)

    # -- gatekeeping -------------------------------------------------------

    def allow(self) -> bool:
        """May a call proceed right now?  (Transitions open → half-open
        after the cool-down; counts half-open probe admissions.)"""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_timeout_s:
                    return False
                self._state = HALF_OPEN
                self._half_open_inflight = 0
                self._half_open_successes = 0
            # HALF_OPEN: admit a bounded number of probes.
            if self._half_open_inflight >= self.half_open_max:
                return False
            self._half_open_inflight += 1
            return True

    def check(self) -> None:
        """Raise :class:`CircuitOpenError` unless a call may proceed."""
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after_s())

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(
                self.reset_timeout_s - (self._clock() - self._opened_at), 0.0
            )

    # -- outcome recording -------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._half_open_inflight = max(self._half_open_inflight - 1, 0)
                self._half_open_successes += 1
                if self._half_open_successes >= self.half_open_max:
                    self._state = CLOSED
                    self._window.clear()
                return
            self._window.append(False)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # A failed probe re-opens immediately with a fresh timer.
                self._trip()
                return
            if self._state == OPEN:
                return
            self._window.append(True)
            if (
                len(self._window) >= self.min_calls
                and sum(self._window) / len(self._window)
                >= self.failure_threshold
            ):
                self._trip()

    def _trip(self) -> None:
        """Open the breaker; call under the lock."""
        self._state = OPEN
        self._opened_at = self._clock()
        self._half_open_inflight = 0
        self._half_open_successes = 0
        self._window.clear()
        self.open_total += 1

    # -- convenience -------------------------------------------------------

    def call(self, fn: Callable[[], _R]) -> _R:
        """Gate + record one call (success/failure) around ``fn``."""
        self.check()
        try:
            result = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    @property
    def state(self) -> str:
        with self._lock:
            if (
                self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s
            ):
                return HALF_OPEN  # next allow() will admit a probe
            return self._state

    def state_code(self) -> int:
        return STATE_CODES[self.state]

    def reset(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._window.clear()
            self._half_open_inflight = 0
            self._half_open_successes = 0


# -- registry ---------------------------------------------------------------

# Failure domains every serving-path request can cross; /metrics exports
# a state gauge for each even before its breaker is first touched.
STANDARD_DEPS = ("embedder", "store", "reranker", "llm")

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Dict[str, CircuitBreaker] = {}


def get_breaker(name: str, **kwargs) -> CircuitBreaker:
    """Process-wide breaker for a dependency, created on first use.

    With no explicit ``kwargs`` the breaker is sized from the app config
    (``resilience.breaker_*`` keys); later calls return the same
    instance regardless of arguments.
    """
    with _REGISTRY_LOCK:
        breaker = _REGISTRY.get(name)
        if breaker is None:
            if not kwargs:
                kwargs = _config_kwargs()
            breaker = CircuitBreaker(name, **kwargs)
            _REGISTRY[name] = breaker
        return breaker


def _config_kwargs() -> dict:
    try:
        from generativeaiexamples_tpu_torch.core.configuration import get_config

        r = get_config().resilience
        return dict(
            window=r.breaker_window,
            min_calls=r.breaker_min_calls,
            failure_threshold=r.breaker_failure_threshold,
            reset_timeout_s=r.breaker_reset_s,
            half_open_max=r.breaker_half_open_max,
        )
    except Exception:  # config unavailable (bare library use): defaults
        return {}


def all_breakers() -> Dict[str, CircuitBreaker]:
    with _REGISTRY_LOCK:
        return dict(_REGISTRY)


def reset_breakers() -> None:
    """Testing hook: drop every registered breaker."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
