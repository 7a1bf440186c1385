"""Jittered-backoff retries with per-endpoint retry budgets.

The Tail-at-Scale discipline: retries hide *transient* faults but must
never amplify a real outage, so every policy (a) backs off
exponentially with full jitter, (b) spends from a :class:`RetryBudget`
that caps the retry-to-request ratio per endpoint (a token bucket that
deposits a fraction per first attempt — when a dependency is hard down,
the budget drains and calls fail fast instead of multiplying load),
and (c) never sleeps past the request's :class:`~.deadline.Deadline`.

A copy of the JAX package's ``resilience/retry.py``; the port imports nothing of it.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Optional, TypeVar

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.resilience.breaker import (
    CircuitBreaker,
    CircuitOpenError,
)
from generativeaiexamples_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded

logger = get_logger(__name__)

_R = TypeVar("_R")


class RetryBudget:
    """Token bucket bounding the retry-to-request ratio of one endpoint.

    Every first attempt deposits ``ratio`` tokens (capped at ``cap``);
    every retry withdraws one.  Sustained failure therefore converges to
    at most ``ratio`` retries per request instead of
    ``max_attempts - 1`` — the retry-storm guard.
    """

    def __init__(self, ratio: float = 0.2, cap: float = 10.0) -> None:
        if ratio < 0:
            raise ValueError(f"ratio must be >= 0, got {ratio}")
        self.ratio = float(ratio)
        self.cap = float(max(cap, 1.0))
        self._tokens = self.cap  # start full: cold-start retries allowed
        self._lock = threading.Lock()

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self._tokens + self.ratio, self.cap)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens


def _default_retryable(exc: BaseException) -> bool:
    """Anything except cancellation-ish control flow is retryable by
    default; callers with protocol knowledge (HTTP 4xx vs 5xx) pass
    their own classifier."""
    return isinstance(exc, Exception)


@dataclasses.dataclass
class RetryPolicy:
    """Retry loop: attempts, jittered exponential backoff, budget,
    breaker gating, and deadline awareness in one place.

    ``call`` runs ``fn`` up to ``max_attempts`` times.  Per attempt it
    (1) checks the deadline and the breaker, (2) runs ``fn``, recording
    the outcome into the breaker, (3) on a retryable failure sleeps
    ``base_ms * multiplier^n`` with full jitter — but never past the
    deadline, and only while the retry budget has tokens.
    :class:`DeadlineExceeded` and :class:`CircuitOpenError` are never
    retried and never recorded as dependency failures (expiry is the
    *request's* state, not the dependency's).
    """

    max_attempts: int = 3
    base_ms: float = 25.0
    multiplier: float = 2.0
    max_ms: float = 1000.0
    jitter: float = 1.0  # fraction of the backoff randomized (full jitter)
    budget: Optional[RetryBudget] = None
    retryable: Callable[[BaseException], bool] = _default_retryable
    name: str = "retry"

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Sleep before retry number ``attempt`` (1-based), seconds."""
        raw = min(self.base_ms * (self.multiplier ** (attempt - 1)), self.max_ms)
        if self.jitter > 0:
            low = raw * (1.0 - min(self.jitter, 1.0))
            raw = rng.uniform(low, raw)
        return raw / 1000.0

    def call(
        self,
        fn: Callable[[], _R],
        *,
        deadline: Optional[Deadline] = None,
        breaker: Optional[CircuitBreaker] = None,
        rng: Optional[random.Random] = None,
    ) -> _R:
        from generativeaiexamples_tpu_torch.resilience.metrics import record_retry

        rng = rng or random
        if self.budget is not None:
            self.budget.deposit()
        attempt = 0
        while True:
            attempt += 1
            if deadline is not None:
                deadline.check(f"{self.name} attempt {attempt}")
            if breaker is not None:
                breaker.check()
            try:
                result = fn()
            except (DeadlineExceeded, CircuitOpenError):
                raise
            except BaseException as exc:
                if breaker is not None and isinstance(exc, Exception):
                    breaker.record_failure()
                if attempt >= self.max_attempts or not self.retryable(exc):
                    raise
                if self.budget is not None and not self.budget.try_spend():
                    logger.warning(
                        "%s: retry budget exhausted, failing fast", self.name
                    )
                    raise
                pause = self.backoff_s(attempt, rng)
                if deadline is not None:
                    remaining = deadline.remaining_s()
                    if pause >= remaining:
                        # Sleeping would spend the whole budget; surface
                        # the dependency's error, not a manufactured
                        # timeout.
                        raise
                record_retry()
                logger.debug(
                    "%s: attempt %d/%d failed (%s); retrying in %.0f ms",
                    self.name, attempt, self.max_attempts,
                    type(exc).__name__, pause * 1000,
                )
                time.sleep(pause)
                continue
            if breaker is not None:
                breaker.record_success()
            return result


def policy_from_config(
    name: str,
    *,
    budget: Optional[RetryBudget] = None,
    retryable: Callable[[BaseException], bool] = _default_retryable,
) -> RetryPolicy:
    """A :class:`RetryPolicy` sized from ``resilience.retry_*`` config."""
    from generativeaiexamples_tpu_torch.core.configuration import get_config

    r = get_config().resilience
    return RetryPolicy(
        max_attempts=r.retry_max_attempts,
        base_ms=r.retry_base_ms,
        max_ms=r.retry_max_ms,
        jitter=r.retry_jitter,
        budget=budget
        if budget is not None
        else RetryBudget(ratio=r.retry_budget_ratio),
        retryable=retryable,
        name=name,
    )
