"""Request deadlines (The Tail at Scale, CACM 2013, §"latency tail-tolerance").

A :class:`Deadline` is an absolute budget created once at request
admission (``resilience.default_deadline_ms`` config or the
``X-Request-Deadline-Ms`` header) and *propagated* — every downstream
stage asks for the **remaining** budget rather than applying its own
fixed timeout, so a slow early stage shrinks what later stages may
spend, and work whose budget is already gone is cancelled instead of
computed.

Propagation is explicit where call chains cross threads (the retrieval
micro-batcher carries deadlines per queue entry) and implicit via a
``contextvars`` scope elsewhere: the chain server binds the request's
deadline into the context it runs the pipeline generator under, so any
nested component — the HTTP embedder client, the LLM connector — can
pick it up with :func:`current_deadline` without every intermediate
signature growing a parameter.

A copy of the JAX package's ``resilience/deadline.py``; the port imports nothing of it.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import time
from typing import Iterator, Optional, Sequence


class DeadlineExceeded(TimeoutError):
    """The request's budget is spent; remaining work must be dropped."""


class Deadline:
    """Absolute expiry on the monotonic clock; ``None`` = unlimited."""

    __slots__ = ("_expires_at",)

    def __init__(self, expires_at: Optional[float] = None) -> None:
        self._expires_at = expires_at

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        """Budget starting now; ``ms <= 0`` means unlimited."""
        if ms is None or ms <= 0:
            return cls(None)
        return cls(time.monotonic() + ms / 1000.0)

    @classmethod
    def unlimited(cls) -> "Deadline":
        return cls(None)

    @classmethod
    def latest(cls, deadlines: Sequence[Optional["Deadline"]]) -> Optional["Deadline"]:
        """The loosest member of a batch (shared work must not be cut
        short for members that still have budget); ``None``/unlimited
        members make the whole batch unlimited."""
        expiries = []
        for dl in deadlines:
            if dl is None or dl._expires_at is None:
                return None
            expiries.append(dl._expires_at)
        if not expiries:
            return None
        return cls(max(expiries))

    @property
    def is_unlimited(self) -> bool:
        return self._expires_at is None

    def remaining_s(self) -> float:
        if self._expires_at is None:
            return math.inf
        return self._expires_at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def check(self, where: str = "") -> None:
        """Raise :class:`DeadlineExceeded` (and count it) if spent."""
        if self.expired():
            from generativeaiexamples_tpu_torch.resilience.metrics import (
                record_deadline_expired,
            )

            record_deadline_expired()
            raise DeadlineExceeded(
                f"deadline exceeded{f' at {where}' if where else ''}"
            )

    def cap_timeout(self, timeout_s: Optional[float]) -> Optional[float]:
        """Shrink a stage's own timeout to the remaining budget (never
        extends it).  Returns ``None`` only when both are unlimited."""
        rem = self.remaining_s()
        if math.isinf(rem):
            return timeout_s
        rem = max(rem, 0.0)
        if timeout_s is None:
            return rem
        return min(timeout_s, rem)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if self._expires_at is None:
            return "Deadline(unlimited)"
        return f"Deadline(remaining={self.remaining_ms():.1f}ms)"


_CURRENT: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "gaie_request_deadline", default=None
)


def current_deadline() -> Optional[Deadline]:
    """The deadline bound to this context, or None outside a request."""
    return _CURRENT.get()


def bind_deadline(deadline: Optional[Deadline]) -> None:
    """Bind ``deadline`` into the *current* context (used via
    ``Context.run`` to prime a copied context before handing it to a
    worker thread)."""
    _CURRENT.set(deadline)


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]) -> Iterator[Optional[Deadline]]:
    """Scoped binding for same-thread propagation."""
    token = _CURRENT.set(deadline)
    try:
        yield deadline
    finally:
        _CURRENT.reset(token)
