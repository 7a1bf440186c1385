"""Fault injection for chaos testing.

A :class:`FaultInjector` holds named **fault points** — probabilistic
exceptions and injected latency at well-known sites on the serving
path.  Production code calls :func:`inject` at each site; with no
faults installed that is one module-level boolean check, so the hooks
cost nothing in normal operation.

Standard sites (the names ``bench_chaos`` and the docs use):

  =============  =====================================================
  ``embedder``   query/document embedding (Retriever embed stage and
                 the HTTP embedder client)
  ``store``      vector-store search dispatch
  ``reranker``   cross-encoder scoring stage
  ``llm``        generation backends (TPU + OpenAI-compatible client)
  ``microbatch`` inside the MicroBatcher worker's batch dispatch
  ``replica``    one pass of a scheduler replica's tick loop (gray-
                 failure drills: ``index`` selects a single straggler)
  ``spec_draft`` the scheduler's speculative-decode dispatch (draft
                 model or n-gram proposer); an injected error degrades
                 that TICK to the plain decode chunk — requests never
                 fail, acceptance just drops to the non-spec baseline
                 (``spec_draft:error=1`` kills speculation entirely)
  =============  =====================================================

Configuration: programmatic (``install``), or a spec string from the
``GAIE_FAULTS`` env var / ``resilience.faults`` config key::

    embedder:error=0.1;reranker:latency=200;llm:error=0.05,latency=50

``error`` is a probability in [0, 1]; ``latency`` is milliseconds added
to every traversal of the site.  The RNG is seeded so chaos runs are
reproducible.

The ``replica`` site additionally takes ``index``: with
``replica:latency=200,index=1`` only the scheduler whose pool index is
1 sleeps per tick — a deterministic slow-but-alive straggler for
``bench.py --gray`` (its tick counter keeps advancing, so the binary
stall detector never fires; only the brownout scoring sees it).

A copy of the JAX package's ``resilience/faults.py``; the port imports nothing of it.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

SITES = (
    "embedder",
    "store",
    "reranker",
    "llm",
    "microbatch",
    "replica",
    "spec_draft",
)


class FaultInjected(RuntimeError):
    """Synthetic failure raised by an armed fault point."""

    def __init__(self, site: str) -> None:
        super().__init__(f"injected fault at {site!r}")
        self.site = site


@dataclass
class FaultPoint:
    site: str
    error_rate: float = 0.0
    latency_ms: float = 0.0
    remaining: Optional[int] = None  # max injections left; None = unlimited
    index: Optional[int] = None  # replica index filter; None = all replicas
    hits: int = 0  # traversals while armed
    errors: int = 0  # exceptions actually raised
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)


class FaultInjector:
    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._points: Dict[str, FaultPoint] = {}

    def install(
        self,
        site: str,
        *,
        error_rate: float = 0.0,
        latency_ms: float = 0.0,
        count: Optional[int] = None,
        index: Optional[int] = None,
    ) -> FaultPoint:
        """Arm (or re-arm) one fault point."""
        if not 0.0 <= error_rate <= 1.0:
            raise ValueError(f"error_rate must be in [0, 1], got {error_rate}")
        if latency_ms < 0:
            raise ValueError(f"latency_ms must be >= 0, got {latency_ms}")
        point = FaultPoint(
            site=site,
            error_rate=float(error_rate),
            latency_ms=float(latency_ms),
            remaining=count,
            index=index,
        )
        with self._lock:
            self._points[site] = point
        _update_active()
        logger.warning(
            "fault point armed: %s (error_rate=%.2f latency_ms=%.0f)",
            site, error_rate, latency_ms,
        )
        return point

    def configure(self, spec: str) -> None:
        """Parse and install a ``site:key=val,...;site2:...`` spec."""
        for part in (spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                raise ValueError(
                    f"bad fault spec {part!r}: expected 'site:key=value,...'"
                )
            site, _, params = part.partition(":")
            kwargs: dict = {}
            for kv in params.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                key, _, value = kv.partition("=")
                key = key.strip()
                try:
                    num = float(value)
                except ValueError:
                    raise ValueError(
                        f"bad fault spec {part!r}: {value!r} is not a number"
                    ) from None
                if key == "error":
                    kwargs["error_rate"] = num
                elif key == "latency":
                    kwargs["latency_ms"] = num
                elif key == "count":
                    kwargs["count"] = int(num)
                elif key == "index":
                    kwargs["index"] = int(num)
                else:
                    raise ValueError(
                        f"bad fault spec {part!r}: unknown key {key!r} "
                        "(expected error/latency/count/index)"
                    )
            self.install(site.strip(), **kwargs)

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._points.clear()
            else:
                self._points.pop(site, None)
        _update_active()

    def active_sites(self) -> list[str]:
        with self._lock:
            return list(self._points)

    def counts(self) -> Dict[str, dict]:
        with self._lock:
            return {
                s: {"hits": p.hits, "errors": p.errors}
                for s, p in self._points.items()
            }

    def inject(self, site: str) -> None:
        self.inject_indexed(site, None)

    def inject_indexed(self, site: str, idx: Optional[int]) -> None:
        """Like :meth:`inject`, but for per-instance sites: when the
        point was armed with ``index=i``, only instance ``i`` fires."""
        with self._lock:
            point = self._points.get(site)
        if point is None:
            return
        if point.index is not None and idx != point.index:
            return
        with point._lock:
            if point.remaining is not None and point.remaining <= 0:
                return
            point.hits += 1
            fire = (
                point.error_rate > 0.0
                and self._rng.random() < point.error_rate
            )
            if fire:
                point.errors += 1
                if point.remaining is not None:
                    point.remaining -= 1
            latency_s = point.latency_ms / 1000.0
        if latency_s > 0:
            time.sleep(latency_s)
        if fire:
            raise FaultInjected(site)


# -- module-level singleton --------------------------------------------------

# Fast path: production calls inject() on every request; keep the
# no-faults case to one boolean load.
_ACTIVE = False
_SINGLETON_LOCK = threading.Lock()
_SINGLETON: Optional[FaultInjector] = None


def get_fault_injector() -> FaultInjector:
    """Process-wide injector; arms any ``GAIE_FAULTS`` /
    ``resilience.faults`` spec on first use."""
    global _SINGLETON
    with _SINGLETON_LOCK:
        if _SINGLETON is None:
            _SINGLETON = FaultInjector()
            spec = _spec_from_env()
            if spec:
                _SINGLETON.configure(spec)
    return _SINGLETON


def _spec_from_env() -> str:
    import os

    spec = os.environ.get("GAIE_FAULTS", "")
    if spec:
        return spec
    try:
        from generativeaiexamples_tpu_torch.core.configuration import get_config

        return get_config().resilience.faults
    except Exception:
        return ""


def _update_active() -> None:
    global _ACTIVE
    inj = _SINGLETON
    _ACTIVE = bool(inj is not None and inj.active_sites())


def inject(site: str) -> None:
    """Traverse a named fault point (no-op unless faults are armed)."""
    if not _ACTIVE:
        if _SINGLETON is not None:
            return
        # First traversal process-wide: build the singleton so a
        # GAIE_FAULTS / config spec can arm before we fast-path away.
        get_fault_injector()
        if not _ACTIVE:
            return
    get_fault_injector().inject(site)


def inject_replica(idx: int) -> None:
    """Traverse the per-tick ``replica`` fault point for scheduler
    ``idx`` (no-op unless faults are armed — same fast path as
    :func:`inject`, called once per scheduler tick)."""
    if not _ACTIVE:
        if _SINGLETON is not None:
            return
        get_fault_injector()
        if not _ACTIVE:
            return
    get_fault_injector().inject_indexed("replica", idx)


def reset_faults() -> None:
    """Testing hook: disarm everything and forget the singleton (the
    next ``get_fault_injector`` re-reads ``GAIE_FAULTS``)."""
    global _SINGLETON, _ACTIVE
    with _SINGLETON_LOCK:
        _SINGLETON = None
        _ACTIVE = False
