"""Priority-class admission control: deliberate overload shedding.

Under overload every request the process accepts makes every other
request slower; the only real defense is refusing work *early*, and
refusing the *right* work.  This module classifies each API request into
a traffic class — ``interactive`` (user-facing queries), ``batch``
(offline evaluation / replays), ``ingest`` (document uploads) — and
applies three gates, cheapest first:

1. **Token-bucket quota** per class (``rates``): a class that exceeds
   its configured request rate is shed regardless of load, so a runaway
   batch job cannot starve the pool even when capacity is free.
2. **Weighted concurrency share** (``weights`` × ``max_inflight``): a
   class may hold up to (its weight + all lower-priority weights) /
   total of the inflight budget.  Interactive's cap is therefore the
   whole budget, while ingest is confined to its own slice — under
   pressure the lowest class always sheds first, and interactive
   displaces batch/ingest but never the reverse.
3. **Deadline-aware shed**: when the caller's remaining deadline is
   smaller than the estimated queue wait (class EWMA service time ×
   queue position / ``parallel_hint``), the request is refused *now*
   with a 429 instead of burning a worker slot to produce a doomed 504.

Every decision is counted (``rag_admission_{admitted,shed}_total``),
shed events feed the fleet TSDB (``admission.shed.<class>``) for the
``/debug/timeseries`` postmortems, and per-class shedding onset/resolve
transitions are pinned into the flight recorder alongside the SLO and
autoscaler records.

With the default config (no rates, ``max_inflight=0``) the controller
only classifies and counts — shedding is opt-in, so existing
deployments see new telemetry and zero behavior change.

A copy of the JAX package's ``resilience/admission.py`` (pure Python),
with one addition: the clock is injectable (``clock``), so two
controllers can be held to the same decisions on one sequence of events.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

# Highest to lowest priority; shedding walks this list from the END.
CLASSES: Tuple[str, ...] = ("interactive", "batch", "ingest")

# A shedding episode "resolves" only after this long without a shed:
# under a sustained burst a token bucket admits and refuses in quick
# alternation, and without hysteresis every admitted request would pin a
# fresh resolved/shedding transition pair into the flight recorder.
_RESOLVE_AFTER_S = 10.0


def _parse_pairs(raw: str) -> Dict[str, float]:
    """'a=1,b=2' → {'a': 1.0, 'b': 2.0}; unknown classes are ignored."""
    out: Dict[str, float] = {}
    for chunk in (raw or "").split(","):
        chunk = chunk.strip()
        if not chunk or "=" not in chunk:
            continue
        key, _, value = chunk.partition("=")
        key = key.strip().lower()
        if key not in CLASSES:
            continue
        try:
            out[key] = float(value)
        except ValueError:
            logger.warning("bad admission pair %r ignored", chunk)
    return out


class _TokenBucket:
    """Classic token bucket; refilled lazily from elapsed time."""

    __slots__ = ("rate", "capacity", "tokens", "stamp")

    def __init__(self, rate: float, capacity: float) -> None:
        self.rate = float(rate)
        self.capacity = max(1.0, float(capacity))
        self.tokens = self.capacity
        self.stamp = 0.0

    def take(self, now: float) -> bool:
        if self.stamp:
            self.tokens = min(
                self.capacity, self.tokens + (now - self.stamp) * self.rate
            )
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def wait_s(self) -> float:
        """Seconds until the next token exists (for Retry-After)."""
        if self.rate <= 0:
            return 1.0
        return max(0.0, (1.0 - self.tokens) / self.rate)


class Decision:
    """Outcome of one admission check."""

    __slots__ = ("admitted", "cls", "reason", "retry_after_s")

    def __init__(
        self,
        admitted: bool,
        cls: str,
        reason: str = "",
        retry_after_s: float = 0.0,
    ) -> None:
        self.admitted = admitted
        self.cls = cls
        self.reason = reason
        self.retry_after_s = retry_after_s


class AdmissionController:
    """Classify, quota, share-gate and deadline-shed API requests."""

    def __init__(
        self, cfg=None, *, recorder=None, tsdb=None, clock: Callable[[], float] = time.time
    ) -> None:
        if cfg is None:
            from generativeaiexamples_tpu_torch.core.configuration import get_config

            cfg = get_config().admission
        self.cfg = cfg
        self.enabled = bool(cfg.enabled)
        self.header = str(cfg.header)
        default = str(cfg.default_class).strip().lower()
        self.default_class = default if default in CLASSES else "interactive"
        self.max_inflight = max(0, int(cfg.max_inflight))
        self.parallel_hint = max(1, int(cfg.parallel_hint))
        self.retry_after_max_s = max(1.0, float(cfg.retry_after_max_s))
        weights = _parse_pairs(cfg.weights)
        total = sum(weights.get(c, 0.0) for c in CLASSES) or 1.0
        # A class's cap folds in every lower-priority weight: interactive
        # reaches 100% of the budget, ingest only its own slice, which is
        # exactly "shed the lowest class first".
        self._share: Dict[str, float] = {}
        for i, cls in enumerate(CLASSES):
            cumulative = sum(weights.get(c, 0.0) for c in CLASSES[i:])
            self._share[cls] = cumulative / total
        burst_s = max(0.0, float(cfg.burst_s))
        self._buckets: Dict[str, _TokenBucket] = {}
        for cls, rate in _parse_pairs(cfg.rates).items():
            if rate > 0:
                self._buckets[cls] = _TokenBucket(rate, rate * burst_s)
        self._recorder = recorder
        self._tsdb = tsdb
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {c: 0 for c in CLASSES}
        self._ewma_ms: Dict[str, float] = {c: 0.0 for c in CLASSES}
        self.admitted_total: Dict[str, int] = {c: 0 for c in CLASSES}
        self.shed_total: Dict[str, int] = {c: 0 for c in CLASSES}
        self._shedding: Dict[str, bool] = {c: False for c in CLASSES}
        self._last_shed_ts: Dict[str, float] = {c: 0.0 for c in CLASSES}

    # -- wiring -----------------------------------------------------------
    def _record_transition(self, entry: dict) -> None:
        recorder = self._recorder
        if recorder is None:
            from generativeaiexamples_tpu_torch.obs.recorder import (
                get_flight_recorder,
            )

            recorder = get_flight_recorder()
        recorder.record(entry)

    def _feed_tsdb(self, cls: str, now: float) -> None:
        tsdb = self._tsdb
        if tsdb is None:
            from generativeaiexamples_tpu_torch.obs.tsdb import get_tsdb

            tsdb = get_tsdb()
        tsdb.record(f"admission.shed.{cls}", 1.0, kind="counter", ts=now)

    # -- classification ---------------------------------------------------
    def classify(self, headers, default: Optional[str] = None) -> str:
        """Traffic class from the request header, else the route default,
        else the configured default.  Unknown values are treated as
        absent, not as errors — a typo must not change priority."""
        raw = ""
        if headers is not None:
            try:
                raw = headers.get(self.header) or headers.get(
                    self.header.lower()
                ) or ""
            except Exception:
                raw = ""
        raw = raw.strip().lower()
        if raw in CLASSES:
            return raw
        if default in CLASSES:
            return default
        return self.default_class

    # -- the gate ---------------------------------------------------------
    def try_admit(
        self,
        cls: str,
        *,
        deadline_ms: Optional[float] = None,
        now: Optional[float] = None,
        route: str = "",
    ) -> Decision:
        if cls not in CLASSES:
            cls = self.default_class
        if not self.enabled:
            return Decision(True, cls)
        now = self._clock() if now is None else now
        with self._lock:
            bucket = self._buckets.get(cls)
            if bucket is not None and not bucket.take(now):
                return self._shed_locked(
                    cls, "quota", bucket.wait_s(), now, route
                )
            if self.max_inflight > 0:
                cap = self._share[cls] * self.max_inflight
                total_inflight = sum(self._inflight.values())
                if (
                    total_inflight >= self.max_inflight
                    or self._inflight[cls] + 1 > cap
                ):
                    # Rough drain-time hint: one service interval of the
                    # class's own EWMA (floor 1 s keeps retries honest).
                    wait = max(1.0, self._ewma_ms[cls] / 1000.0)
                    return self._shed_locked(cls, "share", wait, now, route)
            if deadline_ms is not None and deadline_ms >= 0:
                est_wait_ms = self._est_wait_ms_locked(cls)
                if est_wait_ms > deadline_ms:
                    return self._shed_locked(
                        cls, "deadline", est_wait_ms / 1000.0, now, route
                    )
            self._inflight[cls] += 1
            self.admitted_total[cls] += 1
            resolved = (
                self._shedding[cls]
                and now - self._last_shed_ts[cls] >= _RESOLVE_AFTER_S
            )
            if resolved:
                self._shedding[cls] = False
        if resolved:
            self._note_shed_state(cls, "resolved", "", now)
        return Decision(True, cls)

    def _est_wait_ms_locked(self, cls: str) -> float:
        """Estimated queueing delay before this request runs: EWMA
        service time × how many of the already-admitted requests stand
        between it and a free worker slot."""
        ewma = self._ewma_ms[cls] or 50.0
        inflight = sum(self._inflight.values())
        ahead = max(0, inflight - self.parallel_hint + 1)
        return ewma * ahead / self.parallel_hint

    def _shed_locked(
        self, cls: str, reason: str, wait_s: float, now: float, route: str
    ) -> Decision:
        self.shed_total[cls] += 1
        onset = not self._shedding[cls]
        self._shedding[cls] = True
        self._last_shed_ts[cls] = now
        retry_after = min(self.retry_after_max_s, max(1.0, wait_s))
        # Telemetry outside would be nicer but both sinks are append-only
        # and cheap; keeping them here keeps the counters and the pinned
        # transition consistent with shed_total.
        self._feed_tsdb(cls, now)
        if onset:
            self._note_shed_state(cls, "shedding", reason, now, route)
        return Decision(False, cls, reason, retry_after)

    def _note_shed_state(
        self, cls: str, state: str, reason: str, now: float, route: str = ""
    ) -> None:
        self._record_transition(
            {
                "request_id": f"admission-{cls}",
                "route": route or "admission",
                "status": None,
                "error": None,
                "degraded": [f"admission:{cls}:{state}"],
                "total_ms": 0.0,
                "started_at": now,
                "stages": [],
                "attrs": {
                    "admission_class": cls,
                    "state": state,
                    **({"reason": reason} if reason else {}),
                    "shed_total": self.shed_total[cls],
                },
            }
        )
        logger.info("admission %s: class=%s %s", state, cls, reason)

    def release(
        self, cls: str, duration_ms: Optional[float] = None
    ) -> None:
        """Pair of a successful :meth:`try_admit`; feeds the service-time
        EWMA the deadline shedder runs on."""
        if cls not in CLASSES or not self.enabled:
            return
        with self._lock:
            if self._inflight[cls] > 0:
                self._inflight[cls] -= 1
            if duration_ms is not None and duration_ms >= 0:
                self._ewma_ms[cls] += 0.2 * (duration_ms - self._ewma_ms[cls])

    # -- introspection ----------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "inflight": dict(self._inflight),
                "admitted_total": dict(self.admitted_total),
                "shed_total": dict(self.shed_total),
                "shedding": dict(self._shedding),
                "ewma_ms": {
                    c: round(v, 2) for c, v in self._ewma_ms.items()
                },
            }


_STATE: Dict[str, Optional[AdmissionController]] = {"controller": None}
_STATE_LOCK = threading.Lock()


def get_admission_controller() -> AdmissionController:
    ctrl = _STATE["controller"]
    if ctrl is None:
        with _STATE_LOCK:
            ctrl = _STATE["controller"]
            if ctrl is None:
                ctrl = AdmissionController()
                _STATE["controller"] = ctrl
    return ctrl


def reset_admission() -> None:
    """Testing hook (joined into reset_resilience)."""
    with _STATE_LOCK:
        _STATE["controller"] = None


def admission_metrics_lines() -> List[str]:
    """Per-class admitted/shed counters, exported from zero for every
    class so dashboards and alerts never miss a series."""
    ctrl = get_admission_controller()
    snap = ctrl.snapshot()
    lines = [
        "# HELP rag_admission_admitted_total API requests admitted, per "
        "traffic class.",
        "# TYPE rag_admission_admitted_total counter",
    ]
    for cls in CLASSES:
        lines.append(
            f'rag_admission_admitted_total{{class="{cls}"}} '
            f'{snap["admitted_total"].get(cls, 0)}'
        )
    lines += [
        "# HELP rag_admission_shed_total API requests refused (429) by "
        "the admission controller, per traffic class.",
        "# TYPE rag_admission_shed_total counter",
    ]
    for cls in CLASSES:
        lines.append(
            f'rag_admission_shed_total{{class="{cls}"}} '
            f'{snap["shed_total"].get(cls, 0)}'
        )
    return lines
