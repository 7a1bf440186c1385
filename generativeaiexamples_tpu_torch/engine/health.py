"""Gray-failure tolerance for the replica pool (port of ``engine/health.py``).

The pool's binary monitor (``EnginePool.check_replicas``) catches dead
tick threads and hard stalls; it cannot see a replica that is merely slow.
This module is the continuous side:

- :class:`ReplicaScorer` turns the per-replica TSDB series the pool feeds
  (``engine.replica.<i>.tick_ms`` / ``.queued`` / ``.ttft_ms``) into a 0-1
  brownout score per replica.  Scores are relative to the median of the
  replica's peers, so a uniformly slow fleet (overload, a slow shared
  dependency) scores ~1.0 everywhere and nothing is ejected: that is the
  autoscaler's failure mode, not the ejector's.
- :class:`HedgeController`: the hedged-request policy, a token bucket that
  caps hedges to a fraction of eligible traffic, and an asymmetric EWMA
  of eligible requests' upper-tail latency that sets the hedge delay
  (hedge after the p95, cap the extra load at a few percent).
- :class:`HedgeTimerWheel`: one timing thread for every hedge deadline.
- :func:`gray_metrics_lines`: the layer's ``/metrics`` families, exported
  from zero.

The pool owns the eject / probation / re-admit state machine
(``engine/replica.py``); nothing here locks against it, so it can be
tested over a hand-fed :class:`~generativeaiexamples_tpu_torch.obs.tsdb.Tsdb`.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, Iterable, List, Optional

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.obs.tsdb import Tsdb, get_tsdb

logger = get_logger(__name__)

_EPS = 1e-6


def _median(values: List[float]) -> float:
    vals = sorted(values)
    n = len(vals)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2:
        return vals[mid]
    return (vals[mid - 1] + vals[mid]) / 2.0


def _decay(ratio: float, tolerance: float) -> float:
    """1.0 inside the tolerance band, quadratic falloff beyond it: at
    ``tolerance`` x the peers the score is 1.0, at twice that 0.25."""
    excess = ratio / max(tolerance, _EPS)
    if excess <= 1.0:
        return 1.0
    return 1.0 / (excess * excess)


class ReplicaScorer:
    """Relative brownout scores from the pool's per-replica TSDB series.

    ``score_all`` reads a sliding window of the gauges the pool's monitor
    records each pass and returns a smoothed 0-1 score per replica.  A
    replica without data (just added) scores 1.0.
    """

    def __init__(self, cfg, tsdb: Optional[Tsdb] = None) -> None:
        self.cfg = cfg
        self._tsdb = tsdb
        self._smoothed: Dict[int, float] = {}

    @property
    def tsdb(self) -> Tsdb:
        if self._tsdb is None:
            self._tsdb = get_tsdb()
        return self._tsdb

    def _window_mean(self, name: str, now: Optional[float]) -> Optional[float]:
        count, total = self.tsdb.window_stats(name, self.cfg.window_s, now)
        if count <= 0:
            return None
        return total / count

    def score_all(self, indices: Iterable[int], now: Optional[float] = None) -> Dict[int, float]:
        indices = list(indices)
        if not self.cfg.enabled:
            return {i: 1.0 for i in indices}
        ticks: Dict[int, Optional[float]] = {}
        queues: Dict[int, Optional[float]] = {}
        ttfts: Dict[int, Optional[float]] = {}
        for i in indices:
            prefix = f"engine.replica.{i}."
            ticks[i] = self._window_mean(prefix + "tick_ms", now)
            queues[i] = self._window_mean(prefix + "queued", now)
            ttfts[i] = self._window_mean(prefix + "ttft_ms", now)
        tol = self.cfg.tick_tolerance
        alpha = min(max(self.cfg.score_smoothing, 0.0), 1.0)
        out: Dict[int, float] = {}
        for i in indices:
            components: List[float] = []
            # Tick latency and TTFT against the median of the *other*
            # replicas: a 2-replica pool separates cleanly, and correlated
            # slowness gives ratios near 1.
            for signals in (ticks, ttfts):
                mine = signals[i]
                others = [v for j, v in signals.items() if j != i and v is not None]
                if mine is None or not others:
                    continue
                components.append(_decay(mine / max(_median(others), _EPS), tol))
            mine_q = queues[i]
            others_q = [v for j, v in queues.items() if j != i and v is not None]
            if mine_q is not None and others_q:
                # +1 slack: queues of 0 and 1 are not a 2x imbalance.
                components.append(_decay((mine_q + 1.0) / (_median(others_q) + 1.0), tol))
            raw = min(components) if components else 1.0
            prev = self._smoothed.get(i, 1.0)
            smoothed = prev + alpha * (raw - prev)
            self._smoothed[i] = smoothed
            out[i] = smoothed
        return out

    def drop(self, idx: int) -> None:
        self._smoothed.pop(idx, None)


class HedgeController:
    """Budget and trigger delay of hedged requests.

    Token bucket: every eligible submit deposits ``hedge_budget_ratio``
    tokens (capped at ``hedge_burst``); a hedge spends one, so the long-run
    hedge rate never passes the ratio however slow the pool gets.  Delay:
    an asymmetric EWMA chases eligible requests' upper-tail latency (fast
    rise above the estimate, slow decay below: a cheap streaming p95),
    floored at ``hedge_min_delay_ms``.
    """

    #: Samples before any hedge may fire: a p95 estimated from nothing is
    #: the floor, which would hedge the first slightly slow request.
    WARMUP_SAMPLES = 10

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self._lock = threading.Lock()
        self._tokens = float(cfg.hedge_burst)
        self._p95_ms = float(cfg.hedge_min_delay_ms)
        self._samples = 0
        self.fired_total = 0
        self.wins_total = 0
        self.cancelled_total = 0
        self.suppressed_total = 0
        self.eligible_total = 0

    @property
    def enabled(self) -> bool:
        return bool(self.cfg.enabled and self.cfg.hedge_enabled)

    @property
    def ready(self) -> bool:
        """True once the delay estimator has enough samples to trust."""
        with self._lock:
            return self._samples >= self.WARMUP_SAMPLES

    def note_submit(self) -> None:
        """An eligible request was submitted: top up the budget."""
        with self._lock:
            self.eligible_total += 1
            self._tokens = min(float(self.cfg.hedge_burst), self._tokens + float(self.cfg.hedge_budget_ratio))

    def try_spend(self) -> bool:
        """Spend one hedge token; a failure counts a suppression."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            self.suppressed_total += 1
            return False

    def note_fired(self) -> None:
        with self._lock:
            self.fired_total += 1

    def note_win(self) -> None:
        with self._lock:
            self.wins_total += 1

    def note_cancelled(self) -> None:
        with self._lock:
            self.cancelled_total += 1

    def note_latency(self, ms: float) -> None:
        with self._lock:
            self._samples += 1
            if ms > self._p95_ms:
                self._p95_ms += 0.10 * (ms - self._p95_ms)
            else:
                self._p95_ms += 0.005 * (ms - self._p95_ms)

    def delay_ms(self) -> float:
        with self._lock:
            return max(self._p95_ms, float(self.cfg.hedge_min_delay_ms))

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "hedge_eligible_total": self.eligible_total,
                "hedge_fired_total": self.fired_total,
                "hedge_wins_total": self.wins_total,
                "hedge_cancelled_total": self.cancelled_total,
                "hedge_suppressed_total": self.suppressed_total,
                "hedge_delay_ms": round(max(self._p95_ms, float(self.cfg.hedge_min_delay_ms)), 3),
            }


class _WheelHandle:
    """A cancellable deadline (``cancel()`` as on ``threading.Timer``)."""

    __slots__ = ("cancelled",)

    def __init__(self) -> None:
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class HedgeTimerWheel:
    """One shared timing thread for every hedge deadline.

    A ``threading.Timer`` per request would spawn a thread per arm, the
    clean path's cost of hedging; here arming is a heap push and a notify.
    Callbacks run on one daemon thread, started at the first arm.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._heap: list = []
        self._seq = 0  # FIFO tiebreak: handles do not order
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def arm(self, delay_s: float, fn, arg) -> _WheelHandle:
        handle = _WheelHandle()
        deadline = time.monotonic() + max(delay_s, 0.0)
        with self._cond:
            if not self._running:
                self._running = True
                self._thread = threading.Thread(target=self._loop, daemon=True)
                self._thread.start()
            self._seq += 1
            heapq.heappush(self._heap, (deadline, self._seq, handle, fn, arg))
            self._cond.notify()
        return handle

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._heap.clear()
            self._cond.notify()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._cond:
                if not self._running:
                    return
                if not self._heap:
                    self._cond.wait(timeout=1.0)
                    continue
                deadline, _, handle, fn, arg = self._heap[0]
                wait = deadline - time.monotonic()
                if wait > 0:
                    self._cond.wait(timeout=min(wait, 1.0))
                    continue
                heapq.heappop(self._heap)
            # Outside the condition: the callback takes the pool lock.
            if not handle.cancelled:
                try:
                    fn(arg)
                except Exception:
                    logger.exception("hedge deadline callback failed")


def gray_metrics_lines(engine=None) -> List[str]:
    """Prometheus lines of the gray-failure layer, from zero.

    ``engine`` is duck-typed (an ``EnginePool``, or anything with its
    accessors); every family is emitted without one, so dashboards and
    alerts can exist before the first brownout.
    """
    from generativeaiexamples_tpu_torch.obs.metrics import _fmt

    hedger = getattr(engine, "hedger", None)
    hsnap = hedger.snapshot() if hedger is not None else {}
    ejections = getattr(engine, "ejections_total", 0)
    readmissions = getattr(engine, "readmissions_total", 0)
    ejected_fn = getattr(engine, "ejected_count", None)
    ejected = ejected_fn() if callable(ejected_fn) else 0
    lines = [
        "# HELP rag_hedge_requests_total Hedged request copies fired.",
        "# TYPE rag_hedge_requests_total counter",
        f"rag_hedge_requests_total {int(hsnap.get('hedge_fired_total', 0))}",
        "# HELP rag_hedge_wins_total Hedges that beat the primary copy.",
        "# TYPE rag_hedge_wins_total counter",
        f"rag_hedge_wins_total {int(hsnap.get('hedge_wins_total', 0))}",
        "# HELP rag_hedge_cancelled_total Losing request copies cancelled after first response.",
        "# TYPE rag_hedge_cancelled_total counter",
        f"rag_hedge_cancelled_total {int(hsnap.get('hedge_cancelled_total', 0))}",
        "# HELP rag_hedge_suppressed_total Hedges withheld by the token-bucket budget.",
        "# TYPE rag_hedge_suppressed_total counter",
        f"rag_hedge_suppressed_total {int(hsnap.get('hedge_suppressed_total', 0))}",
        "# HELP engine_replica_ejections_total Replicas quarantined for sustained brownout scores.",
        "# TYPE engine_replica_ejections_total counter",
        f"engine_replica_ejections_total {int(ejections)}",
        "# HELP engine_replica_readmissions_total Ejected replicas re-admitted through probation.",
        "# TYPE engine_replica_readmissions_total counter",
        f"engine_replica_readmissions_total {int(readmissions)}",
        "# HELP engine_pool_ejected_replicas Replicas currently quarantined.",
        "# TYPE engine_pool_ejected_replicas gauge",
        f"engine_pool_ejected_replicas {int(ejected)}",
        "# HELP engine_replica_score Continuous 0-1 brownout score per replica (1 = healthy).",
        "# TYPE engine_replica_score gauge",
    ]
    scores_fn = getattr(engine, "replica_scores", None)
    if callable(scores_fn):
        for idx, score in sorted(scores_fn().items()):
            lines.append(f'engine_replica_score{{replica="{idx}"}} {_fmt(round(score, 4))}')
    return lines
