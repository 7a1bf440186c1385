"""Fixed-memory in-process time-series store for fleet telemetry.

Monarch-style (Adya et al., VLDB 2020) in-memory rings: every series keeps
two fixed-size bucket rings — a fine ring (1 s steps, 15 min of history)
that serves the short SLO windows and live dashboards, and a coarse ring
(60 s steps, 12 h) that serves the long burn-rate windows.  Memory is fixed
at construction; old buckets are overwritten in place.

Hot-path discipline mirrors ``obs.trace.RequestTrace``: ``record()`` is a
single ``list.append`` of a raw ``(ts, value)`` tuple (atomic under the
GIL); folding pending points into the rings happens at read time, or
inline-amortized when the pending list crosses a bound so an unscraped
process cannot grow without limit.

A copy of the JAX package's ``obs/tsdb.py`` (pure Python).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Pending appends are folded on read; this bound keeps an unscraped
# process at fixed memory (fold cost amortizes to O(1) per record).
_FLUSH_PENDING = 2048

# (step seconds, bucket count) per tier.  Fine serves windows up to
# ~15 min, coarse up to 12 h — enough for the 6 h slow burn window.
FINE_STEP_S = 1.0
FINE_BUCKETS = 900
COARSE_STEP_S = 60.0
COARSE_BUCKETS = 720


class _Ring:
    """One downsampling tier: ``capacity`` buckets of ``step`` seconds.

    Each bucket aggregates every point that landed in its step:
    (bucket_start_ts, count, sum, min, max).  Stored as parallel lists so
    the footprint is fixed and folds are in-place.
    """

    __slots__ = ("step", "capacity", "ts", "count", "sum", "min", "max")

    def __init__(self, step: float, capacity: int) -> None:
        self.step = float(step)
        self.capacity = int(capacity)
        self.ts = [0.0] * capacity
        self.count = [0] * capacity
        self.sum = [0.0] * capacity
        self.min = [0.0] * capacity
        self.max = [0.0] * capacity

    def fold(self, ts: float, value: float) -> None:
        bucket_ts = ts - (ts % self.step)
        idx = int(ts // self.step) % self.capacity
        if self.ts[idx] != bucket_ts:
            # Ring wrapped (or first use): the slot belongs to a dead
            # window — restart it for the new bucket.
            self.ts[idx] = bucket_ts
            self.count[idx] = 0
            self.sum[idx] = 0.0
            self.min[idx] = value
            self.max[idx] = value
        self.count[idx] += 1
        self.sum[idx] += value
        if value < self.min[idx]:
            self.min[idx] = value
        if value > self.max[idx]:
            self.max[idx] = value

    def window(self, now: float, window_s: float) -> Tuple[int, float]:
        """(count, sum) across buckets newer than ``now - window_s``."""
        horizon = now - window_s
        total = 0
        acc = 0.0
        live_floor = now - self.step * self.capacity
        for i in range(self.capacity):
            t = self.ts[i]
            if t >= horizon and t > live_floor and self.count[i]:
                total += self.count[i]
                acc += self.sum[i]
        return total, acc

    def points(self, now: float, window_s: float) -> List[List[float]]:
        horizon = now - window_s
        live_floor = now - self.step * self.capacity
        out = []
        for i in range(self.capacity):
            t = self.ts[i]
            if t >= horizon and t > live_floor and self.count[i]:
                out.append(
                    [
                        round(t, 3),
                        self.count[i],
                        round(self.sum[i], 6),
                        round(self.min[i], 6),
                        round(self.max[i], 6),
                    ]
                )
        out.sort(key=lambda p: p[0])
        return out


class Series:
    """One named series: lock-free pending appends + two bucket rings."""

    __slots__ = ("name", "kind", "_lock", "_pending", "_fine", "_coarse")

    def __init__(
        self,
        name: str,
        kind: str = "gauge",
        *,
        fine_step: float = FINE_STEP_S,
        fine_buckets: int = FINE_BUCKETS,
        coarse_step: float = COARSE_STEP_S,
        coarse_buckets: int = COARSE_BUCKETS,
    ) -> None:
        self.name = name
        self.kind = kind  # "gauge" (levels) or "counter" (per-event increments)
        self._lock = threading.Lock()
        self._pending: List[Tuple[float, float]] = []
        self._fine = _Ring(fine_step, fine_buckets)
        self._coarse = _Ring(coarse_step, coarse_buckets)

    # -- hot path ---------------------------------------------------------
    def record(self, value: float, ts: Optional[float] = None) -> None:
        self._pending.append((ts if ts is not None else time.time(), float(value)))
        if len(self._pending) >= _FLUSH_PENDING:
            self._drain()

    # -- read side --------------------------------------------------------
    def _drain(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
            for ts, value in pending:
                self._fine.fold(ts, value)
                self._coarse.fold(ts, value)

    def _ring_for(self, window_s: float) -> _Ring:
        if window_s <= self._fine.step * self._fine.capacity:
            return self._fine
        return self._coarse

    def window_stats(
        self, window_s: float, now: Optional[float] = None
    ) -> Tuple[int, float]:
        """(count, sum) over the trailing window, from the tightest ring
        that still covers it."""
        self._drain()
        now = time.time() if now is None else now
        with self._lock:
            return self._ring_for(window_s).window(now, window_s)

    def points(
        self, window_s: float, now: Optional[float] = None
    ) -> List[List[float]]:
        """[[bucket_ts, count, sum, min, max], ...] oldest-first."""
        self._drain()
        now = time.time() if now is None else now
        with self._lock:
            return self._ring_for(window_s).points(now, window_s)


class Tsdb:
    """Registry of named series with get-or-create semantics."""

    def __init__(
        self,
        *,
        fine_step: float = FINE_STEP_S,
        fine_buckets: int = FINE_BUCKETS,
        coarse_step: float = COARSE_STEP_S,
        coarse_buckets: int = COARSE_BUCKETS,
        max_series: int = 512,
    ) -> None:
        self._lock = threading.Lock()
        self._series: Dict[str, Series] = {}
        self._fine_step = fine_step
        self._fine_buckets = fine_buckets
        self._coarse_step = coarse_step
        self._coarse_buckets = coarse_buckets
        self._max_series = max_series

    def series(self, name: str, kind: str = "gauge") -> Series:
        s = self._series.get(name)
        if s is not None:
            return s
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if len(self._series) >= self._max_series:
                    # Cardinality guard, same spirit as the /metrics label
                    # fold: unseen names collapse into one overflow series.
                    name = "other"
                    s = self._series.get(name)
                    if s is not None:
                        return s
                s = Series(
                    name,
                    kind,
                    fine_step=self._fine_step,
                    fine_buckets=self._fine_buckets,
                    coarse_step=self._coarse_step,
                    coarse_buckets=self._coarse_buckets,
                )
                self._series[name] = s
            return s

    def record(
        self,
        name: str,
        value: float,
        *,
        kind: str = "gauge",
        ts: Optional[float] = None,
    ) -> None:
        self.series(name, kind).record(value, ts)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def drop_series(self, prefix: str) -> int:
        """Delete every series whose name starts with ``prefix``.

        Used when a pool replica detaches: its ``engine.replica.<idx>.*``
        gauges would otherwise survive forever (and pin ring memory) for
        an index that can be reused by a later scale-up.  Returns the
        number of series dropped."""
        if not prefix:
            return 0
        with self._lock:
            victims = [n for n in self._series if n.startswith(prefix)]
            for name in victims:
                del self._series[name]
        return len(victims)

    def window_stats(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> Tuple[int, float]:
        s = self._series.get(name)
        if s is None:
            return 0, 0.0
        return s.window_stats(window_s, now)

    def query(
        self,
        window_s: float,
        names: Optional[Sequence[str]] = None,
        now: Optional[float] = None,
    ) -> Dict[str, object]:
        """Payload for ``GET /debug/timeseries``.

        ``names`` filters by exact name or prefix (trailing ``*``); when
        omitted, every known series is returned.
        """
        if names:
            selected = []
            with self._lock:
                known = list(self._series)
            for pat in names:
                if pat.endswith("*"):
                    selected.extend(n for n in known if n.startswith(pat[:-1]))
                elif pat in known:
                    selected.append(pat)
            selected = sorted(set(selected))
        else:
            selected = self.names()
        out: Dict[str, object] = {
            "window_s": window_s,
            "columns": ["ts", "count", "sum", "min", "max"],
            "series": {},
        }
        for name in selected:
            s = self._series.get(name)
            if s is None:
                continue
            out["series"][name] = {
                "kind": s.kind,
                "points": s.points(window_s, now),
            }
        return out


def parse_window(raw: str, default_s: float = 300.0) -> float:
    """Parse ``?window=`` values: plain seconds or ``30s``/``5m``/``2h``."""
    raw = (raw or "").strip().lower()
    if not raw:
        return default_s
    mult = 1.0
    if raw.endswith("ms"):
        mult, raw = 0.001, raw[:-2]
    elif raw.endswith("s"):
        raw = raw[:-1]
    elif raw.endswith("m"):
        mult, raw = 60.0, raw[:-1]
    elif raw.endswith("h"):
        mult, raw = 3600.0, raw[:-1]
    try:
        value = float(raw) * mult
    except ValueError as exc:
        raise ValueError(f"bad window {raw!r}") from exc
    if value <= 0:
        raise ValueError("window must be positive")
    return value


_STATE: Dict[str, Optional[Tsdb]] = {"tsdb": None}
_STATE_LOCK = threading.Lock()


def get_tsdb() -> Tsdb:
    tsdb = _STATE["tsdb"]
    if tsdb is None:
        with _STATE_LOCK:
            tsdb = _STATE["tsdb"]
            if tsdb is None:
                tsdb = Tsdb()
                _STATE["tsdb"] = tsdb
    return tsdb


def reset_tsdb() -> None:
    """Testing hook (pairs with reset_obs)."""
    with _STATE_LOCK:
        _STATE["tsdb"] = None
