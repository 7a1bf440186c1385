"""Bounded flight recorder for completed request traces.

The postmortem counterpart to the resilience layer: ``GET
/debug/requests`` returns the last-N completed traces so an operator can
answer "where did this request's 300 ms go?" after the fact, without
having had tracing or a bench run enabled.

Two rings: a main ring for every completed request, plus a smaller
*pinned* ring for errors and degraded requests — the traces worth
keeping — so a flood of healthy traffic cannot evict the one trace that
explains an incident.  Capacities come from the ``observability.*``
config section; reset rides ``reset_factories``.

A copy of the JAX package's ``obs/recorder.py``; the port imports nothing of it.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional


class FlightRecorder:
    def __init__(self, capacity: int = 128, pinned_capacity: int = 32) -> None:
        self.capacity = max(1, int(capacity))
        self.pinned_capacity = max(0, int(pinned_capacity))
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=self.capacity)
        self._pinned: deque = deque(maxlen=max(1, self.pinned_capacity))
        self._seq = 0

    def record(self, snapshot: dict) -> None:
        """Store one completed-trace snapshot (``RequestTrace.finish``)."""
        pin = bool(snapshot.get("error") or snapshot.get("degraded"))
        with self._lock:
            self._seq += 1
            entry = dict(snapshot)
            entry["seq"] = self._seq
            if pin and self.pinned_capacity > 0:
                entry["pinned"] = True
                self._pinned.append(entry)
            else:
                self._recent.append(entry)

    def snapshot(self, limit: Optional[int] = None) -> list:
        """Stored traces, newest first (pinned and recent interleaved by
        completion order)."""
        with self._lock:
            merged = list(self._recent) + list(self._pinned)
        merged.sort(key=lambda e: -e["seq"])
        if limit is not None and limit > 0:
            merged = merged[:limit]
        return merged

    def __len__(self) -> int:
        with self._lock:
            return len(self._recent) + len(self._pinned)

    def reset(self) -> None:
        with self._lock:
            self._recent.clear()
            self._pinned.clear()
            self._seq = 0


# Not lru_cached (same reasoning as the factory's cache/batcher state):
# reset must drop the instance so capacity changes in config are honored.
_LOCK = threading.Lock()
_STATE: dict = {"recorder": None}


def get_flight_recorder() -> FlightRecorder:
    """Process-wide recorder, sized from the ``observability.*`` config
    (defaults when config is unavailable)."""
    with _LOCK:
        if _STATE["recorder"] is None:
            capacity, pinned = 128, 32
            try:
                from generativeaiexamples_tpu_torch.core.configuration import get_config

                obs_cfg = get_config().observability
                capacity = obs_cfg.flight_recorder_entries
                pinned = obs_cfg.flight_recorder_pinned
            except Exception:
                pass
            _STATE["recorder"] = FlightRecorder(capacity, pinned)
        return _STATE["recorder"]


def reset_flight_recorder() -> None:
    """Testing hook: drop the singleton (re-sized from config next use)."""
    with _LOCK:
        _STATE["recorder"] = None
