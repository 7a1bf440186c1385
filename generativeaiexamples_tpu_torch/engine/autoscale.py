"""SLO-driven autoscaler for the replica pool (port of ``engine/autoscale.py``).

Every ``interval_s`` the controller reads the trailing ``window_s`` of
``engine.queued`` and ``engine.tick_ms`` from the fleet TSDB and the SLO
engine's fast-burn verdict, computes a desired replica count and drives
``pool.scale_to``:

* **up** when the mean queue per healthy replica reaches ``queue_high``,
  the mean tick time reaches ``tick_high_ms`` (when set), or the SLO
  fast-burn page fires: one replica a decision, ``up_cooldown_s`` apart;
* **down** when the queue per replica stays at or under ``queue_low`` for
  ``down_checks`` decisions in a row and nothing burns, ``down_cooldown_s``
  apart (a scale-up restarts that clock too, so the pool never flaps).

The band between ``queue_low`` and ``queue_high`` is the hysteresis.
Every action is pinned into the flight recorder (``/debug/requests``
shows why capacity changed) and counted in the TSDB
(``autoscale.scale_events``).  The pool is duck-typed (``pool_size()``,
``scale_to(n)``, ``desired_replicas``), so the chain server borrows
:func:`pool_metrics_lines` without the engine's imports.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)


class Autoscaler:
    """Replica-count control loop over a duck-typed ``EnginePool``."""

    def __init__(self, pool, cfg=None, *, tsdb=None, slo=None, recorder=None) -> None:
        if cfg is None:
            from generativeaiexamples_tpu_torch.core.configuration import get_config

            cfg = get_config().autoscale
        self.pool = pool
        self.cfg = cfg
        self.min_replicas = max(1, int(cfg.min_replicas))
        self.max_replicas = max(self.min_replicas, int(cfg.max_replicas))
        self.interval_s = float(cfg.interval_s)
        self.window_s = float(cfg.window_s)
        self.queue_high = float(cfg.queue_high)
        self.queue_low = float(cfg.queue_low)
        self.tick_high_ms = float(cfg.tick_high_ms)
        self.scale_on_fast_burn = bool(cfg.scale_on_fast_burn)
        self.down_checks = max(1, int(cfg.down_checks))
        self.up_cooldown_s = float(cfg.up_cooldown_s)
        self.down_cooldown_s = float(cfg.down_cooldown_s)
        self._tsdb = tsdb
        self._slo = slo
        self._recorder = recorder
        self._lock = threading.Lock()
        self._last_up = 0.0
        self._last_down = 0.0
        self._down_streak = 0
        self.scale_ups_total = 0
        self.scale_downs_total = 0
        self.last_decision: dict = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- wiring -----------------------------------------------------------
    @property
    def tsdb(self):
        if self._tsdb is not None:
            return self._tsdb
        from generativeaiexamples_tpu_torch.obs.tsdb import get_tsdb

        return get_tsdb()

    @property
    def slo(self):
        if self._slo is not None:
            return self._slo
        from generativeaiexamples_tpu_torch.obs.slo import get_slo_engine

        return get_slo_engine()

    def _record_transition(self, entry: dict) -> None:
        recorder = self._recorder
        if recorder is None:
            from generativeaiexamples_tpu_torch.obs.recorder import get_flight_recorder

            recorder = get_flight_recorder()
        recorder.record(entry)

    # -- decision ---------------------------------------------------------
    def signals(self, now: Optional[float] = None) -> dict:
        """The raw control inputs of one decision."""
        now = time.time() if now is None else now
        db = self.tsdb
        size = max(1, self.pool.pool_size())
        qcount, qsum = db.window_stats("engine.queued", self.window_s, now)
        queue_mean = qsum / qcount if qcount else 0.0
        tcount, tsum = db.window_stats("engine.tick_ms", self.window_s, now)
        tick_mean = tsum / tcount if tcount else 0.0
        fast_burn = False
        try:
            fast_burn = bool(self.slo.evaluate(now).get("fast_burn_firing", False))
        except Exception:
            logger.exception("autoscaler SLO read failed")
        return {"size": size, "queue_per_replica": queue_mean / size, "tick_ms": tick_mean, "fast_burn": fast_burn}

    def desired(self, now: Optional[float] = None) -> tuple[int, dict]:
        """(target replica count, signals): the decision alone, without
        cooldowns (:meth:`tick` applies the rate limits)."""
        sig = self.signals(now)
        size = sig["size"]
        reasons: List[str] = []
        target = size
        if sig["queue_per_replica"] >= self.queue_high:
            target = size + 1
            reasons.append("queue_high")
        if self.tick_high_ms > 0 and sig["tick_ms"] >= self.tick_high_ms:
            target = max(target, size + 1)
            reasons.append("tick_high")
        if self.scale_on_fast_burn and sig["fast_burn"]:
            target = max(target, size + 1)
            reasons.append("fast_burn")
        if (target == size and not sig["fast_burn"] and sig["queue_per_replica"] <= self.queue_low
                and size > self.min_replicas):
            target = size - 1
            reasons.append("queue_low")
        sig["reasons"] = reasons
        return max(self.min_replicas, min(self.max_replicas, target)), sig

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One pass of the loop: decide, rate-limit, act.  Returns the scale
        event when the pool changed, else ``None``."""
        now = time.time() if now is None else now
        target, sig = self.desired(now)
        size = sig["size"]
        with self._lock:
            if target > size:
                self._down_streak = 0
                if now - self._last_up < self.up_cooldown_s:
                    self._note(sig, target, now)
                    return None
                self._last_up = now
                # A scale-up restarts the scale-down clock too.
                self._last_down = now
                self.scale_ups_total += 1
                direction = "up"
            elif target < size:
                self._down_streak += 1
                if self._down_streak < self.down_checks or now - self._last_down < self.down_cooldown_s:
                    self._note(sig, target, now)
                    return None
                self._last_down = now
                self._down_streak = 0
                self.scale_downs_total += 1
                direction = "down"
            else:
                self._down_streak = 0
                self._note(sig, target, now)
                return None
        result = self.pool.scale_to(target)
        event = {"direction": direction, "from": size, "to": target, "result": result, "signals": sig, "ts": now}
        self._note(sig, target, now)
        self.tsdb.record("autoscale.scale_events", 1.0, kind="counter", ts=now)
        self._record_transition({
            "request_id": f"autoscale-{direction}",
            "route": "engine",
            "status": None,
            "error": None,
            # A non-empty degraded list pins the record, as the SLO
            # transitions do: capacity changes are postmortem anchors.
            "degraded": [f"autoscale:{direction}:{size}->{target}"],
            "total_ms": 0.0,
            "started_at": now,
            "stages": [],
            "attrs": {
                "autoscale": direction,
                "from": size,
                "to": target,
                "queue_per_replica": round(sig["queue_per_replica"], 3),
                "tick_ms": round(sig["tick_ms"], 2),
                "fast_burn": sig["fast_burn"],
                "reason": ",".join(sig["reasons"]),
            },
        })
        logger.info("autoscale %s: %d -> %d (%s)", direction, size, target, ",".join(sig["reasons"]))
        return event

    def _note(self, sig: dict, target: int, now: float) -> None:
        self.last_decision = {"ts": now, "target": target, **sig}

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        logger.info("autoscaler started: %d..%d replicas, every %.1fs", self.min_replicas, self.max_replicas,
                    self.interval_s)

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while self._running:
            try:
                self.tick()
            except Exception:
                logger.exception("autoscaler tick failed")
            time.sleep(self.interval_s)


def pool_metrics_lines(engine=None, autoscaler=None) -> List[str]:
    """``engine_pool_size`` / ``engine_pool_desired_replicas``, exported
    from zero on both ``/metrics`` endpoints: an ``EnginePool`` reports its
    sizes, a bare ``Scheduler`` a pool of one, ``None`` (the chain server
    hosts no engine) zeros."""
    size = 0
    desired = 0
    if engine is not None:
        if hasattr(engine, "pool_size"):
            # Placeable (healthy + probation) replicas: ejected ones read as
            # missing capacity, which the autoscaler backfills.
            size = int(engine.pool_size())
            desired = int(getattr(engine, "desired_replicas", size))
        else:
            size = desired = 1
    if autoscaler is not None:
        desired = int(autoscaler.last_decision.get("target", desired) or desired)
    return [
        "# HELP engine_pool_size Healthy replicas serving in the engine pool (0 when this process hosts no engine).",
        "# TYPE engine_pool_size gauge",
        f"engine_pool_size {size}",
        "# HELP engine_pool_desired_replicas Replica count the autoscaler (or the last scale_to call) is driving "
        "the pool toward.",
        "# TYPE engine_pool_desired_replicas gauge",
        f"engine_pool_desired_replicas {desired}",
    ]
