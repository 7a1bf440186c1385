"""SLO burn-rate alert engine over the in-process TSDB.

Objectives come from the ``slo.*`` config section: an availability target
(error budget = ``1 - target``; errors AND resilience-degraded responses
both burn it) and per-route latency budgets (``latency_p95_ms`` — a
request slower than its route budget burns the latency error budget).

Rules follow the Google SRE multi-window multi-burn-rate recipe: a *fast*
rule (short window + a 12x confirmation window, paging threshold, default
14.4x over 5 m/1 h) and a *slow* rule (ticket threshold, default 6x over
30 m/6 h).  A rule fires only when BOTH of its windows exceed the
threshold, which suppresses both stale alerts and single-request blips.

Hot path (``note_request``) is a handful of pending-list appends into the
TSDB; rule evaluation happens lazily at read time (``/metrics``,
``/health``, ``/debug``), at most once per ``evaluation_period_s``, and
every alert state transition is pinned into the flight recorder so
postmortems line up with the offending request traces.

A copy of the JAX package's ``obs/slo.py`` (pure Python).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from generativeaiexamples_tpu_torch.obs.tsdb import Tsdb, get_tsdb

# (rule name, short-window cfg attr, threshold cfg attr).  The long
# confirmation window is always 12x the short one — the canonical SRE
# ratio (5m/1h, 30m/6h).
_WINDOW_RATIO = 12.0

# Bounded route cardinality, same spirit as obs.metrics._MAX_LABELS.
_MAX_ROUTES = 16

_SLOS = ("availability", "latency")


def parse_latency_targets(spec: str) -> Dict[str, float]:
    """Parse ``"/generate=2500,/search=500"`` into a route->ms mapping."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        route, _, raw = part.partition("=")
        try:
            out[route.strip()] = float(raw.strip())
        except ValueError:
            continue
    return out


class SloEngine:
    """Evaluates burn-rate rules; one instance per process (or per bench
    phase — constructor-injected tsdb/recorder keep phases hermetic)."""

    def __init__(
        self,
        cfg=None,
        *,
        tsdb: Optional[Tsdb] = None,
        recorder=None,
    ) -> None:
        if cfg is None:
            from generativeaiexamples_tpu_torch.core.configuration import get_config

            cfg = get_config().slo
        self.cfg = cfg
        self.enabled = bool(getattr(cfg, "enabled", True))
        self.availability_target = float(cfg.availability_target)
        self.latency_targets = parse_latency_targets(cfg.latency_p95_ms)
        self.rules: Tuple[Tuple[str, float, float], ...] = (
            ("fast", float(cfg.fast_window_s), float(cfg.fast_burn_threshold)),
            ("slow", float(cfg.slow_window_s), float(cfg.slow_burn_threshold)),
        )
        self.evaluation_period_s = float(cfg.evaluation_period_s)
        self._tsdb = tsdb
        self._recorder = recorder
        self._lock = threading.Lock()
        self._seen: set = set(self.latency_targets)
        # (route, slo, rule) -> bool firing
        self._alerts: Dict[Tuple[str, str, str], bool] = {}
        self._last_eval = 0.0
        self._verdict: dict = {}

    # -- wiring -----------------------------------------------------------
    @property
    def tsdb(self) -> Tsdb:
        return self._tsdb if self._tsdb is not None else get_tsdb()

    def _record_transition(self, entry: dict) -> None:
        recorder = self._recorder
        if recorder is None:
            from generativeaiexamples_tpu_torch.obs.recorder import get_flight_recorder

            recorder = get_flight_recorder()
        recorder.record(entry)

    # -- hot path ---------------------------------------------------------
    def note_request(
        self,
        route: str,
        duration_ms: float,
        *,
        error: bool = False,
        degraded: bool = False,
        ts: Optional[float] = None,
    ) -> None:
        """Feed one finished request. A few pending appends; no evaluation."""
        if not self.enabled:
            return
        if route not in self._seen:
            if len(self._seen) >= _MAX_ROUTES:
                route = "other"  # cardinality fold, still evaluated
            self._seen.add(route)
        db = self.tsdb
        db.record(f"slo.total.{route}", 1.0, kind="counter", ts=ts)
        if error or degraded:
            db.record(f"slo.bad.availability.{route}", 1.0, kind="counter", ts=ts)
        target = self.latency_targets.get(route)
        if target is not None and duration_ms > target:
            db.record(f"slo.bad.latency.{route}", 1.0, kind="counter", ts=ts)

    # -- evaluation (read side) -------------------------------------------
    def _burn(
        self, route: str, slo: str, window_s: float, now: float
    ) -> Tuple[float, float]:
        """(burn_rate, bad_fraction) over the trailing window."""
        total, _ = self.tsdb.window_stats(f"slo.total.{route}", window_s, now)
        if total <= 0:
            return 0.0, 0.0
        bad, _ = self.tsdb.window_stats(f"slo.bad.{slo}.{route}", window_s, now)
        frac = min(1.0, bad / total)
        budget = 1.0 - self.availability_target
        if budget <= 0:
            return (float("inf") if frac > 0 else 0.0), frac
        return frac / budget, frac

    def evaluate(self, now: Optional[float] = None, force: bool = False) -> dict:
        """Evaluate every rule; cached for ``evaluation_period_s``."""
        if not self.enabled:
            return {"enabled": False, "routes": {}, "fast_burn_firing": False}
        now = time.time() if now is None else now
        with self._lock:
            if (
                not force
                and self._verdict
                and now - self._last_eval < self.evaluation_period_s
            ):
                return self._verdict
            routes = sorted(self._seen)
            verdict: dict = {"enabled": True, "routes": {}, "ts": now}
            fast_firing: List[str] = []
            slow_firing: List[str] = []
            transitions: List[dict] = []
            budget_window = self.rules[1][1] * _WINDOW_RATIO  # slow long (6 h)
            for route in routes:
                route_verdict: dict = {}
                slos: Tuple[str, ...] = (
                    _SLOS if route in self.latency_targets else ("availability",)
                )
                for slo in slos:
                    _, budget_frac = self._burn(route, slo, budget_window, now)
                    budget = 1.0 - self.availability_target
                    remaining = 1.0 - (budget_frac / budget) if budget > 0 else 0.0
                    slo_verdict: dict = {
                        "error_budget_remaining": max(-1.0, min(1.0, remaining)),
                        "windows": {},
                    }
                    for rule, short_s, threshold in self.rules:
                        burn_short, _ = self._burn(route, slo, short_s, now)
                        burn_long, _ = self._burn(
                            route, slo, short_s * _WINDOW_RATIO, now
                        )
                        firing = burn_short >= threshold and burn_long >= threshold
                        key = (route, slo, rule)
                        was = self._alerts.get(key, False)
                        if firing != was:
                            state = "firing" if firing else "resolved"
                            # Shaped like a RequestTraceRecord so the
                            # /debug/requests schema renders it; the
                            # degraded rung pins BOTH directions (the
                            # resolution belongs to the same episode).
                            transitions.append(
                                {
                                    "request_id": f"slo-{slo}-{rule}",
                                    "route": route,
                                    "status": None,
                                    "error": (
                                        f"slo {slo} {rule}-burn alert firing"
                                        if firing
                                        else None
                                    ),
                                    "degraded": [f"slo:{slo}:{rule}:{state}"],
                                    "total_ms": 0.0,
                                    "started_at": now,
                                    "stages": [],
                                    "attrs": {
                                        "slo_alert": f"{route}:{slo}:{rule}",
                                        "state": state,
                                        "burn_rate": round(burn_short, 3),
                                        "burn_rate_long": round(burn_long, 3),
                                        "threshold": threshold,
                                    },
                                }
                            )
                        self._alerts[key] = firing
                        slo_verdict["windows"][rule] = {
                            "burn_rate": round(burn_short, 4),
                            "burn_rate_long": round(burn_long, 4),
                            "threshold": threshold,
                            "firing": firing,
                        }
                        if firing:
                            (fast_firing if rule == "fast" else slow_firing).append(
                                f"{route}:{slo}"
                            )
                    route_verdict[slo] = slo_verdict
                verdict["routes"][route] = route_verdict
            verdict["fast_burn_firing"] = bool(fast_firing)
            verdict["firing"] = {"fast": fast_firing, "slow": slow_firing}
            self._verdict = verdict
            self._last_eval = now
        # Record transitions outside the engine lock (recorder locks too).
        for entry in transitions:
            self._record_transition(entry)
        return verdict

    # -- export -----------------------------------------------------------
    def health(self, now: Optional[float] = None) -> dict:
        """``/health`` surface: degraded while a fast-burn rule fires."""
        verdict = self.evaluate(now)
        return {
            "degraded": bool(verdict.get("fast_burn_firing")),
            "firing": verdict.get("firing", {"fast": [], "slow": []}),
        }

    def metrics_lines(self, now: Optional[float] = None) -> List[str]:
        """Prometheus text lines; every configured route exports from zero."""
        if not self.enabled:
            return []
        verdict = self.evaluate(now)
        from generativeaiexamples_tpu_torch.obs.metrics import _escape, _fmt

        budget_lines: List[str] = []
        burn_lines: List[str] = []
        state_lines: List[str] = []
        for route in sorted(verdict.get("routes", {})):
            route_l = _escape(route)
            for slo, slo_verdict in sorted(verdict["routes"][route].items()):
                labels = f'route="{route_l}",slo="{slo}"'
                budget_lines.append(
                    "rag_slo_error_budget_remaining{%s} %s"
                    % (labels, _fmt(slo_verdict["error_budget_remaining"]))
                )
                for rule, win in sorted(slo_verdict["windows"].items()):
                    wlabels = f'{labels},window="{rule}"'
                    burn_lines.append(
                        "rag_slo_burn_rate{%s} %s"
                        % (wlabels, _fmt(win["burn_rate"]))
                    )
                    state_lines.append(
                        "rag_slo_alert_state{%s} %d"
                        % (wlabels, 1 if win["firing"] else 0)
                    )
        lines = [
            "# HELP rag_slo_error_budget_remaining Fraction of the error "
            "budget left over the 6h accounting window.",
            "# TYPE rag_slo_error_budget_remaining gauge",
            *budget_lines,
            "# HELP rag_slo_burn_rate Error-budget burn-rate multiple over "
            "the rule's short window.",
            "# TYPE rag_slo_burn_rate gauge",
            *burn_lines,
            "# HELP rag_slo_alert_state 1 while the multi-window burn-rate "
            "rule is firing.",
            "# TYPE rag_slo_alert_state gauge",
            *state_lines,
        ]
        return lines


# Singleton plumbing (same shape as the flight recorder: not lru_cached so
# reset re-reads config).
_LOCK = threading.Lock()
_STATE: dict = {"engine": None}


def get_slo_engine() -> SloEngine:
    with _LOCK:
        if _STATE["engine"] is None:
            _STATE["engine"] = SloEngine()
        return _STATE["engine"]


def reset_slo() -> None:
    """Testing hook: drop the singleton (re-sized from config next use)."""
    with _LOCK:
        _STATE["engine"] = None


def slo_metrics_lines() -> List[str]:
    """Append-to-``/metrics`` helper used by both servers."""
    return get_slo_engine().metrics_lines()


def slo_health() -> dict:
    return get_slo_engine().health()


def slo_note_request(
    route: str,
    duration_ms: float,
    *,
    error: bool = False,
    degraded: bool = False,
) -> None:
    get_slo_engine().note_request(
        route, duration_ms, error=error, degraded=degraded
    )
