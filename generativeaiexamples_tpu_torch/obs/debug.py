"""What both HTTP servers share of the request telemetry: the
observability switch, the per-request feed into the fleet TSDB and SLO
counters, and the ``/debug/requests`` and ``/debug/timeseries`` payloads.

The chain server (``server/app.py``) and the engine server
(``engine/server.py``) each run a telemetry shell around every request
(request id from ``X-Request-Id`` or ``traceparent``, a ``RequestTrace``,
the flight recorder) and answer the two debug routes from these
functions, so the engine needs none of the chain server's HTTP layer.
"""

from __future__ import annotations

from typing import Optional

from generativeaiexamples_tpu_torch.obs.recorder import get_flight_recorder
from generativeaiexamples_tpu_torch.obs.slo import slo_note_request
from generativeaiexamples_tpu_torch.obs.tsdb import get_tsdb, parse_window

# Infrastructure routes stay out of the SLO/TSDB feeds: a scrape loop or
# health prober must not dilute (or burn) the request error budget.
NON_API_PREFIXES = ("/health", "/metrics", "/debug", "/admin")


def obs_enabled() -> bool:
    try:
        from generativeaiexamples_tpu_torch.core.configuration import get_config

        return bool(get_config().observability.enabled)
    except Exception:  # config unavailable: telemetry stays on
        return True


def feed_fleet_telemetry(snap: dict, prefix: str = "chain") -> None:
    """One finished request → TSDB series + SLO counters (pending-list
    appends; folding and rule evaluation happen at read time)."""
    route = snap.get("route") or "other"
    if route.startswith(NON_API_PREFIXES):
        return
    status = snap.get("status")
    error = bool(snap.get("error")) or bool(status and int(status) >= 500)
    degraded = bool(snap.get("degraded"))
    total_ms = float(snap.get("total_ms") or 0.0)
    db = get_tsdb()
    db.record(f"{prefix}.requests.{route}", 1.0, kind="counter")
    db.record(f"{prefix}.request_ms.{route}", total_ms)
    if error:
        db.record(f"{prefix}.errors.{route}", 1.0, kind="counter")
    attrs = snap.get("attrs") or {}
    if attrs.get("cache_tier"):
        db.record(f"{prefix}.cache_hits.{route}", 1.0, kind="counter")
    for stage in snap.get("stages") or ():
        name = stage.get("stage")
        if name:
            db.record(f"{prefix}.stage_ms.{name}", float(stage.get("duration_ms") or 0.0))
    slo_note_request(route, total_ms, error=error, degraded=degraded)


def debug_requests(query: dict) -> tuple[int, dict]:
    """``GET /debug/requests``: (status, body) with the flight recorder's
    completed request traces, newest first (``?limit=N`` trims the dump)."""
    from generativeaiexamples_tpu_torch.server import schema

    limit: Optional[int] = None
    raw = query.get("limit", "")
    if raw:
        try:
            limit = int(raw)
        except ValueError:
            return 422, {"detail": "limit must be an integer"}
    records = get_flight_recorder().snapshot(limit)
    return 200, schema.DebugRequestsResponse(
        requests=[schema.RequestTraceRecord(**r) for r in records], count=len(records)).to_dict()


def debug_timeseries(query: dict) -> tuple[int, dict]:
    """``GET /debug/timeseries?series=a,b*&window=5m``: (status, body) with
    the in-process TSDB's bucketed history; ``series`` filters by exact
    name or trailing-``*`` prefix, omitted means everything."""
    from generativeaiexamples_tpu_torch.server import schema

    names = [p.strip() for p in query.get("series", "").split(",") if p.strip()]
    try:
        window_s = parse_window(query.get("window", ""), default_s=300.0)
    except ValueError as exc:
        return 422, {"detail": str(exc)}
    db = get_tsdb()
    payload = db.query(window_s, names or None)
    payload["names"] = db.names()
    return 200, schema.DebugTimeseriesResponse(**payload).to_dict()
