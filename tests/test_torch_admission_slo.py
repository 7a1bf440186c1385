"""The port's admission controller, ring TSDB and SLO engine against the
JAX package's, on one event sequence under one clock.

Each package gets its own controller, TSDB, SLO engine and flight
recorder (injected, so the process singletons stay out of it), the same
config and the same events made from numpy seed 0; every decision, every
recorded transition, every query and every verdict must be equal.  The
reset repair is checked too: ``reset_resilience`` drops the admission
controller in both packages.
"""

import dataclasses

import numpy as np
import pytest

from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.obs import recorder as jrecorder
from generativeaiexamples_tpu.obs import slo as jslo
from generativeaiexamples_tpu.obs import tsdb as jtsdb
from generativeaiexamples_tpu.resilience import admission as jadmission
from generativeaiexamples_tpu.resilience import metrics as jmetrics
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.obs import recorder as trecorder
from generativeaiexamples_tpu_torch.obs import slo as tslo
from generativeaiexamples_tpu_torch.obs import tsdb as ttsdb
from generativeaiexamples_tpu_torch.resilience import admission as tadmission
from generativeaiexamples_tpu_torch.resilience import metrics as tmetrics

T0 = 1_700_000_000.0


class _Clock:
    def __init__(self) -> None:
        self.now = T0

    def __call__(self) -> float:
        return self.now


def _admission_cfg(configuration, **kw):
    return dataclasses.replace(configuration.AdmissionConfig(), **kw)


@pytest.mark.parametrize("kw", [
    dict(),  # the defaults: classify and count, never shed
    dict(max_inflight=6, rates="batch=4,ingest=1.5", burst_s=1.0),
    dict(max_inflight=10, parallel_hint=2, weights="interactive=5,batch=3,ingest=2", retry_after_max_s=5.0),
])
def test_admission_decisions_match_reference(kw):
    rng = np.random.default_rng(0)
    clock = _Clock()
    sides = {}
    for name, admission, configuration, recorder, tsdb in (
        ("jax", jadmission, jconfiguration, jrecorder, jtsdb),
        ("torch", tadmission, tconfiguration, trecorder, ttsdb),
    ):
        kwargs = dict(recorder=recorder.FlightRecorder(capacity=256), tsdb=tsdb.Tsdb())
        if name == "torch":
            kwargs["clock"] = clock  # the port's controller reads the injected clock
        sides[name] = (admission.AdmissionController(_admission_cfg(configuration, **kw), **kwargs), kwargs)
    headers_pool = [{}, {"X-Traffic-Class": "batch"}, {"x-traffic-class": "INGEST"}, {"X-Traffic-Class": "bogus"},
                    {"X-Traffic-Class": " interactive "}]
    events = []
    for _ in range(400):
        clock_step = float(rng.exponential(0.08))
        events.append((clock_step, headers_pool[int(rng.integers(len(headers_pool)))],
                       [None, "ingest", "batch"][int(rng.integers(3))],
                       None if rng.random() < 0.5 else float(rng.uniform(0, 400)),
                       float(rng.uniform(5, 300)), rng.random() < 0.6))
    trail = {"jax": [], "torch": []}
    inflight = {"jax": [], "torch": []}
    now = T0
    for step, headers, default, deadline_ms, duration_ms, release in events:
        now += step
        clock.now = now
        for name, (ctrl, _) in sides.items():
            cls = ctrl.classify(headers, default=default)
            d = (ctrl.try_admit(cls, deadline_ms=deadline_ms, route="/search") if name == "torch"
                 else ctrl.try_admit(cls, deadline_ms=deadline_ms, now=now, route="/search"))
            trail[name].append((cls, d.admitted, d.cls, d.reason, round(d.retry_after_s, 9)))
            if d.admitted:
                inflight[name].append(d.cls)
            if release and inflight[name]:
                ctrl.release(inflight[name].pop(0), duration_ms=duration_ms)
    assert trail["torch"] == trail["jax"]
    (jctrl, jkw), (tctrl, tkw) = sides["jax"], sides["torch"]
    assert tctrl.snapshot() == jctrl.snapshot()
    assert tkw["recorder"].snapshot() == jkw["recorder"].snapshot()
    assert tkw["tsdb"].query(3600.0, now=now) == jkw["tsdb"].query(3600.0, now=now)
    if kw:
        assert sum(not t[1] for t in trail["jax"]) > 0  # shedding happened


def test_admission_metrics_and_reset_repair(monkeypatch):
    """``reset_resilience`` drops the admission controller in both
    packages (the port's used to keep it), and the metric lines agree."""
    for configuration in (jconfiguration, tconfiguration):
        configuration.reset_config_cache()
    lines = {}
    for name, admission, metrics in (("jax", jadmission, jmetrics), ("torch", tadmission, tmetrics)):
        metrics.reset_resilience()
        ctrl = admission.get_admission_controller()
        for cls in ("interactive", "interactive", "batch", "ingest"):
            assert ctrl.try_admit(cls).admitted
        lines[name] = admission.admission_metrics_lines()
        metrics.reset_resilience()
        assert admission.get_admission_controller() is not ctrl
        assert admission.get_admission_controller().snapshot()["admitted_total"]["interactive"] == 0
    assert lines["torch"] == lines["jax"]
    assert 'rag_admission_admitted_total{class="interactive"} 2' in lines["torch"]


def test_tsdb_matches_reference():
    rng = np.random.default_rng(0)
    dbs = {"jax": jtsdb.Tsdb(max_series=12), "torch": ttsdb.Tsdb(max_series=12)}
    names = [f"chain.request_ms./r{i}" for i in range(10)] + ["slo.total./search", "engine.replica.1.tick_ms",
                                                               "engine.replica.2.tick_ms", "other.x"]
    ts = T0
    for _ in range(3000):
        ts += float(rng.exponential(2.0))
        name = names[int(rng.integers(len(names)))]
        kind = "counter" if name.startswith("slo") else "gauge"
        value = float(rng.normal(100, 30))
        for db in dbs.values():
            db.record(name, value, kind=kind, ts=ts)
    for db in dbs.values():
        assert db.drop_series("engine.replica.1.") in (0, 1)
    j, t = dbs["jax"], dbs["torch"]
    assert t.names() == j.names()
    for window in (10.0, 300.0, 900.0, 3600.0, 43200.0):
        for pats in (None, ["chain.*"], ["slo.total./search", "missing"]):
            assert t.query(window, pats, now=ts) == j.query(window, pats, now=ts)
        for name in names:
            assert t.window_stats(name, window, now=ts) == j.window_stats(name, window, now=ts)
    for raw in ("", "30", "30s", "5m", "2h", "250ms", " 1.5M "):
        assert ttsdb.parse_window(raw) == jtsdb.parse_window(raw)
    for raw in ("abc", "-5m", "0"):
        for mod in (ttsdb, jtsdb):
            with pytest.raises(ValueError):
                mod.parse_window(raw)


def test_slo_engine_matches_reference():
    rng = np.random.default_rng(0)
    engines, recorders = {}, {}
    for name, slo, tsdb, recorder, configuration in (
        ("jax", jslo, jtsdb, jrecorder, jconfiguration),
        ("torch", tslo, ttsdb, trecorder, tconfiguration),
    ):
        cfg = dataclasses.replace(configuration.SLOConfig(), fast_window_s=60.0, slow_window_s=300.0,
                                  evaluation_period_s=5.0)
        recorders[name] = recorder.FlightRecorder(capacity=512)
        engines[name] = slo.SloEngine(cfg, tsdb=tsdb.Tsdb(), recorder=recorders[name])
    routes = ["/generate", "/search", "/documents"] + [f"/r{i}" for i in range(20)]
    now = T0
    checks = []
    for step in range(2400):
        now += float(rng.exponential(1.5))
        # An outage in the middle: errors and slow searches burn both budgets.
        outage = 900 <= step < 1300
        route = routes[int(rng.integers(3 if step < 2000 else len(routes)))]
        duration = float(rng.exponential(1800.0 if outage else 150.0))
        error = bool(rng.random() < (0.3 if outage else 0.002))
        degraded = bool(rng.random() < 0.01)
        for eng in engines.values():
            eng.note_request(route, duration, error=error, degraded=degraded, ts=now)
        if step % 97 == 0:
            got = [engines["torch"].health(now=now), engines["torch"].metrics_lines(now=now)]
            want = [engines["jax"].health(now=now), engines["jax"].metrics_lines(now=now)]
            assert got == want
            checks.append(got[0]["degraded"])
            assert engines["torch"].evaluate(now=now, force=True) == engines["jax"].evaluate(now=now, force=True)
    assert any(checks) and not all(checks)  # the fast burn fired and resolved
    assert recorders["torch"].snapshot() == recorders["jax"].snapshot()
    assert tslo.parse_latency_targets("/a=1, /b = 2.5 ,bad,/c=x") == jslo.parse_latency_targets("/a=1, /b = 2.5 ,bad,/c=x")
