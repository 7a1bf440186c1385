"""The port's replica router, brownout scorer, hedge controller, autoscaler,
429 ``Retry-After`` hint and the pool / gray-failure ``/metrics`` lines
against the JAX package's, on the same seeded inputs.

No model runs here: each side gets its own router, TSDB, recorder and
stub pool, fed the same sequence made from numpy seed 0, and every
placement, score, delay, decision and line must be equal.
"""

import dataclasses

import numpy as np
import pytest

from generativeaiexamples_tpu.core import configuration as jconfiguration
from generativeaiexamples_tpu.engine import autoscale as jautoscale
from generativeaiexamples_tpu.engine import health as jhealth
from generativeaiexamples_tpu.engine import router as jrouter
from generativeaiexamples_tpu.obs import tsdb as jtsdb
from generativeaiexamples_tpu_torch.core import configuration as tconfiguration
from generativeaiexamples_tpu_torch.engine import autoscale as tautoscale
from generativeaiexamples_tpu_torch.engine import health as thealth
from generativeaiexamples_tpu_torch.engine import router as trouter
from generativeaiexamples_tpu_torch.engine.server import retry_after_s
from generativeaiexamples_tpu_torch.obs import tsdb as ttsdb
from generativeaiexamples_tpu_torch.resilience.faults import get_fault_injector, inject_replica, reset_faults

T0 = 1_700_000_000.0
SIDES = (("jax", jrouter, jhealth, jautoscale, jconfiguration, jtsdb),
         ("torch", trouter, thealth, tautoscale, tconfiguration, ttsdb))


def _families(rng, n_families=4, length=48):
    return [[int(t) for t in rng.integers(3, 500, length)] for _ in range(n_families)]


@pytest.mark.parametrize("policy", ["prefix", "session", "least_loaded", "round_robin"])
def test_router_picks_equal_reference(policy):
    """400 placements over random placeable sets, loads and brownout
    scores; finished histories feed the prefix mirrors, replicas drop out
    now and then, and 6 sessions overflow a 4-entry session map."""
    rng = np.random.default_rng(0)
    families = _families(rng)
    routers = {name: mod.Router(policy, mirror_max_segments=8, max_sessions=4, session_break=0.5)
               for name, mod, *_ in SIDES}
    picks = {name: [] for name in routers}
    for step in range(400):
        idxs = sorted(int(i) for i in rng.choice(5, size=int(rng.integers(1, 6)), replace=False))
        loads = [int(x) for x in rng.integers(0, 6, len(idxs))]
        scores = [float(x) for x in np.round(rng.choice([1.0, 1.0, 0.9, 0.45, 0.2], len(idxs)), 3)]
        fam = families[int(rng.integers(len(families)))]
        prompt = fam[: int(rng.integers(8, 48))] + [int(t) for t in rng.integers(3, 500, 4)]
        session = f"s{int(rng.integers(6))}" if rng.random() < 0.8 else ""
        finished = int(rng.choice(idxs)) if rng.random() < 0.5 else None
        history = fam + [int(t) for t in rng.integers(3, 500, int(rng.integers(0, 8)))]
        drop = int(rng.integers(5)) if rng.random() < 0.05 else None
        for name, mod, *_ in SIDES:
            r = routers[name]
            views = [mod.ReplicaView(i, load, score) for i, load, score in zip(idxs, loads, scores)]
            picks[name].append(r.select(prompt, session, views))
            if finished is not None:
                r.note_finished(finished, history)
            if drop is not None:
                r.drop_replica(drop)
    assert picks["torch"] == picks["jax"]
    assert routers["torch"].session_evictions_total == routers["jax"].session_evictions_total
    if policy == "session":
        assert routers["torch"].session_evictions_total > 0
    assert len(set(picks["torch"])) > 1


def test_router_refuses_what_the_reference_refuses():
    for _, mod, *_ in SIDES:
        with pytest.raises(ValueError):
            mod.Router("fastest")
        with pytest.raises(ValueError):
            mod.Router("prefix").select([1], "", [])
    assert trouter.POLICIES == jrouter.POLICIES and trouter.MIN_PREFIX == jrouter.MIN_PREFIX


def _health_cfg(configuration, **kw):
    return dataclasses.replace(configuration.HealthConfig(), **kw)


@pytest.mark.parametrize("kw", [dict(), dict(score_smoothing=1.0, tick_tolerance=1.5, window_s=3.0),
                                dict(enabled=False)])
def test_replica_scores_equal_reference(kw):
    """Four replicas' tick, queue and TTFT series (one a straggler, one
    with gaps), scored at 60 instants over a sliding window."""
    rng = np.random.default_rng(0)
    scorers, dbs = {}, {}
    for name, _, health, _, configuration, tsdb in SIDES:
        dbs[name] = tsdb.Tsdb()
        scorers[name] = health.ReplicaScorer(_health_cfg(configuration, **kw), dbs[name])
    got = {name: [] for name in scorers}
    ts = T0
    for step in range(60):
        for _ in range(int(rng.integers(1, 6))):
            ts += float(rng.exponential(0.2))
            idx = int(rng.integers(4))
            if idx == 3 and step < 20:
                continue  # no data yet: scores 1.0
            slow = 4.0 if idx == 2 and step > 15 else 1.0
            samples = (("tick_ms", float(rng.normal(20, 3)) * slow), ("queued", float(rng.integers(0, 4)) * slow),
                       ("ttft_ms", float(rng.normal(200, 30)) * slow))
            for series, value in samples:
                for db in dbs.values():
                    db.record(f"engine.replica.{idx}.{series}", value, ts=ts)
        for name, scorer in scorers.items():
            got[name].append(scorer.score_all(range(4), now=ts))
        if step == 40:
            for scorer in scorers.values():
                scorer.drop(1)
    assert got["torch"] == got["jax"]
    if kw.get("enabled", True):  # the straggler scored low, its peers high
        assert any(d[2] < 0.5 and d[0] > 0.9 for d in got["torch"])


def test_hedge_controller_equals_reference():
    rng = np.random.default_rng(0)
    ctrls = {name: health.HedgeController(_health_cfg(configuration, hedge_budget_ratio=0.3, hedge_burst=2.0))
             for name, _, health, _, configuration, _ in SIDES}
    trail = {name: [] for name in ctrls}
    for _ in range(300):
        op = int(rng.integers(6))
        ms = float(rng.lognormal(4.0, 0.6))
        for name, c in ctrls.items():
            if op == 0:
                c.note_submit()
            elif op == 1:
                trail[name].append(c.try_spend())
            elif op == 2:
                c.note_latency(ms)
            elif op == 3:
                c.note_fired()
                c.note_win()
            elif op == 4:
                c.note_cancelled()
            trail[name].append((round(c.delay_ms(), 9), c.ready, c.enabled))
    assert trail["torch"] == trail["jax"]
    assert ctrls["torch"].snapshot() == ctrls["jax"].snapshot()
    assert ctrls["torch"].WARMUP_SAMPLES == ctrls["jax"].WARMUP_SAMPLES


def test_hedge_timer_wheel_fires_in_deadline_order_and_skips_cancelled():
    import threading

    fired, done = [], threading.Event()
    wheel = thealth.HedgeTimerWheel()
    try:
        wheel.arm(0.06, fired.append, "late")
        wheel.arm(0.02, fired.append, "early").cancel()
        wheel.arm(0.03, fired.append, "mid")
        wheel.arm(0.09, lambda _: done.set(), None)
        assert done.wait(timeout=10)
    finally:
        wheel.stop()
    assert fired == ["mid", "late"]


class _StubPool:
    def __init__(self, size=1):
        self.size = size
        self.desired_replicas = size
        self.calls = []

    def pool_size(self):
        return self.size

    def scale_to(self, n):
        self.calls.append(n)
        self.size = n
        self.desired_replicas = n
        return {"size": n, "added": [], "drained": []}


class _StubSlo:
    def __init__(self):
        self.fast = False

    def evaluate(self, now=None, force=False):
        return {"fast_burn_firing": self.fast}


class _Recorder:
    def __init__(self):
        self.entries = []

    def record(self, entry):
        self.entries.append(entry)


@pytest.mark.parametrize("kw", [dict(), dict(tick_high_ms=30.0, down_checks=3, up_cooldown_s=4.0,
                                             down_cooldown_s=12.0, max_replicas=5)])
def test_autoscaler_decisions_equal_reference(kw):
    """A queue that swells, a slow-tick spell, a fast-burn page and a long
    quiet tail, decided every second for 240 s: desired counts, signals,
    scale events, recorded transitions and the pools' calls all equal."""
    rng = np.random.default_rng(0)
    sides = {}
    for name, _, _, autoscale, configuration, tsdb in SIDES:
        base = dict(enabled=True, interval_s=1.0, window_s=10.0, up_cooldown_s=8.0, down_cooldown_s=20.0,
                    down_checks=2)
        cfg = dataclasses.replace(configuration.AutoscaleConfig(), **{**base, **kw})
        pool, slo, rec, db = _StubPool(1), _StubSlo(), _Recorder(), tsdb.Tsdb()
        sides[name] = (autoscale.Autoscaler(pool, cfg, tsdb=db, slo=slo, recorder=rec), pool, slo, rec, db)
    out = {name: [] for name in sides}
    for t in range(240):
        now = T0 + t
        depth = 12.0 if 20 <= t < 60 else (2.0 if t < 120 else 0.0)
        tick = float(rng.normal(45 if 70 <= t < 90 else 15, 2))
        fast = 100 <= t < 110
        for name, (scaler, pool, slo, rec, db) in sides.items():
            db.record("engine.queued", depth + float(t % 3), ts=now)
            db.record("engine.tick_ms", tick, ts=now)
            slo.fast = fast
            target, sig = scaler.desired(now)
            event = scaler.tick(now)
            out[name].append((target, sig, event and {k: event[k] for k in ("direction", "from", "to", "result")},
                              dict(scaler.last_decision)))
    assert out["torch"] == out["jax"]
    (ts, tp, _, trec, _), (js, jp, _, jrec, _) = sides["torch"], sides["jax"]
    assert tp.calls == jp.calls and len(tp.calls) >= 3
    assert trec.entries == jrec.entries
    assert (ts.scale_ups_total, ts.scale_downs_total) == (js.scale_ups_total, js.scale_downs_total)


def test_pool_and_gray_metrics_lines_equal_reference():
    """From zero (no engine), a bare scheduler (a pool of one) and a stub
    pool with hedges, ejections and scores: every line equal."""

    class _Bare:
        pass

    class _Gray(_StubPool):
        ejections_total, readmissions_total = 3, 1

        def __init__(self, hedger):
            super().__init__(2)
            self.hedger = hedger
            self.desired_replicas = 3

        def ejected_count(self):
            return 1

        def replica_scores(self):
            return {1: 0.123456, 0: 1.0}

    for engine_of in (lambda _: None, lambda _: _Bare(), lambda h: _Gray(h)):
        lines = {}
        for name, _, health, autoscale, configuration, _ in SIDES:
            hedger = health.HedgeController(configuration.HealthConfig())
            hedger.note_fired()
            engine = engine_of(hedger)
            scaler = autoscale.Autoscaler(_StubPool(2), configuration.AutoscaleConfig(), tsdb=object(),
                                          slo=_StubSlo(), recorder=_Recorder())
            scaler.last_decision = {"target": 4}
            lines[name] = (health.gray_metrics_lines(engine), autoscale.pool_metrics_lines(engine),
                           autoscale.pool_metrics_lines(engine, autoscaler=scaler))
        assert lines["torch"] == lines["jax"]


def _snapshots(rng, n=64):
    for i in range(n):
        snap = {"queued": int(rng.integers(0, 400)), "tick_ms_ewma": float(rng.uniform(0, 400)),
                "tick_ms_norm_ewma": float(rng.uniform(0, 200)) if i % 3 else 0.0}
        if i % 2:  # the paged layout: pool gauges and the 429 page projection
            total = int(rng.integers(65, 2000))
            snap.update(kv_pages_total=total, kv_pages_free=int(rng.integers(0, total)),
                        kv_pages_per_admit=int(rng.integers(1, 64)),
                        kv_page_free_rate=float(rng.choice([0.0, 0.2, 3.0, 40.0])))
        yield snap


def test_retry_after_equals_the_reference_429():
    """The hint as a pure function of a stats snapshot, against the JAX
    front's ``_overloaded_response`` over a stub engine with that snapshot,
    on contiguous and paged snapshots (both ends of the clamp included)."""
    from generativeaiexamples_tpu.engine.server import _overloaded_response

    class _Stats:
        def __init__(self, snap):
            self.snap = snap

        def snapshot(self):
            return self.snap

    class _Engine:
        def __init__(self, snap):
            self.stats = _Stats(snap)

    got, want = [], []
    for snap in _snapshots(np.random.default_rng(0)):
        resp = _overloaded_response(_Engine(snap))
        assert resp.status == 429
        want.append(int(resp.headers["Retry-After"]))
        got.append(retry_after_s(snap))
    assert got == want
    assert min(got) == 1 and max(got) == 30 and len(set(got)) > 5


class TestReplicaFaultSite:
    def teardown_method(self):
        reset_faults()

    def test_index_filter(self):
        inj = get_fault_injector()
        inj.configure("replica:latency=5,index=1")
        inject_replica(0)
        inject_replica(1)
        assert inj.counts()["replica"]["hits"] == 1

    def test_error_raises_only_at_its_index(self):
        from generativeaiexamples_tpu_torch.resilience.faults import FaultInjected

        get_fault_injector().configure("replica:error=1,index=0")
        inject_replica(1)
        with pytest.raises(FaultInjected):
            inject_replica(0)
