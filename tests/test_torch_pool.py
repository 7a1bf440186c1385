"""The port's replica pool (``engine/replica.py``) on the CPU, tiny Llama.

Greedy streams through a 2-replica port pool equal one port scheduler's
and a 2-replica JAX ``EnginePool``'s on the same W8A8 weights (the JAX
pool is built once for the module).  Then the reference's contracts
(``tests/test_router.py``, ``test_gray.py``, ``test_elastic.py``) on the
port: failover requeue, the in-flight error, no survivor, drain, both
cancel-beats-requeue races, ejection and probation, hedging, ``scale_to``
up and down, and the scheduler's side of the contract: ``max_queue``, the
``replica`` fault site outside the tick's recovery, the paged pool's 429
inputs.  Every wait on a thread has its own timeout.
"""

import queue
import threading
import time

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import replica as jreplica
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.core.configuration import HealthConfig
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.health import HedgeController
from generativeaiexamples_tpu_torch.engine.replica import (
    DETACHED,
    DRAINING,
    EJECTED,
    HEALTHY,
    PROBATION,
    UNHEALTHY,
    EnginePool,
    Replica,
)
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.obs.tsdb import Tsdb
from generativeaiexamples_tpu_torch.resilience.faults import get_fault_injector, reset_faults

JCFG = jllama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
TCFG = tllama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
KW = dict(max_batch=2, max_len=128, decode_chunk_size=4)
PROMPTS = [[5, 6, 7], list(range(2, 40)), [9, 8, 7, 6, 5], list(range(2, 40)) + [77, 78], [40, 41], [3] * 20]
WAIT_S = 60


@pytest.fixture(scope="module")
def jax_params():
    raw = jdecode.init_random_int8_params(JCFG, jax.random.PRNGKey(0))
    packed = jdecode.prepare_params(JCFG, raw, None, pack=True)
    return jdecode.prepare_params(JCFG, packed, None, matmul_kernel="pallas_w8a8")


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), TCFG, "cpu")


@pytest.fixture(scope="module")
def jax_pool_streams(jax_params):
    """The JAX pool's greedy streams, built and run once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
        mp.setenv("GAIE_EXACT_SAMPLING", "1")
        pool = jreplica.EnginePool(
            [jsched.Scheduler(JCFG, jax_params, matmul_kernel="pallas_w8a8", **KW) for _ in range(2)],
            policy="round_robin", health_interval=None)
        pool.start()
        try:
            return _streams(jsched, pool), [r["requests_total"] for r in pool.snapshot()["replicas"]]
        finally:
            pool.stop()


def _sched(params, **kw):
    return tsched.Scheduler(TCFG, params, device="cpu", **{**KW, **kw})


def _pool(params, n=2, policy="least_loaded", sched_kw=None, **kw):
    kw.setdefault("health_interval", None)  # the tests drive check_replicas()
    kw.setdefault("tsdb", Tsdb())
    kw.setdefault("recorder", _Recorder())
    return EnginePool([_sched(params, **(sched_kw or {})) for _ in range(n)], policy=policy, **kw)


def _request(mod, prompt, rid, *, max_tokens=3, session_id="", on_token=None, hedgeable=False):
    done: "queue.Queue[str]" = queue.Queue()
    tokens: list[int] = []
    req = mod.Request(token_ids=list(prompt), sampling=SamplingParams(temperature=0.0, max_tokens=max_tokens),
                      on_token=on_token or tokens.append, on_done=done.put, id=rid, session_id=session_id,
                      hedgeable=hedgeable)
    return req, tokens, done


def _streams(mod, engine, max_tokens=6):
    """Every prompt submitted at once (the pool spreads them), then each
    alone; their greedy tokens by prompt index."""
    out, dones = {}, []
    for i, prompt in enumerate(PROMPTS):
        req, tokens, done = _request(mod, prompt, f"s-{i}", max_tokens=max_tokens)
        assert engine.submit(req) is not False
        out[i], dones = tokens, dones + [done]
    assert [d.get(timeout=WAIT_S) for d in dones] == ["length"] * len(PROMPTS)
    for i, prompt in enumerate(PROMPTS):
        req, tokens, done = _request(mod, prompt, f"a-{i}", max_tokens=max_tokens)
        engine.submit(req)
        assert done.get(timeout=WAIT_S) == "length"
        out[f"alone-{i}"] = tokens
    return out


def _kill(replica):
    """Synthetic replica death: stop the tick loop and wait it out."""
    replica.scheduler.request_stop()
    replica.scheduler._thread.join(timeout=WAIT_S)
    assert not replica.thread_alive()


class _Recorder:
    def __init__(self):
        self.entries = []

    def record(self, entry):
        self.entries.append(entry)


class _FixedScorer:
    """Stub scorer: the state-machine tests set scores directly."""

    def __init__(self, scores=None):
        self.scores = dict(scores or {})

    def score_all(self, indices, now=None):
        return {i: self.scores.get(i, 1.0) for i in indices}

    def drop(self, idx):
        self.scores.pop(idx, None)


def _gray_cfg(**kw):
    base = dict(window_s=5.0, score_smoothing=1.0, eject_threshold=0.5, eject_after_s=0.0, readmit_score=0.8,
                readmit_after_s=0.0, probation_s=5.0, max_eject_fraction=0.5)
    return HealthConfig(**{**base, **kw})


# -- greedy streams --------------------------------------------------------


def test_pool_streams_equal_one_scheduler_and_the_jax_pool(monkeypatch, params, jax_pool_streams):
    jax_streams, jax_spread = jax_pool_streams
    pool = _pool(params, policy="round_robin")
    pool.start()
    try:
        got = _streams(tsched, pool)
        spread = [r["requests_total"] for r in pool.snapshot()["replicas"]]
    finally:
        pool.stop()
    single = _sched(params)
    single.start()
    try:
        alone = _streams(tsched, single)
    finally:
        single.stop()
    assert got == alone == jax_streams
    assert all(got[i] for i in range(len(PROMPTS)))
    # Both pools placed on both replicas alike.
    assert spread == jax_spread and min(spread) > 0


# -- the scheduler's side of the contract ------------------------------------


def test_max_queue_refuses_and_counts(params):
    sched = _sched(params, max_queue=0)
    req, _, _ = _request(tsched, [1, 2], "r0")
    assert sched.submit(req) is False
    assert sched.stats.snapshot()["rejected_total"] == 1 and sched.stats.snapshot()["queued"] == 0
    unbounded = _sched(params)
    req, _, _ = _request(tsched, [1, 2], "r1")
    assert unbounded.submit(req) is True and unbounded.stats.snapshot()["queued"] == 1


def test_paged_snapshot_carries_the_429_page_inputs(params):
    sched = _sched(params, kv_layout="paged", kv_page_size=16)
    snap = sched.stats.snapshot()
    assert snap["kv_pages_per_admit"] == sched._pool.n_slot_pages
    assert snap["kv_page_free_rate"] == 0.0 and snap["kv_page_utilization"] == pytest.approx(
        1.0 - snap["kv_pages_free"] / snap["kv_pages_total"], abs=1e-4)
    sched.start()
    try:
        req, _, done = _request(tsched, list(range(2, 22)), "p0", max_tokens=4)
        sched.submit(req)
        assert done.get(timeout=WAIT_S) == "length"
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and sched.stats.snapshot()["kv_pages_per_admit"] == sched._pool.n_slot_pages:
            time.sleep(0.05)
    finally:
        sched.stop()
    # A 20-token prompt needs 2 pages, not a whole slot's 8: the EWMA moves.
    assert 1 <= sched.stats.snapshot()["kv_pages_per_admit"] < sched._pool.n_slot_pages


class TestReplicaFaultSite:
    def teardown_method(self):
        reset_faults()

    @pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_replica_error_ends_the_tick_thread_and_the_pool_fails_over(self, params):
        pool = _pool(params, policy="round_robin")
        pool.start()
        try:
            get_fault_injector().configure("replica:error=1,index=1")
            pool.replicas[1].scheduler._thread.join(timeout=WAIT_S)
            assert not pool.replicas[1].thread_alive() and pool.replicas[0].thread_alive()
            reset_faults()
            pool.check_replicas()
            assert pool.replicas[1].state == UNHEALTHY and pool.failovers_total == 1
            req, _, done = _request(tsched, [5, 6, 7], "after")
            assert pool.submit(req)
            assert done.get(timeout=WAIT_S) == "length"
        finally:
            pool.stop()

    def test_injected_latency_lands_in_the_tick_time(self, params):
        get_fault_injector().configure("replica:latency=30,index=0")
        pool = _pool(params, n=1)
        try:
            pool.replicas[0].scheduler.start()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and pool.replicas[0].scheduler.stats.tick_ms_ewma <= 10.0:
                time.sleep(0.05)
            assert pool.replicas[0].scheduler.stats.tick_ms_ewma > 10.0
        finally:
            pool.stop()


def test_ticking_detects_a_frozen_counter(params):
    r = Replica(0, _sched(params))
    now = time.monotonic()
    assert r.ticking(now, 0.1)
    r.scheduler.stats.tick_count = 7
    assert r.ticking(now + 1.0, 0.1)
    assert not r.ticking(now + 2.0, 0.1)


# -- failover ----------------------------------------------------------------


class TestFailover:
    def test_dead_replica_requeues_queued_requests(self, params):
        pool = _pool(params, policy="round_robin")
        pool.start()
        try:
            _kill(pool.replicas[0])
            dones: "queue.Queue[str]" = queue.Queue()
            for i in range(6):
                req, _, _ = _request(tsched, [i + 1, 2, 3], f"fo-{i}")
                req.on_done = dones.put
                assert pool.submit(req)
            time.sleep(0.2)
            pool.check_replicas()
            assert [dones.get(timeout=WAIT_S) for _ in range(6)] == ["length"] * 6
            assert dones.empty()
            snap = pool.stats.snapshot()
            assert snap["replicas"][0]["state"] == UNHEALTHY
            assert snap["router_failovers_total"] == 1 and snap["router_requeued_total"] >= 1
            assert not pool.healthy() and not pool._placements
        finally:
            pool.stop()

    def test_inflight_on_dead_replica_surfaces_error(self, params):
        pool = _pool(params)
        pool.start()
        try:
            started = threading.Event()
            req, _, done = _request(tsched, [5, 6, 7], "inflight", max_tokens=100, on_token=lambda t: started.set())
            assert pool.submit(req)
            assert started.wait(timeout=WAIT_S)
            _kill(pool.replicas[pool._placements["inflight"].replica])
            pool.check_replicas()
            assert done.get(timeout=WAIT_S) == "error"
        finally:
            pool.stop()

    def test_no_survivor_fails_requests_not_hangs(self, params):
        pool = _pool(params, n=1, policy="round_robin")
        pool.start()
        try:
            _kill(pool.replicas[0])
            req, _, done = _request(tsched, [1, 2], "lone")
            assert pool.submit(req)
            pool.check_replicas()
            assert done.get(timeout=WAIT_S) == "error"
        finally:
            pool.stop()


# -- drain and the cancel races ------------------------------------------------


def _fill(pool, n, max_tokens):
    events = [threading.Event() for _ in range(n)]
    dones = []
    for i in range(n):
        req, _, done = _request(tsched, [i + 1, 5], f"run-{i}", max_tokens=max_tokens,
                                on_token=lambda t, e=events[i]: e.set())
        dones.append(done)
        assert pool.submit(req)
    assert all(e.wait(timeout=WAIT_S) for e in events)
    return dones


class TestDrain:
    def test_drain_finishes_inflight_refuses_new_then_detaches(self, params):
        pool = _pool(params, policy="least_loaded")
        pool.start()
        try:
            started = threading.Event()
            runner, _, runner_done = _request(tsched, [9, 8, 7], "runner", max_tokens=25,
                                              on_token=lambda t: started.set())
            assert pool.submit(runner)
            assert started.wait(timeout=WAIT_S)
            victim = pool._placements["runner"].replica
            assert pool.drain(victim) == DRAINING
            for i in range(3):
                req, _, done = _request(tsched, [i + 20, 1], f"post-{i}")
                assert pool.submit(req)
                assert pool._placements[f"post-{i}"].replica != victim
                assert done.get(timeout=WAIT_S) == "length"
            assert runner_done.get(timeout=WAIT_S) == "length"
            pool.check_replicas()
            assert pool.replicas[victim].state == DETACHED
            assert pool.replicas[victim].scheduler._thread is None
            assert pool.healthy()
        finally:
            pool.stop()

    def test_drain_migrates_queued_requests_to_survivor(self, params):
        pool = _pool(params, policy="round_robin", sched_kw=dict(max_batch=1))
        pool.start()
        try:
            runner_dones = _fill(pool, 2, 60)
            queued, _, queued_done = _request(tsched, [40, 41, 42], "queued")
            assert pool.submit(queued)
            victim = pool._placements["queued"].replica
            pool.drain(victim)
            assert pool._placements["queued"].replica != victim
            for done in runner_dones:
                assert done.get(timeout=WAIT_S) == "length"
            assert queued_done.get(timeout=WAIT_S) == "length"
        finally:
            pool.stop()


class TestCancelBeatsRequeue:
    def test_cancel_wins_over_failover_requeue(self, params):
        pool = _pool(params, policy="round_robin")
        pool.start()
        try:
            _kill(pool.replicas[0])
            target, others = None, []
            for i in range(2):
                req, _, done = _request(tsched, [i + 1, 2, 3], f"c-{i}")
                assert pool.submit(req)
                if pool._placements[f"c-{i}"].replica == 0:
                    target = (req, done)
                else:
                    others.append(done)
            assert target is not None
            req, done = target
            for other in others:
                other.get(timeout=WAIT_S)
            before = pool.replicas[1].scheduler.stats.snapshot()["requests_total"]
            pool.cancel(req.id)
            pool.check_replicas()
            assert done.get(timeout=WAIT_S) == "cancelled" and done.empty()
            assert pool.replicas[1].scheduler.stats.snapshot()["requests_total"] == before
            assert req.id not in pool._placements
        finally:
            pool.stop()

    def test_cancel_wins_over_drain_migration(self, params):
        pool = _pool(params, policy="round_robin", sched_kw=dict(max_batch=1))
        pool.start()
        try:
            runner_dones = _fill(pool, 2, 30)
            queued, _, queued_done = _request(tsched, [50, 51, 52], "dq")
            assert pool.submit(queued)
            victim = pool._placements["dq"].replica
            pool.cancel("dq")
            pool.drain(victim)
            placement = pool._placements.get("dq")
            assert placement is None or placement.replica == victim
            assert queued_done.get(timeout=WAIT_S) == "cancelled"
            for done in runner_dones:
                assert done.get(timeout=WAIT_S) == "length"
        finally:
            pool.stop()


# -- gray failure ----------------------------------------------------------------


class TestEjectionAndProbation:
    def test_sustained_brownout_ejects_and_pins(self, params):
        pool = _pool(params, n=3, health_cfg=_gray_cfg())
        pool.scorer = _FixedScorer({0: 0.2})
        pool.check_replicas(now=100.0)
        assert pool.replicas[0].state == EJECTED and pool.ejections_total == 1
        assert pool.ejected_count() == 1 and pool.pool_size() == 2
        pins = [e for e in pool._recorder.entries if "gray" in e["attrs"]]
        assert pins and pins[0]["degraded"] == ["gray:ejected:0"]

    def test_dwell_and_the_fraction_guard(self, params):
        pool = _pool(params, n=3, health_cfg=_gray_cfg(eject_after_s=3.0))
        pool.scorer = _FixedScorer({0: 0.2})
        pool.check_replicas(now=100.0)
        pool.check_replicas(now=102.0)
        assert pool.replicas[0].state == HEALTHY
        pool.check_replicas(now=103.5)
        assert pool.replicas[0].state == EJECTED
        guarded = _pool(params, n=3, health_cfg=_gray_cfg(max_eject_fraction=0.4))
        guarded.scorer = _FixedScorer({0: 0.1, 1: 0.1, 2: 0.1})
        guarded.check_replicas(now=100.0)
        assert [r.state for r in guarded.replicas].count(EJECTED) == 1

    def test_probation_readmission_no_flap(self, params):
        pool = _pool(params, n=3, policy="prefix", health_cfg=_gray_cfg(probation_s=5.0))
        pool.router.note_finished(0, list(range(40)))
        pool.scorer = _FixedScorer({0: 0.2})
        pool.check_replicas(now=100.0)
        assert pool.replicas[0].state == EJECTED and 0 not in pool.router._mirrors
        assert [v.idx for v in pool._views_locked()] == [1, 2]
        pool.scorer.scores[0] = 0.95
        pool.check_replicas(now=103.0)
        assert pool.replicas[0].state == PROBATION and pool.readmissions_total == 1
        pool.scorer.scores[0] = 0.3
        pool.check_replicas(now=106.0)
        assert pool.replicas[0].state == EJECTED and pool.ejections_total == 2
        pool.scorer.scores[0] = 0.95
        pool.check_replicas(now=107.0)
        pool.check_replicas(now=112.5)
        assert pool.replicas[0].state == HEALTHY
        assert [e["attrs"]["gray"] for e in pool._recorder.entries] == [
            "ejected", "readmitted", "ejected", "readmitted", "restored"]
        snap = pool.snapshot()
        assert snap["ejections_total"] == 2 and snap["readmissions_total"] == 2

    def test_feed_tsdb_emits_the_scorer_series(self, params):
        db = Tsdb()
        pool = _pool(params, tsdb=db)
        pool._feed_tsdb()
        names = set(db.names())
        for i in (0, 1):
            assert {f"engine.replica.{i}.{s}" for s in ("tick_ms", "score", "healthy", "queued")} <= names


class TestHedging:
    def test_hedge_wins_when_primary_stuck(self, params):
        pool = _pool(params, health_cfg=_gray_cfg())
        try:
            req, tokens, done = _request(tsched, [1, 2, 3], "hedge-1", hedgeable=True)
            assert pool.submit(req)
            sibling = 1 - pool._placements["hedge-1"].replica
            pool.replicas[sibling].scheduler.start()
            pool._hedge_fire("hedge-1")
            assert pool.hedger.fired_total == 1
            assert done.get(timeout=WAIT_S) == "length" and len(tokens) == 3 and done.empty()
            assert pool.hedger.wins_total == 1 and pool.hedger.cancelled_total == 1
            assert "hedge-1" not in pool._placements and pool.snapshot()["hedge_wins_total"] == 1
        finally:
            pool.stop()

    def test_arm_respects_eligibility(self, params):
        pool = _pool(params, health_cfg=_gray_cfg())
        try:
            for r in pool.replicas:
                r.scheduler.start()
            for _ in range(HedgeController.WARMUP_SAMPLES):
                pool.hedger.note_latency(50.0)
            for rid, kw, armed in (("h-a", dict(), False), ("h-b", dict(max_tokens=99, hedgeable=True), False),
                                   ("h-c", dict(hedgeable=True), True)):
                req, _, done = _request(tsched, [1, 2, 3], rid, **kw)
                assert pool.submit(req)
                placement = pool._placements.get(rid)
                assert placement is None or placement.hedge_eligible == armed
                done.get(timeout=WAIT_S)
        finally:
            pool.stop()

    def test_cancel_reaches_both_copies(self, params):
        pool = _pool(params, health_cfg=_gray_cfg())
        try:
            req, _, done = _request(tsched, [1, 2, 3], "h-x", hedgeable=True)
            assert pool.submit(req)
            pool._hedge_fire("h-x")
            pool.cancel("h-x")
            assert pool._placements["h-x"].cancelled
            for r in pool.replicas:
                r.scheduler.start()
            assert done.get(timeout=WAIT_S) == "cancelled"
        finally:
            pool.stop()


# -- elasticity --------------------------------------------------------------


def _elastic(params, n=1, sched_kw=None):
    return _pool(params, n=n, sched_kw=sched_kw, scheduler_factory=lambda: _sched(params, **(sched_kw or {})))


class TestScale:
    def test_scale_up_mid_traffic(self, params):
        pool = _elastic(params)
        pool.start()
        try:
            started = threading.Event()
            runner, _, runner_done = _request(tsched, [9, 8, 7], "runner", max_tokens=25,
                                              on_token=lambda t: started.set())
            assert pool.submit(runner)
            assert started.wait(timeout=WAIT_S)
            result = pool.scale_to(3)
            assert result["size"] == 3 and len(result["added"]) == 2 and pool.desired_replicas == 3
            dones = []
            for i in range(4):
                req, _, done = _request(tsched, [i + 20, 1], f"post-{i}")
                assert pool.submit(req)
                dones.append(done)
            assert [d.get(timeout=WAIT_S) for d in dones] == ["length"] * 4
            assert runner_done.get(timeout=WAIT_S) == "length"
            # A replica added later shares the weights: no copy was made.
            assert pool.replicas[2].scheduler.params["layers"]["wo"] is pool.replicas[0].scheduler.params["layers"]["wo"]
        finally:
            pool.stop()

    def test_scale_down_drains_a_busy_victim_then_up_again(self, params):
        db = Tsdb()
        pool = _pool(params, sched_kw=dict(max_batch=1), tsdb=db,
                     scheduler_factory=lambda: _sched(params, max_batch=1))
        pool.start()
        try:
            runner_dones = _fill(pool, 2, 40)
            queued, _, queued_done = _request(tsched, [40, 41, 42], "queued")
            assert pool.submit(queued)
            pool._feed_tsdb()
            result = pool.scale_to(1)
            victim = result["drained"][0]
            assert pool.replicas[victim].state == DRAINING and pool.desired_replicas == 1
            for done in runner_dones:
                assert done.get(timeout=WAIT_S) == "length"
            assert queued_done.get(timeout=WAIT_S) == "length"
            pool.check_replicas()
            assert pool.replicas[victim].state == DETACHED and pool.pool_size() == 1 and pool.healthy()
            assert not any(n.startswith(f"engine.replica.{victim}.") for n in db.names())
            added = pool.scale_to(2)["added"]
            assert added == [2]
            req, _, done = _request(tsched, [3, 4, 5], "after")
            assert pool.submit(req)
            assert done.get(timeout=WAIT_S) == "length"
        finally:
            pool.stop()

    def test_no_factory_cannot_grow(self, params):
        pool = _pool(params, n=1)
        with pytest.raises(RuntimeError):
            pool.add_replica()
        assert pool.scale_to(3) == {"size": 1, "added": [], "drained": []}


def test_snapshot_aggregates_and_breaks_down(params):
    pool = _pool(params, policy="round_robin")
    pool.start()
    try:
        for i in range(4):
            req, _, done = _request(tsched, [i + 1, 2], f"agg-{i}")
            assert pool.submit(req)
            assert done.get(timeout=WAIT_S) == "length"
        snap = pool.stats.snapshot()
    finally:
        pool.stop()
    assert snap["requests_total"] == 4 and snap["tokens_total"] == 12
    assert [r["requests_total"] for r in snap["replicas"]] == [2, 2]
    assert snap["ttft_avg_ms"] > 0 and snap["ttft_p50_ms"] > 0 and snap["router_policy"] == "round_robin"
    assert set(jreplica.EnginePool._SUM_KEYS) <= set(snap)


def test_pool_without_schedulers_refused():
    with pytest.raises(ValueError):
        EnginePool([])


def test_concurrent_submit_and_cancel_each_finish_once(params):
    """Eight client threads submit and cancel at once, with the interpreter
    switching threads every 10 us, while the monitor and both tick threads
    run: every request gets exactly one terminal callback and the pool's
    placement table ends empty."""
    import sys

    pool = _pool(params, policy="least_loaded", health_interval=0.01)
    finishes: dict = {}
    lock = threading.Lock()

    def on_done(rid, reason):
        with lock:
            finishes.setdefault(rid, []).append(reason)

    def client(c):
        for i in range(10):
            rid = f"c{c}-{i}"
            req, _, _ = _request(tsched, [c + 2, i + 3, 7], rid, max_tokens=4)
            req.on_done = lambda reason, rid=rid: on_done(rid, reason)
            assert pool.submit(req)
            if i % 3 == 0:
                pool.cancel(rid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    pool.start()
    try:
        clients = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in clients)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and len(finishes) < 80:
            time.sleep(0.01)
    finally:
        sys.setswitchinterval(old)
        pool.stop()
    assert len(finishes) == 80 and all(len(r) == 1 for r in finishes.values())
    assert {r[0] for r in finishes.values()} <= {"length", "cancelled"}
    assert not pool._placements
