"""The port's Scheduler on the paged KV layout, on the CPU.

Greedy token streams of the paged scheduler equal the JAX paged
scheduler's and the port's contiguous scheduler's on six admission paths
(cold, chunked, graft_warm, graft, regraft, regraft_long), with the same
int8 W8A8 weights.  The JAX side runs the append-buffer protocol and
exact candidate selection (``GAIE_FORCE_APPEND_BUFFER`` /
``GAIE_EXACT_SAMPLING``), which is what the port always runs; it runs once
per module.  Beside parity: a paged graft launches no device work, two
sessions on one prefix stay isolated by copy-on-write, pool pressure
evicts parked segments without deadlock, and the pool is all free once
every parked segment is dropped.
"""

import queue

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.paged_kv import PAGE_EVENTS
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama

JCFG = jllama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
TCFG = tllama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
SCHED_KW = dict(max_batch=4, max_len=128, decode_chunk_size=2, prefill_chunk_tokens=8, prefix_cache="shared")
PAGED_KW = dict(kv_layout="paged", kv_page_size=16)
# Long enough to clear Scheduler.MIN_PREFIX (32), so continuations and
# cross-session hits take the graft paths.
PREFIX = [(i * 13) % 256 + 1 for i in range(48)]


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_threads():
    """One large elementwise op before anything else in the module.  The
    first parallel torch op of a process, run right after JAX work, has
    been seen to compute ``exp`` at reduced precision in some of its fresh
    worker threads (~1e-4 relative, that call only); the bitwise
    comparisons here must not see that call."""
    torch.exp(torch.linspace(-5.0, 5.0, 1 << 20)).sum()


@pytest.fixture(scope="module")
def jax_params():
    raw = jdecode.init_random_int8_params(JCFG, jax.random.PRNGKey(0))
    packed = jdecode.prepare_params(JCFG, raw, None, pack=True)
    return jdecode.prepare_params(JCFG, packed, None, matmul_kernel="pallas_w8a8")


@pytest.fixture(scope="module")
def tparams(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params), TCFG, "cpu")


def _collect(mod, scheduler, prompt, max_tokens=5, session_id=""):
    tokens: list[int] = []
    done: "queue.Queue[str]" = queue.Queue()
    scheduler.submit(
        mod.Request(
            token_ids=list(prompt),
            sampling=mod.SamplingParams(temperature=0.0, max_tokens=max_tokens),
            on_token=tokens.append,
            on_done=done.put,
            session_id=session_id,
        )
    )
    return tokens, done.get(timeout=180)


def _run_paths(mod, sched):
    out = {}
    sched.start()
    try:
        out["cold"] = _collect(mod, sched, [1, 2, 3, 4])
        out["chunked"] = _collect(mod, sched, PREFIX)  # parks under no session
        out["graft_warm"] = _collect(mod, sched, PREFIX + [77], session_id="s1")
        out["graft"] = _collect(mod, sched, PREFIX + list(range(60, 75)), session_id="s1")
        out["regraft"] = _collect(mod, sched, PREFIX + [99], session_id="s2")
        out["regraft_long"] = _collect(mod, sched, PREFIX + list(range(80, 92)), session_id="s3")
    finally:
        sched.stop()
    return out


@pytest.fixture(scope="module")
def jax_paged_streams(jax_params):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
        mp.setenv("GAIE_EXACT_SAMPLING", "1")
        sched = jsched.Scheduler(JCFG, jax_params, matmul_kernel="pallas_w8a8", **SCHED_KW, **PAGED_KW)
        return _run_paths(jsched, sched), sched.stats.snapshot()


def _port(tparams, **kw):
    return tsched.Scheduler(TCFG, tparams, device="cpu", **SCHED_KW, **kw)


def test_paged_streams_equal_jax_paged_and_port_contiguous(jax_paged_streams, tparams):
    ref, jsnap = jax_paged_streams
    paged = _port(tparams, **PAGED_KW)
    before = dict(PAGE_EVENTS)
    out = _run_paths(tsched, paged)
    after = dict(PAGE_EVENTS)
    assert out == ref
    assert out == _run_paths(tsched, _port(tparams))
    # The contiguous scheduler's grafts are device copies, and they count.
    assert PAGE_EVENTS["device_graft_dispatch"] > after["device_graft_dispatch"]
    assert ref["cold"][0] and ref["chunked"][0]  # non-degenerate streams
    snap = paged.stats.snapshot()
    for key in ("prefix_hits", "shared_prefix_hits", "prefill_chunks"):
        assert snap[key] == jsnap[key], key
    assert snap["shared_prefix_hits"] >= 2 and snap["prefix_hits"] >= 1
    # Every graft was a host table copy, with no device work.
    assert after["host_grafts"] - before["host_grafts"] == snap["shared_prefix_hits"] + snap["prefix_hits"]
    assert after["device_graft_dispatch"] == before["device_graft_dispatch"]
    assert snap["kv_cow_breaks"] == jsnap["kv_cow_breaks"]
    assert snap["kv_pages_total"] == paged._pool.total_pages and snap["kv_pages_parked"] > 0


def test_cow_isolation_two_sessions_one_prefix(tparams):
    """Two sessions graft the same parked prefix and append divergent
    suffixes; neither sees the other's writes (copy-on-write of the
    boundary page: 40 tokens end mid-page), held by equality with the
    contiguous scheduler."""
    prefix = PREFIX[:40]

    def run(kw):
        out = {}
        sched = _port(tparams, **kw)
        sched.start()
        try:
            out["seed"] = _collect(tsched, sched, prefix, session_id="seed")
            out["a"] = _collect(tsched, sched, prefix + [100], session_id="a")
            out["b"] = _collect(tsched, sched, prefix + [200], session_id="b")
            out["a2"] = _collect(tsched, sched, prefix + [100, 101], session_id="a")
            out["b2"] = _collect(tsched, sched, prefix + [200, 201], session_id="b")
        finally:
            sched.stop()
        return out, sched.stats.snapshot()

    ref, _ = run({})
    before = dict(PAGE_EVENTS)
    paged, snap = run(PAGED_KW)
    assert paged == ref
    assert ref["a"] != ref["b"]  # the suffixes really diverged
    assert snap["kv_cow_breaks"] >= 2 and PAGE_EVENTS["cow_copies"] - before["cow_copies"] == snap["kv_cow_breaks"]


def test_pool_pressure_evicts_parked_and_never_deadlocks(tparams):
    sched = _port(tparams, **PAGED_KW, kv_page_low_water=16)
    sched.start()
    try:
        def prompt(i):  # 96 tokens, a distinct first token per i
            return [(i * 97 + j) % 500 + 1 for j in range(96)]

        # Three long parked sessions: 21 of the 33 pages.
        for i in range(3):
            _, reason = _collect(tsched, sched, prompt(i), 3, session_id=f"s{i}")
            assert reason == "length"
        for i in range(3, 7):
            toks, reason = _collect(tsched, sched, prompt(i), 3, session_id=f"t{i}")
            assert reason == "length" and len(toks) == 3
    finally:
        sched.stop()
    snap = sched.stats.snapshot()
    assert snap["kv_page_evictions"] >= 1
    pool = sched._pool
    assert pool.pages_free + sum(pool.slot_pages(i) for i in range(4)) + 1 <= pool.total_pages


def test_pool_all_free_after_segment_drain(tparams):
    sched = _port(tparams, **PAGED_KW)
    sched.start()
    try:
        _collect(tsched, sched, PREFIX, session_id="a")
        _collect(tsched, sched, PREFIX + [7], session_id="b")
        _collect(tsched, sched, [9] * 40 + list(range(30)), session_id="c")
    finally:
        sched.stop()
    pool = sched._pool
    assert len(sched._free_slots()) == 4  # parking holds pages, not slots
    assert sched._prefix_index.total_pages() > 0
    for seg in list(sched._prefix_index.segments()):
        sched._drop_segment(seg)
    assert sched._prefix_index.total_pages() == 0
    assert not sched._session_segs and not sched._seg_sessions
    assert pool.pages_free == pool.total_pages - 1
    assert int(pool._refcount.sum()) == 1  # the garbage page only


def test_paged_hit_never_takes_a_slot_claimed_by_the_tick_batch(tparams):
    """One free slot, and in one tick a cold prompt (batch admission,
    which claims its slot only at the batch's dispatch) ahead of a prompt
    that hits a parked segment: the hit waits for the next free slot
    instead of taking the batch's, and every request finishes."""
    sched = tsched.Scheduler(TCFG, tparams, device="cpu", **dict(SCHED_KW, max_batch=2), **PAGED_KW)
    done: dict[str, str] = {}

    def submit(name, prompt, max_tokens):
        sched.submit(tsched.Request(
            token_ids=list(prompt), sampling=tsched.SamplingParams(temperature=0.0, max_tokens=max_tokens),
            on_token=lambda t: None, on_done=lambda r, name=name: done.__setitem__(name, r)))

    def tick_until(cond, limit=200):
        for _ in range(limit):
            if cond():
                return
            sched._tick()
        raise AssertionError(f"not reached in {limit} ticks: {done}")

    with torch.inference_mode():
        submit("seed", PREFIX, 3)
        tick_until(lambda: "seed" in done)
        submit("long", [5, 6, 7], 40)  # holds one slot while the others run
        tick_until(lambda: any(s.request is not None for s in sched._slots))
        submit("cold", [1, 2, 3], 3)
        submit("hit", PREFIX + [42], 3)
        tick_until(lambda: {"cold", "hit", "long"} <= set(done))
    assert done == {"seed": "length", "long": "length", "cold": "length", "hit": "length"}
    assert sched.stats.snapshot()["shared_prefix_hits"] == 1


def test_paged_scheduler_arguments_and_gauges(tparams):
    with pytest.raises(ValueError, match="power of two"):
        _port(tparams, kv_layout="paged", kv_page_size=48)
    with pytest.raises(ValueError, match="kv_layout"):
        _port(tparams, kv_layout="ring")
    sched = _port(tparams, **PAGED_KW, kv_pool_pages=100)
    snap = sched.stats.snapshot()
    assert snap["kv_pages_total"] == 100 and snap["kv_pages_free"] == 99
    assert _port(tparams).stats.snapshot()["kv_pages_total"] == 0
