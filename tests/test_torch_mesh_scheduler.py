"""``Scheduler(mesh=...)`` on CPU ranks against the reference's
``Scheduler(mesh=...)`` on the virtual CPU devices and the port's
single-device scheduler.

Greedy streams are equal bit for bit on the cold, chunked, graft_warm,
graft and shared admission paths: on the contiguous cache over ``data=2,
tensor=2`` (slots over data, heads over tensor; the grafts cross data
blocks) and on the paged pool over ``seq=2, tensor=2`` (each rank holds
its KV heads' pages; the cold prefill's attention rings over ``seq``).
The reference serves its mesh contiguous only, so the paged streams are
held to its contiguous ones (the port's layouts are equal bit for bit).
Same weight-only int8 weights (int8 cache) on every side.  Every rank
sampled the same tokens, sampled requests included; speculation over a
mesh is refused; a pool's drained mesh replica frees its rank state; a
follower killed mid-decode fails the requests and does not hang;
``close()`` leaves no process behind.
"""

import queue
import time

import jax
import numpy as np
import pytest
import torch

import torch_mesh_programs as progs
from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.parallel.mesh import MeshSpec as JMeshSpec
from generativeaiexamples_tpu.parallel.mesh import make_mesh as jmake_mesh
from generativeaiexamples_tpu_torch.engine import mesh_serving
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec
from generativeaiexamples_tpu_torch.parallel.runtime import Runtime

TINY = dict(dtype="float32", max_seq_len=128, kv_dtype="int8")
JCFG, TCFG = jllama.llama_tiny(**TINY), tllama.llama_tiny(**TINY)
KW = dict(max_batch=4, max_len=128, decode_chunk_size=4, prefill_chunk_tokens=8, prefix_cache="shared")
PAGED = dict(kv_layout="paged", kv_page_size=16)


@pytest.fixture(scope="module")
def weights():
    jp = jdecode.init_random_int8_params(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    return jp, tree, params_from_numpy(tree, TCFG, "cpu")


@pytest.fixture(scope="module")
def runtime():
    return progs.cpu_ranks()


def _collect(mod, scheduler, prompt, max_tokens=5, session_id="", **sampling):
    tokens: list[int] = []
    done: "queue.Queue[str]" = queue.Queue()
    scheduler.submit(mod.Request(token_ids=list(prompt), on_token=tokens.append, on_done=done.put,
                                 sampling=mod.SamplingParams(max_tokens=max_tokens,
                                                             **{"temperature": 0.0, **sampling}),
                                 session_id=session_id))
    return tokens, done.get(timeout=180)


def _run_paths(mod, sched):
    out = {}
    sched.start()
    try:
        out["cold"] = _collect(mod, sched, [1, 2, 3, 4], 7)
        out["chunked"] = _collect(mod, sched, list(range(2, 26)), 10)
        out["graft_warm"] = _collect(mod, sched, [7, 8, 9, 7, 8, 9, 7, 8], 6, session_id="s1")
        out["graft"] = _collect(mod, sched, [7, 8, 9, 7, 8, 9, 7, 8, 9, 11], 6, session_id="s1")
        # The chunked request parked its 33-token history; a prompt
        # extending it past MIN_PREFIX takes the shared-prefix graft.
        history = list(range(2, 26)) + out["chunked"][0][:9]
        out["shared"] = _collect(mod, sched, history + [100, 101], 6)
    finally:
        sched.stop()
    return out


@pytest.fixture(scope="module")
def jax_streams(weights):
    jp, _, _ = weights
    mesh = jmake_mesh(JMeshSpec(data=2, tensor=2), devices=jax.devices()[:4])
    return _run_paths(jsched, jsched.Scheduler(JCFG, jp, mesh=mesh, **KW))


@pytest.mark.parametrize("layout,spec", [("contiguous", dict(data=2, tensor=2)),
                                         ("paged", dict(seq=2, tensor=2))])
def test_greedy_streams_equal_jax_mesh_and_single_device(weights, runtime, jax_streams, layout, spec):
    _, tree, tp = weights
    kw = PAGED if layout == "paged" else {}
    single = _run_paths(tsched, tsched.Scheduler(TCFG, tp, device="cpu", **KW, **kw))
    mesh = runtime.new_mesh(MeshSpec(**spec).resolve(4))
    sched = tsched.Scheduler(TCFG, mesh_serving.RankParams("tree", tree=tree), mesh=mesh, **KW, **kw)
    try:
        got = _run_paths(tsched, sched)
        assert got == single
        assert got == jax_streams
        assert sched.stats.snapshot()["shared_prefix_hits"] >= 1
        # Every rank sampled the same tokens (a digest of every draw).
        sched.start()
        try:
            sampled = _collect(tsched, sched, [9, 9, 8, 7], 12, temperature=0.8, top_p=0.9)
        finally:
            sched.stop()
        assert sampled[1] == "length" and len(sampled[0]) == 12
        digests = mesh.run(mesh_serving.sampled_digest, sched._mesh_key, gather=True)
        assert len(set(digests)) == 1 and digests[0][1] > 0
    finally:
        sched.release_mesh()


def test_speculation_over_a_mesh_is_refused(weights, runtime):
    mesh = runtime.new_mesh(MeshSpec(data=2, tensor=2).resolve(4))
    with pytest.raises(NotImplementedError, match="10b-iii"):
        tsched.Scheduler(TCFG, None, mesh=mesh, spec_mode="ngram", **KW)
    with pytest.raises(ValueError, match="data must be 1"):
        tsched.Scheduler(TCFG, None, mesh=mesh, **KW, **PAGED)


def test_draining_a_mesh_replica_frees_its_ranks(weights, runtime):
    """A pool detaching a drained mesh replica frees its shards on every
    rank; the other replica's stay."""
    from generativeaiexamples_tpu_torch.engine.replica import EnginePool

    _, tree, _ = weights
    mesh = runtime.new_mesh(MeshSpec(data=2, tensor=2).resolve(4))
    scheds = [tsched.Scheduler(TCFG, mesh_serving.RankParams("tree", tree=tree), mesh=mesh, **KW) for _ in range(2)]
    keys = sorted(s._mesh_key for s in scheds)
    pool = EnginePool(scheds, health_interval=None)
    pool.start()
    try:
        assert mesh.run(progs.state_keys, gather=True) == [keys] * 4
        assert _collect(tsched, scheds[1], [3, 1, 4], 3)[1] == "length"
        assert pool.drain(1) == "detached"
        assert mesh.run(progs.state_keys, gather=True) == [[scheds[0]._mesh_key]] * 4
    finally:
        pool.stop()
        for s in scheds:
            s.release_mesh()
    assert mesh.run(progs.state_keys, gather=True) == [[]] * 4


def test_killed_follower_fails_requests_without_hanging(weights):
    _, tree, _ = weights
    rt = Runtime(["cpu"] * 2, timeout_s=5.0)
    procs = list(rt._procs)
    try:
        mesh = rt.new_mesh(MeshSpec(tensor=2).resolve(2))
        sched = tsched.Scheduler(TCFG, mesh_serving.RankParams("tree", tree=tree), mesh=mesh, **KW)
        sched.start()
        tokens, done = [], queue.Queue()
        first = queue.Queue()

        def on_token(t):
            tokens.append(t)
            first.put(t)

        sched.submit(tsched.Request(token_ids=[1, 2, 3], sampling=tsched.SamplingParams(max_tokens=100000),
                                    on_token=on_token, on_done=done.put))
        first.get(timeout=60)  # decoding
        procs[0].kill()
        t0 = time.perf_counter()
        assert done.get(timeout=30) == "error"
        assert time.perf_counter() - t0 < 5.0 + 10.0
        late = queue.Queue()
        sched.submit(tsched.Request(token_ids=[4], sampling=tsched.SamplingParams(max_tokens=4),
                                    on_token=lambda t: None, on_done=late.put))
        assert late.get(timeout=5) == "error"
        assert not sched.healthy()
        sched.stop()
    finally:
        rt.close()
    assert not any(p.is_alive() for p in procs)
