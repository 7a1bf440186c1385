"""Two ranks on one card: the staged transport and the mesh engine.

Two processes share ``cuda:0`` (NCCL refuses two ranks on one GPU, so the
mesh's collectives are staged through a host buffer both ranks map,
``parallel.comm.SharedLine``).  Each case holds the two-rank result
against one rank on the same card: the collectives bit for bit, the
tensor-parallel forward and the scheduler's greedy streams on a small
bf16 model with an int8 cache.

These skip without a card (the decision is made inside the fixture).  On a
card, from the repository root:

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py -q
"""

import queue

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def mesh(dev):
    from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    m = make_mesh(MeshSpec(tensor=2), [dev, dev], timeout_s=60.0)
    yield m
    m.close()


def _collectives(ctx, x):
    from generativeaiexamples_tpu_torch.parallel.comm import COMM_STATS

    group = ctx.groups["tensor"]
    t = torch.from_numpy(x).to(ctx.device) * (ctx.rank + 1)
    staged0 = COMM_STATS["staged_bytes"]
    out = {
        "psum": ctx.psum(t, "tensor").cpu().numpy(),
        "psum_bf16": ctx.psum(t.bfloat16(), "tensor").float().cpu().numpy(),
        "gather": ctx.all_gather(t, "tensor", dim=1).cpu().numpy(),
        "a2a": ctx.all_to_all(t, "tensor", 0, 1).cpu().numpy(),
        "perm": ctx.ppermute(t, "tensor", [(0, 1), (1, 0)]).cpu().numpy(),
        "bcast": ctx.broadcast(t.bfloat16(), "tensor", 1).float().cpu().numpy(),
        "rs": ctx.reduce_scatter(t, "tensor", 0).cpu().numpy(),
    }
    out["staged_bytes"] = COMM_STATS["staged_bytes"] - staged0
    out["transport"] = group.transport
    out["shared"] = group.shared is not None
    # 36 MB of f32: two rounds of the shared line's 32 MB regions.
    out["big"] = ctx.psum(torch.full((9 << 20,), float(ctx.rank + 1), device=ctx.device), "tensor")[[0, -1]].tolist()
    return out


def test_staged_collectives_equal_their_definitions(mesh):
    """Two ranks on one card stage every collective through their shared
    line (registered with CUDA)."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6) / 7
    got = mesh.run(_collectives, x, gather=True)
    for rank, out in enumerate(got):
        assert out["transport"] == "staged" and out["shared"] and out["staged_bytes"] > 0
        np.testing.assert_array_equal(out["psum"], x * 1 + x * 2)
        np.testing.assert_array_equal(out["gather"], np.concatenate([x, 2 * x], axis=1))
        blocks = [np.split(x * (r + 1), 2, axis=0)[rank] for r in range(2)]
        np.testing.assert_array_equal(out["a2a"], np.concatenate(blocks, axis=1))
        np.testing.assert_array_equal(out["perm"], x * (2 - rank))
        np.testing.assert_array_equal(out["bcast"], torch.from_numpy(2 * x).bfloat16().float().numpy())
        np.testing.assert_array_equal(out["rs"], np.split(x * 1 + x * 2, 2, axis=0)[rank])
        assert out["big"] == [3.0, 3.0]


def _forward(ctx, tree, cfg, tokens):
    from generativeaiexamples_tpu_torch.engine.weights import shard_params
    from generativeaiexamples_tpu_torch.models import llama

    params = shard_params(tree, cfg, ctx.sizes, ctx.coords, ctx.device)
    t = torch.from_numpy(tokens).to(ctx.device).long()
    pos = torch.arange(t.shape[1], dtype=torch.int32, device=ctx.device).expand(t.shape)
    h, _ = llama.forward(params, cfg, t, pos, mesh=ctx)
    return llama.logits(params, h, ctx).cpu()


def _cfg():
    from generativeaiexamples_tpu_torch.models import llama

    return llama.llama_tiny(d_model=512, n_heads=4, n_kv_heads=2, head_dim=128, d_ff=1024, vocab_size=1024,
                            kv_dtype="int8", max_seq_len=512)


def _tree(cfg):
    from generativeaiexamples_tpu_torch.engine.decode import init_random_params
    from generativeaiexamples_tpu_torch.engine.mesh_serving import tree_to_host

    return tree_to_host(init_random_params(cfg, torch.Generator().manual_seed(3), "cpu"))


def _on(tree, dev):
    return {k: _on(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def test_two_rank_forward_equals_one_rank(dev, mesh):
    from generativeaiexamples_tpu_torch.models import llama

    cfg = _cfg()
    tree = _tree(cfg)
    tokens = np.random.default_rng(0).integers(0, 1024, (2, 96)).astype(np.int32)
    got = mesh.run(_forward, tree, cfg, tokens)
    params = _on(tree, dev)
    t = torch.from_numpy(tokens).to(dev).long()
    with torch.inference_mode():
        h, _ = llama.forward(params, cfg, t, torch.arange(96, dtype=torch.int32, device=dev).expand(t.shape))
        want = llama.logits(params, h).cpu()
    # bf16: each rank rounds its wo / w_down partial product before the sum.
    err = (got - want).abs().max().item()
    assert err <= 0.05 * want.abs().max().item(), err


# The two-rank logits' largest difference from one rank's (teacher-forced
# over the streams below): each side's f32 sums run in another order, so an
# element may round one bf16 ulp apart.  Measured on an H100: 0.0004,
# 0.0058 and 0.0073 over the three streams.  A greedy stream may part from
# one rank's only where one rank's top-2 gap is below twice this.
STREAM_LOGIT_TOL = 0.02


def _teacher_forced(params, cfg, prompt, stream, dev):
    """f32 logits of each emitted position of ``stream`` after ``prompt``
    as the scheduler builds the cache: a cold prefill of the prompt into
    the int8 cache, then one warm forward over the stream's tokens."""
    from generativeaiexamples_tpu_torch.models import llama

    plen, n = len(prompt), len(prompt) + len(stream)
    ids = torch.tensor([list(prompt) + list(stream)], device=dev)
    cache = llama.init_kv_cache(cfg, 1, n, device=dev)
    with torch.inference_mode():
        h, _ = llama.forward(params, cfg, ids[:, :plen], torch.arange(plen, dtype=torch.int32, device=dev)[None],
                             cache, torch.tensor([plen], dtype=torch.int32, device=dev), cold_prefill=True)
        rows = [llama.logits(params, h[:, -1:])[0]]
        h, _ = llama.forward(params, cfg, ids[:, plen : n - 1],
                             torch.arange(plen, n - 1, dtype=torch.int32, device=dev)[None], cache,
                             torch.tensor([n - 1], dtype=torch.int32, device=dev))
        rows.append(llama.logits(params, h)[0])
    return torch.cat(rows).float()


def test_two_rank_scheduler_streams_equal_one_rank(dev, mesh):
    """Greedy streams equal up to each stream's first near tie, the rule of
    ``chip_smoke.py``'s ``mesh_serve`` gate: random weights give flat
    logits, so a stream may part where one rank's top-2 gap is below what
    the two ranks' logits may differ by (checked here on the same tokens)."""
    from generativeaiexamples_tpu_torch.engine import mesh_serving
    from generativeaiexamples_tpu_torch.engine import scheduler as ts
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import _cuda

    cfg = _cfg()
    tree = _tree(cfg)
    prompts = [list(range(1, n + 1)) for n in (5, 40, 130)]
    kw = dict(max_batch=4, max_len=512, decode_chunk_size=4, prefill_chunk_tokens=64, prefix_cache="off")

    def streams(sched):
        outs, done = [[] for _ in range(3)], queue.Queue()
        sched.start()
        try:
            for i, prompt in enumerate(prompts):
                sched.submit(ts.Request(token_ids=prompt, on_done=done.put, on_token=outs[i].append,
                                        sampling=ts.SamplingParams(max_tokens=12, temperature=0.0)))
            assert [done.get(timeout=120) for _ in range(3)] == ["length"] * 3
        finally:
            sched.stop()
        return outs

    params = _on(tree, dev)
    want = streams(ts.Scheduler(cfg, params, device=dev, **kw))
    sched = ts.Scheduler(cfg, mesh_serving.RankParams("tree", tree=tree), mesh=mesh, **kw)
    _cuda.reset_launch_counts()
    try:
        got = streams(sched)
    finally:
        sched.release_mesh()
    assert _cuda.LAUNCHES["decode_attention"] and _cuda.LAUNCHES["flash_attention"]
    readings = []
    for prompt, w, g in zip(prompts, want, got):
        tokens = np.array([prompt + w[:-1]], dtype=np.int32)
        two = mesh.run(_forward, tree, cfg, tokens)[0, len(prompt) - 1 :]
        with torch.inference_mode():
            h, _ = llama.forward(params, cfg, torch.from_numpy(tokens).to(dev).long(),
                                 torch.arange(tokens.shape[1], dtype=torch.int32, device=dev)[None])
            one = llama.logits(params, h).cpu()[0, len(prompt) - 1 :]
        err = (two.float() - one.float()).abs().max().item()
        top2 = _teacher_forced(params, cfg, prompt, w, dev).topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        near = next((i for i, gap in enumerate(gaps) if gap < 2 * STREAM_LOGIT_TOL), len(gaps))
        part = next((i for i in range(len(w)) if i >= len(g) or g[i] != w[i]), None)
        readings.append(dict(logit_err=err, first_near_tie=near, first_difference=part, tokens=len(w)))
    print("two ranks against one:", readings)
    assert all(r["logit_err"] <= STREAM_LOGIT_TOL for r in readings), readings
    assert all(r["first_difference"] is None or r["first_difference"] >= r["first_near_tie"] for r in readings), readings
