"""A 2-replica pool on the card: Llama-3-8B's width at 2 layers, random
W8A8 weights shared by both replicas, each with its own int8 KV cache.
Its greedy streams (all prompts at once, then each alone) equal one
scheduler's on the same params, and K1, K2 and K4 launch in the pool.

A CUDA kernel has no CPU mode, so this test skips without a card (the
decision is made inside the fixture).  On a machine with one:

    python -m pytest --noconftest tests/test_torch_pool_cuda.py -q
"""

import dataclasses
import queue

import pytest
import torch

from generativeaiexamples_tpu_torch.engine.decode import w8a8_params
from generativeaiexamples_tpu_torch.engine.replica import EnginePool
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import _cuda

pytestmark = pytest.mark.cuda

# No prefix cache: every stream is a cold prefill's, whichever replica
# takes it (a graft and a cold prefill round differently).
KW = dict(max_batch=8, max_len=1024, decode_chunk_size=8, prefill_chunk_tokens=256, matmul_kernel="pallas_w8a8",
          prefix_cache="off")
PROMPT_LENGTHS = (20, 48, 140, 300, 650, 33)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _streams(engine, prompts, max_tokens=16):
    out, dones = {}, []
    for i, prompt in enumerate(prompts):
        done: "queue.Queue[str]" = queue.Queue()
        out[i] = []
        assert engine.submit(Request(token_ids=prompt, sampling=SamplingParams(temperature=0.0, max_tokens=max_tokens),
                                     on_token=out[i].append, on_done=done.put, id=f"r{i}"))
        dones.append(done)
    assert [d.get(timeout=300) for d in dones] == ["length"] * len(prompts)
    for i, prompt in enumerate(prompts):
        done = queue.Queue()
        out[f"alone-{i}"] = []
        engine.submit(Request(token_ids=prompt, sampling=SamplingParams(temperature=0.0, max_tokens=max_tokens),
                              on_token=out[f"alone-{i}"].append, on_done=done.put, id=f"a{i}"))
        assert done.get(timeout=300) == "length"
    return out


def test_pool_streams_equal_one_scheduler_on_the_card(dev):
    cfg = dataclasses.replace(llama.llama3_8b(kv_dtype="int8"), n_layers=2)
    with torch.inference_mode():
        params = w8a8_params(cfg, None, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator().manual_seed(1)
    prompts = [[1] + torch.randint(3, 255, (n - 1,), generator=g).tolist() for n in PROMPT_LENGTHS]
    pool = EnginePool([Scheduler(cfg, params, device=dev, **KW) for _ in range(2)], policy="round_robin",
                      health_interval=0.5)
    _cuda.reset_launch_counts()
    pool.start()
    try:
        got = _streams(pool, prompts)
        placed = [r["requests_total"] for r in pool.snapshot()["replicas"]]
        assert pool.failovers_total == 0 and pool.healthy()
    finally:
        pool.stop()
    launches = dict(_cuda.LAUNCHES)
    single = Scheduler(cfg, params, device=dev, **KW)
    single.start()
    try:
        want = _streams(single, prompts)
    finally:
        single.stop()
    assert got == want and all(got[i] for i in range(len(prompts)))
    assert min(placed) > 0
    assert launches["qmm"] and launches["decode_attention"] and launches["flash_attention"]
    assert pool.replicas[1].scheduler.params is pool.replicas[0].scheduler.params or \
        pool.replicas[1].scheduler.params["layers"]["wo"] is pool.replicas[0].scheduler.params["layers"]["wo"]
