"""The port's offline ``LlamaGenerator`` against the JAX package's, on the
CPU, mirroring ``tests/test_engine.py::TestGenerator`` and its serving
cases: the same numpy-seeded params (``params_from_numpy``) and prompts
give the same greedy token ids in both packages, on the default float
cache (f32 in these configs) and on the int8 cache with the W8A8 route.
Greedy ids are compared exactly."""

import queue

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine.generator import LlamaGenerator as JGenerator
from generativeaiexamples_tpu.engine.sampler import SamplingParams as JSampling
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.generator import GenerationResult, LlamaGenerator
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama

JCFG = jllama.llama_tiny(dtype="float32", max_seq_len=128)
TCFG = tllama.llama_tiny(dtype="float32", max_seq_len=128)
GREEDY = SamplingParams(temperature=0.0, max_tokens=6)
JGREEDY = JSampling(temperature=0.0, max_tokens=6)


@pytest.fixture(scope="module")
def raw():
    return jllama.init_params(JCFG, jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def tparams(raw):
    return params_from_numpy(jax.tree.map(np.asarray, raw), TCFG, "cpu")


def _gen(tparams, **kw):
    return LlamaGenerator(TCFG, tparams, device="cpu", max_len=128, **kw)


def test_greedy_deterministic_and_equal_to_jax(raw, tparams):
    gen = _gen(tparams, max_batch=2)
    r1 = gen.generate([[1, 2, 3]], SamplingParams(temperature=0.0, max_tokens=8))
    r2 = gen.generate([[1, 2, 3]], SamplingParams(temperature=0.0, max_tokens=8))
    assert isinstance(r1[0], GenerationResult)
    assert r1[0].token_ids == r2[0].token_ids and len(r1[0].token_ids) == 8 and r1[0].finish_reason == "length"
    ref = JGenerator(JCFG, raw, max_batch=2, max_len=128).generate([[1, 2, 3]], JSampling(temperature=0.0,
                                                                                            max_tokens=8))
    assert r1[0].token_ids == ref[0].token_ids


def test_batch_matches_single(tparams):
    gen = _gen(tparams, max_batch=4)
    solo_a = gen.generate([[5, 6, 7]], GREEDY)[0].token_ids
    solo_b = gen.generate([[9, 10]], GREEDY)[0].token_ids
    both = gen.generate([[5, 6, 7], [9, 10]], GREEDY)
    assert both[0].token_ids == solo_a and both[1].token_ids == solo_b


def test_streaming_callback_order_and_eos(tparams):
    gen = _gen(tparams, max_batch=2)
    seen: list = []
    res = gen.generate([[1, 2]], SamplingParams(temperature=0.0, max_tokens=5), stream_cb=lambda i, t: seen.append(t))
    assert seen == res[0].token_ids
    eos = res[0].token_ids[0]
    stopped = gen.generate([[1, 2]], SamplingParams(temperature=0.0, max_tokens=50), eos_id=eos)[0]
    assert stopped.finish_reason == "stop" and stopped.token_ids == []
    mixed = gen.generate([[1, 2, 3], [4, 5]], [SamplingParams(temperature=0.0, max_tokens=2),
                                               SamplingParams(temperature=0.0, max_tokens=7)])
    assert [len(r.token_ids) for r in mixed] == [2, 7]


def test_row_chunked_prefill_equals_one_shot_and_jax(raw, tparams):
    prompts = [[3, 1, 4, 1], [5, 9, 2], [6, 5], [3, 5, 8, 9]]
    one = _gen(tparams, max_batch=4).generate(prompts, GREEDY)
    chunked = _gen(tparams, max_batch=4, prefill_chunk=2).generate(prompts, GREEDY)
    ref = JGenerator(JCFG, raw, max_batch=4, max_len=128, prefill_chunk=2).generate(prompts, JGREEDY)
    assert [r.token_ids for r in one] == [r.token_ids for r in chunked] == [r.token_ids for r in ref]


def test_packed_equals_unpacked(tparams):
    prompt = [[3, 1, 4]]
    plain = _gen(tparams, max_batch=1, pack=False)
    packed = _gen(tparams, max_batch=1, pack=True)
    assert "wq" in plain.params["layers"] and "wqkv" in packed.params["layers"]
    assert plain.generate(prompt, GREEDY)[0].token_ids == packed.generate(prompt, GREEDY)[0].token_ids


def test_scheduler_equals_generator(tparams):
    """The reference's promise (``tests/test_scheduler.py``): the same
    params and cache dtype give the same greedy ids through both."""
    prompts = [[1, 2, 3, 4], list(range(10, 40))]
    want = [r.token_ids for r in _gen(tparams, max_batch=4).generate(prompts, GREEDY)]
    sched = tsched.Scheduler(TCFG, tparams, device="cpu", max_batch=4, max_len=128, decode_chunk_size=4)
    sched.start()
    try:
        got = []
        for p in prompts:
            toks, done = [], queue.Queue()
            sched.submit(tsched.Request(token_ids=p, sampling=GREEDY, on_token=toks.append, on_done=done.put))
            done.get(timeout=120)
            got.append(toks)
    finally:
        sched.stop()
    assert got == want


def test_w8a8_route_on_the_int8_cache_equals_jax(raw):
    """``quantize=True, matmul_kernel="pallas_w8a8"`` over an int8 cache:
    the blocked W8A8 projections, the append-buffer decode."""
    jcfg = jllama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
    tcfg = tllama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11]]
    ref = JGenerator(jcfg, raw, max_batch=2, max_len=128, quantize=True, matmul_kernel="pallas_w8a8",
                     decode_chunk_size=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
        want = [r.token_ids for r in ref.generate(prompts, JGREEDY)]
    gen = LlamaGenerator(tcfg, params_from_numpy(jax.tree.map(np.asarray, raw), tcfg, "cpu"), device="cpu",
                         max_batch=2, max_len=128, quantize=True, matmul_kernel="pallas_w8a8", decode_chunk_size=4)
    assert gen.matmul_kernel == "pallas_w8a8"
    assert [r.token_ids for r in gen.generate(prompts, GREEDY)] == want


def test_generator_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaGenerator(TCFG, None, max_batch=1)
