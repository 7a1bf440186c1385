"""Speculation with a float (the reference's bf16) draft on the CPU: the
port's offline ``SpeculativeGenerator`` against the JAX package's and
against target-only greedy decoding (``tests/test_speculative.py::
TestSpeculativeExactness``), and the port's ``Scheduler`` with a float
draft over the float target cache against the plain schedulers
(``TestSchedulerSpeculation``'s draft cases).  Same numpy-seeded params in
both packages (``params_from_numpy``); greedy ids are compared exactly."""

import queue
import threading

import jax
import numpy as np
import pytest

from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.engine.speculative import SpeculativeGenerator as JSpec
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.generator import LlamaGenerator
from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
from generativeaiexamples_tpu_torch.engine.speculative import SpeculativeGenerator
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama

DRAFT_GEOMETRY = dict(max_seq_len=128, n_layers=1, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2, head_dim=32)
JT = jllama.llama_tiny(dtype="float32", max_seq_len=128)
JD = jllama.llama_tiny(dtype="float32", **DRAFT_GEOMETRY)
TT = tllama.llama_tiny(dtype="float32", max_seq_len=128)
TD = tllama.llama_tiny(dtype="float32", **DRAFT_GEOMETRY)
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]


def _port(tree, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu")


@pytest.fixture(scope="module")
def pair():
    jt = jllama.init_params(JT, jax.random.PRNGKey(0))
    jd = jllama.init_params(JD, jax.random.PRNGKey(99))
    return jt, jd, _port(jt, TT), _port(jd, TD)


def _reference(tparams, prompts, max_tokens, eos_id=None):
    gen = LlamaGenerator(TT, tparams, device="cpu", max_batch=len(prompts), max_len=128)
    return [r.token_ids for r in gen.generate(prompts, SamplingParams(temperature=0.0, max_tokens=max_tokens),
                                              eos_id=eos_id)]


def test_weak_draft_gives_the_target_greedy_output_and_jax_s(pair):
    jt, jd, tt, td = pair
    spec = SpeculativeGenerator(TT, TD, tt, td, device="cpu", max_batch=len(PROMPTS), max_len=128, gamma=4)
    got = spec.generate(PROMPTS, max_tokens=12)
    assert got == _reference(tt, PROMPTS, 12)
    ref = JSpec(JT, JD, jt, jd, max_batch=len(PROMPTS), max_len=128, gamma=4)
    assert got == ref.generate(PROMPTS, max_tokens=12)
    assert spec.stats["rounds"] >= 1 and spec.stats["proposed"] >= 4 * spec.stats["rounds"]
    assert 0 <= spec.stats["accepted"] <= spec.stats["proposed"]
    assert spec.stats["emitted"] == sum(len(g) for g in got)


def test_self_draft_accepts_everything(pair):
    _, _, tt, _ = pair
    spec = SpeculativeGenerator(TT, TT, tt, tt, device="cpu", max_batch=1, max_len=128, gamma=4, pack=False)
    got = spec.generate([PROMPTS[0]], max_tokens=15)
    assert got == _reference(tt, [PROMPTS[0]], 15)
    # 1 prefill token + ceil(14 / (gamma + 1)) rounds.
    assert spec.stats["rounds"] <= 3 and spec.stats["accepted"] == spec.stats["proposed"]


def test_eos_stops_mid_round(pair):
    _, _, tt, td = pair
    eos = _reference(tt, [PROMPTS[0]], 12)[0][5]
    want = _reference(tt, [PROMPTS[0]], 12, eos_id=eos)
    spec = SpeculativeGenerator(TT, TD, tt, td, device="cpu", max_batch=1, max_len=128, gamma=3)
    assert spec.generate([PROMPTS[0]], max_tokens=12, eos_id=eos) == want == [_reference(tt, [PROMPTS[0]], 5)[0]]


def test_vocab_mismatch_is_refused():
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeGenerator(TT, tllama.llama_tiny(vocab_size=77), device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        tsched.Scheduler(TT, None, device="cpu", max_batch=2, max_len=128, draft_cfg=tllama.llama_tiny(vocab_size=77))


def _collect(mod, sched, prompt, max_tokens, eos_id=None):
    tokens: list[int] = []
    done: "queue.Queue[str]" = queue.Queue()
    sched.submit(mod.Request(token_ids=list(prompt), sampling=mod.SamplingParams(temperature=0.0,
                                                                                 max_tokens=max_tokens),
                             on_token=tokens.append, on_done=done.put, eos_id=eos_id))
    return tokens, done.get(timeout=120)


def _serve(mod, sched, fn):
    sched.start()
    try:
        return fn()
    finally:
        sched.stop()


KW = dict(max_batch=4, max_len=128, decode_chunk_size=4)


def test_scheduler_with_a_float_draft_equals_the_plain_schedulers(pair):
    """A weak float draft over the float target cache: the greedy streams
    of the plain JAX scheduler, alone and concurrent, and eos mid-round."""
    jt, _, tt, td = pair
    plain = jsched.Scheduler(JT, jt, **KW)
    want = _serve(jsched, plain, lambda: [_collect(jsched, plain, p, 10)[0] for p in PROMPTS])
    spec = tsched.Scheduler(TT, tt, device="cpu", draft_cfg=TD, draft_params=td, gamma=4, **KW)
    assert spec.draft_params["layers"]["wqkv"].dtype == spec._dcache[0].dtype

    def run():
        solo = [_collect(tsched, spec, p, 10)[0] for p in PROMPTS]
        results: dict = {}
        workers = [threading.Thread(target=lambda i=i, p=p: results.__setitem__(i, _collect(tsched, spec, p, 10)[0]))
                   for i, p in enumerate(PROMPTS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        eos = solo[0][5]
        stopped = _collect(tsched, spec, PROMPTS[0], 12, eos_id=eos)
        return solo, [results[i] for i in range(len(PROMPTS))], stopped

    solo, together, (stopped, reason) = _serve(tsched, spec, run)
    assert solo == want and together == want
    assert reason == "stop" and stopped == want[0][:5]
    snap = spec.stats.snapshot()
    assert snap["spec_rounds"] > 0 and snap["spec_tokens"] >= snap["spec_rounds"]


def test_scheduler_self_draft_accepts_nearly_everything(pair):
    _, _, tt, _ = pair
    want = _reference(tt, [PROMPTS[0]], 12)[0]
    sched = tsched.Scheduler(TT, tt, device="cpu", draft_cfg=TT, draft_params=tt, gamma=3, **KW)
    got = _serve(tsched, sched, lambda: _collect(tsched, sched, PROMPTS[0], 12)[0])
    assert got == want
    snap = sched.stats.snapshot()
    assert snap["spec_tokens"] / snap["spec_rounds"] > 2.0


def test_draft_quantize_gives_a_weight_only_int8_draft(pair):
    """``draft_quantize=True`` (the reference's option; its default keeps
    the draft float) quantizes the draft's projections to weight-only int8
    on the ``xla`` path, and greedy streams stay the target's."""
    _, _, tt, td = pair
    want = _reference(tt, [PROMPTS[1]], 8)[0]
    sched = tsched.Scheduler(TT, tt, device="cpu", draft_cfg=TD, draft_params=td, gamma=2, draft_quantize=True, **KW)
    assert sched.matmul_kernel == "xla"
    assert type(sched.draft_params["layers"]["wqkv"]).__name__ == "QuantizedMatrix"
    assert _serve(tsched, sched, lambda: _collect(tsched, sched, PROMPTS[1], 8)[0]) == want
