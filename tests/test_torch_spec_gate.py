"""The speculative steps' bit-for-bit gate at a pinned lookahead, on the CPU.

``chip_smoke.py``'s ``spec`` phase holds the greedy streams of its
speculating schedulers to each other bit for bit when no draft was
accepted.  That premise needs every round at the same lookahead: with
``adaptive_gamma`` the chunk's gamma follows the most hopeful active lane,
and which lanes are active follows when the requests arrive.  With
``adaptive_gamma=False`` every round runs at ``gamma``, so an n-gram
scheduler and a draft scheduler whose drafts are never accepted emit the
same greedy streams, whether the requests arrive together or one after
another.
"""

import dataclasses
import queue
import threading

import pytest
import torch

from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.decode import w8a8_params
from generativeaiexamples_tpu_torch.models import llama

CFG = llama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
DCFG = dataclasses.replace(CFG, n_layers=1, n_heads=2, n_kv_heads=2, head_dim=32)
KW = dict(device="cpu", max_batch=4, max_len=128, decode_chunk_size=4, prefill_chunk_tokens=None,
          prefix_cache="off", matmul_kernel="pallas_w8a8", gamma=3, adaptive_gamma=False)
PROMPTS = [[1, 5, 9, 14, 2, 7], [3, 3, 8, 1], list(range(10, 31)), [40, 41, 42, 40, 41, 42, 40, 41]]
MAX_TOKENS = 14


@pytest.fixture(scope="module")
def weights():
    target = w8a8_params(CFG, None, device="cpu", generator=torch.Generator().manual_seed(11))
    draft = w8a8_params(DCFG, None, device="cpu", generator=torch.Generator().manual_seed(12))
    # A zero final-norm gain zeroes the draft's hidden state: every logit
    # is 0 and each proposal is the same id, which the target never picks
    # here (the test checks that no draft was accepted).
    draft = {**draft, "final_norm": torch.zeros_like(draft["final_norm"])}
    return target, draft


def _streams(sched, staggered: bool):
    outs = [[] for _ in PROMPTS]
    done: "queue.Queue[str]" = queue.Queue()
    sched.start()
    try:
        for i, prompt in enumerate(PROMPTS):
            first = threading.Event()

            def on_token(tid, toks=outs[i], ev=first):
                toks.append(tid)
                ev.set()

            sched.submit(tsched.Request(token_ids=list(prompt),
                                        sampling=tsched.SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0),
                                        on_token=on_token, on_done=done.put))
            if staggered:
                # The next request arrives while this one decodes.
                assert first.wait(timeout=120)
        reasons = [done.get(timeout=180) for _ in PROMPTS]
    finally:
        sched.stop()
    assert reasons == ["length"] * len(PROMPTS)
    return outs


@pytest.mark.parametrize("staggered", [False, True], ids=["together", "staggered"])
def test_pinned_lookahead_streams_equal_bit_for_bit(weights, staggered):
    target, draft = weights
    ngram = tsched.Scheduler(CFG, target, spec_mode="ngram", **KW)
    drafted = tsched.Scheduler(CFG, target, draft_cfg=DCFG, draft_params=draft, **KW)
    got_ngram = _streams(ngram, staggered)
    got_draft = _streams(drafted, staggered)
    snap = drafted.stats.snapshot()
    assert snap["spec_rounds"] > 0 and snap["spec_proposed"] > 0
    assert snap["spec_accepted"] == 0, "the premise: the draft's proposals are never accepted"
    assert ngram.stats.snapshot()["spec_gamma"] == drafted.stats.snapshot()["spec_gamma"] == KW["gamma"]
    assert got_draft == got_ngram
    # And both equal the plain scheduler's greedy streams.
    plain_kw = {k: v for k, v in KW.items() if k not in ("gamma", "adaptive_gamma")}
    assert _streams(tsched.Scheduler(CFG, target, **plain_kw), staggered) == got_ngram
