"""Greedy token streams through the port's Scheduler equal the JAX
Scheduler's on the cold, chunked, graft_warm and graft admission paths,
with the same int8 W8A8 weights and int8 KV.  The JAX side runs the
append-buffer protocol and exact candidate selection
(``GAIE_FORCE_APPEND_BUFFER`` / ``GAIE_EXACT_SAMPLING``), which is what the
port always runs."""

import queue

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama

JCFG = jllama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
TCFG = tllama.llama_tiny(dtype="float32", max_seq_len=128, kv_dtype="int8")
SCHED_KW = dict(max_batch=4, max_len=128, decode_chunk_size=2, prefill_chunk_tokens=8, prefix_cache="shared")


@pytest.fixture(scope="module")
def jax_params():
    raw = jdecode.init_random_int8_params(JCFG, jax.random.PRNGKey(0))
    packed = jdecode.prepare_params(JCFG, raw, None, pack=True)
    return jdecode.prepare_params(JCFG, packed, None, matmul_kernel="pallas_w8a8")


def _collect(mod, scheduler, prompt, max_tokens, session_id=""):
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
    return tokens, done.get(timeout=120)


def _run_paths(mod, sched):
    out = {}
    sched.start()
    try:
        out["cold"] = _collect(mod, sched, [1, 2, 3, 4], 5)
        out["chunked"] = _collect(mod, sched, list(range(2, 26)), 10)
        out["graft_warm"] = _collect(mod, sched, [7, 8, 9], 4, session_id="s1")
        out["graft"] = _collect(mod, sched, [7, 8, 9, 10, 11], 4, session_id="s1")
        # The chunked request parked its 33-token history (prompt + all but
        # the last emitted token); a prompt extending it past MIN_PREFIX
        # takes the cross-request shared-prefix graft.
        history = list(range(2, 26)) + out["chunked"][0][:9]
        out["shared"] = _collect(mod, sched, history + [100, 101], 4)
    finally:
        sched.stop()
    return out


def test_greedy_streams_equal_jax(monkeypatch, jax_params):
    monkeypatch.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    monkeypatch.setenv("GAIE_EXACT_SAMPLING", "1")
    jax_sched = jsched.Scheduler(JCFG, jax_params, matmul_kernel="pallas_w8a8", **SCHED_KW)
    ref = _run_paths(jsched, jax_sched)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jax_params), TCFG, "cpu")
    port = tsched.Scheduler(TCFG, tparams, device="cpu", **SCHED_KW)
    assert port.matmul_kernel == "w8a8"
    out = _run_paths(tsched, port)
    assert out == ref
    assert ref["cold"][0] and ref["chunked"][0]
    for sched in (jax_sched, port):
        snap = sched.stats.snapshot()
        assert snap["prefill_chunks"] > 0 and snap["shared_prefix_hits"] == 1


def test_scheduler_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsched.Scheduler(TCFG, None, **SCHED_KW)
