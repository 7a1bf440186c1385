"""The port's Llama forward against the JAX reference on the CPU.

Same packed, pre-blocked int8 params (converted with
``params_from_numpy``) and the same tokens go through both: cold prefill
hidden states and logits, one append-buffer decode step, and three decode
chunks through each package's ``make_decode_chunk_fn``.  Logits agree
within 1e-4 (f32, summation order), greedy tokens exactly, and the int8
KV cache exactly except where a rounding tie moved one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.engine import decode as tdecode
from generativeaiexamples_tpu_torch.engine.weights import cache_from_numpy, params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama

JCFG = jllama.llama_tiny(dtype="float32", kv_dtype="int8")
TCFG = tllama.llama_tiny(dtype="float32", kv_dtype="int8")
T = 64
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def both_params():
    raw = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    jp = jdecode.prepare_params(JCFG, raw, None, quantize=True, pack=True, matmul_kernel="pallas_w8a8")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    return jp, tp


def _np_cache(cache):
    return [np.asarray(c).astype(np.float32) for c in cache]


def _assert_cache_close(jc, tc):
    j = _np_cache(jc)
    t = [c.float().numpy() for c in tc]
    for a, b in zip(j[:2], t[:2]):  # int8 values: exact but for moved ties
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for a, b in zip(j[2:], t[2:]):  # bf16 scales
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-6)


@pytest.fixture(scope="module")
def cold(both_params):
    jp, tp = both_params
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, JCFG.vocab_size, (2, 16)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    positions = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jh, jc = jllama.forward(
        jp, JCFG, jnp.asarray(tokens), jnp.asarray(positions),
        jllama.init_kv_cache(JCFG, 2, T), jnp.asarray(lengths), cold_prefill=True,
    )
    th, tc = tllama.forward(
        tp, TCFG, torch.from_numpy(tokens).long(), torch.from_numpy(positions.copy()),
        tllama.init_kv_cache(TCFG, 2, T, device="cpu"), torch.from_numpy(lengths), cold_prefill=True,
    )
    return tokens, lengths, (jh, jc), (th, tc)


def test_cold_prefill_hidden_logits_and_cache(both_params, cold):
    jp, tp = both_params
    tokens, lengths, (jh, jc), (th, tc) = cold
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(th[r, :n].numpy(), np.asarray(jh)[r, :n], **TOL)
    jl = np.asarray(jllama.logits(jp, jh))
    tl = tllama.logits(tp, th).numpy()
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(tl[r, :n], jl[r, :n], **TOL)
    _assert_cache_close(jc, tc)


def test_append_buffer_step_and_decode_chunks(both_params, cold, monkeypatch):
    monkeypatch.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    monkeypatch.setenv("GAIE_EXACT_SAMPLING", "1")
    jp, tp = both_params
    tokens, lengths, (jh, jc), _ = cold
    jl = np.asarray(jllama.logits(jp, jh))
    first = np.array([jl[r, n - 1].argmax() for r, n in enumerate(lengths)], np.int32)
    tc = cache_from_numpy([np.asarray(c) for c in jc], "cpu")  # start from the same cache

    # One append-buffer step, logits compared directly.
    ab_shape = (JCFG.n_layers, JCFG.n_kv_heads, 2, 2, JCFG.head_dim)
    jab = (jnp.zeros(ab_shape, jnp.int8), jnp.zeros(ab_shape, jnp.int8),
           jnp.zeros(ab_shape[:-1], jnp.bfloat16), jnp.zeros(ab_shape[:-1], jnp.bfloat16))
    tab = tuple(torch.zeros(a.shape, dtype=d) for a, d in zip(
        jab, (torch.int8, torch.int8, torch.bfloat16, torch.bfloat16)))
    pos = lengths[:, None]
    jh1, _, jab1 = jllama.forward(
        jp, JCFG, jnp.asarray(first[:, None]), jnp.asarray(pos), jc, jnp.asarray(lengths),
        kv_bucket=32, append_cache=(jab, 0),
    )
    th1, _, tab1 = tllama.forward(
        tp, TCFG, torch.from_numpy(first[:, None]).long(), torch.from_numpy(pos), tc,
        torch.from_numpy(lengths), kv_bucket=32, append_cache=(tab, 0),
    )
    np.testing.assert_allclose(
        tllama.logits(tp, th1).numpy(), np.asarray(jllama.logits(jp, jh1)), **TOL
    )
    assert np.array_equal(np.asarray(jab1[0]), tab1[0].numpy())

    # Three decode chunks of two steps through both chunk functions.
    jfn = jdecode.make_decode_chunk_fn(JCFG, None, T)
    tfn = tdecode.make_decode_chunk_fn(TCFG, T)
    temp, top_p, top_k = np.zeros(2, np.float32), np.ones(2, np.float32), np.zeros(2, np.int32)
    jcache, tcache = jc, cache_from_numpy([np.asarray(c) for c in jc], "cpu")
    jtok, ttok = first, torch.from_numpy(first)
    jlen = lengths.copy()
    gen = torch.Generator().manual_seed(0)
    for chunk in range(3):
        jcache, jtoks = jfn(
            jp, jcache, jnp.asarray(jtok), jnp.asarray(jlen), jax.random.PRNGKey(chunk),
            jnp.asarray(temp), jnp.asarray(top_p), jnp.asarray(top_k), 2, 32,
        )
        tcache, ttoks = tfn(
            tp, tcache, ttok, torch.from_numpy(jlen), gen, torch.from_numpy(temp),
            torch.from_numpy(top_p), torch.from_numpy(top_k), 2, 32,
        )
        jtoks = np.asarray(jtoks)
        assert np.array_equal(jtoks, ttoks.numpy()), (chunk, jtoks, ttoks)
        jtok, ttok = jtoks[-1], ttoks[-1]
        jlen = jlen + 2
    _assert_cache_close(jcache, tcache)


def test_prepare_params_lays_out_a_float_tree_as_the_reference(both_params):
    """A float tree through the port's prepare_params (quantize, pack,
    block) gives the same int8 leaves as the reference's prepare_params."""
    _, tp = both_params
    raw = params_from_numpy(jax.tree.map(np.asarray, jllama.init_params(JCFG, jax.random.PRNGKey(0))), TCFG, "cpu")
    assert isinstance(raw["layers"]["wq"], torch.Tensor)
    out = tdecode.prepare_params(TCFG, raw, device="cpu", quantize=True, pack=True, matmul_kernel="pallas_w8a8")
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        assert torch.equal(out["layers"][name].w, tp["layers"][name].w), name
        assert torch.equal(out["layers"][name].scale, tp["layers"][name].scale), name
    for name in ("embed", "lm_head"):
        assert torch.equal(out[name].q, tp[name].q) and torch.equal(out[name].scale, tp[name].scale), name
    assert out["lm_head"].q.dtype == TCFG.compute_dtype
    again = tdecode.prepare_params(TCFG, out, device="cpu", quantize=True, pack=True, matmul_kernel="pallas_w8a8")
    assert again["layers"]["wo"] is out["layers"]["wo"]
