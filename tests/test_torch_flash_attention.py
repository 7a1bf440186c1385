"""The port's flash attention (``ops/flash_attention.py``) against the JAX
reference: the plain version must match the interpret-mode Pallas kernel
and ``gqa_attention`` within 1e-4 (f32; summation order) on ragged kv
lengths, padded query rows (position -1) and GQA group 4, and fully
masked rows must be exactly zero in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import attention as jatt
from generativeaiexamples_tpu.ops import flash_attention as jfa
from generativeaiexamples_tpu_torch.ops import attention as tatt
from generativeaiexamples_tpu_torch.ops import flash_attention as tfa

BATCH, S, NQ, NKV, HD = 3, 40, 8, 2, 64
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BATCH, S, NQ, HD), dtype=np.float32)
    k = rng.standard_normal((BATCH, S, NKV, HD), dtype=np.float32)
    v = rng.standard_normal((BATCH, S, NKV, HD), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (BATCH, S)).copy()
    pos[1, 30:] = -1  # padded query rows
    kv_lengths = np.array([S, 17, 0], np.int32)  # ragged; row 2 fully masked
    return q, k, v, pos, kv_lengths


@pytest.mark.parametrize("jax_fn", ["interpret", "gqa_attention"])
def test_plain_matches_jax(jax_fn):
    q, k, v, pos, kv_lengths = _inputs()
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, pos, kv_lengths))
    if jax_fn == "interpret":
        ref = jfa.flash_gqa_attention(*jargs, block_q=16, block_k=16, interpret=True)
    else:
        ref = jatt.gqa_attention(*jargs)
    ref = np.asarray(ref)
    out = tfa.flash_gqa_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, kv_lengths)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    for arr in (out.numpy(), ref):
        assert not arr[1, 30:].any()  # padded rows
        assert not arr[2].any()  # no visible key


@pytest.mark.parametrize("nq,nkv", [(4, 4), (8, 1)])
@pytest.mark.parametrize("jax_fn", ["interpret", "gqa_attention"])
def test_plain_matches_jax_at_head_dim_256(nq, nkv, jax_fn):
    """Gemma's head_dim 256 (Gemma-7B's group 1, Gemma-2B's MQA): the plain
    version within 1e-4 of the interpret-mode Pallas kernel and
    ``gqa_attention``, padded and fully masked rows exactly zero."""
    rng = np.random.default_rng(4)
    b, s, hd = 3, 24, 256
    q = rng.standard_normal((b, s, nq, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, nkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, nkv, hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[1, 20:] = -1
    kv_lengths = np.array([s, 11, 0], np.int32)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, pos, kv_lengths))
    if jax_fn == "interpret":
        ref = jfa.flash_gqa_attention(*jargs, block_q=8, block_k=8, interpret=True)
    else:
        ref = jatt.gqa_attention(*jargs)
    ref = np.asarray(ref)
    out = tfa.flash_gqa_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, kv_lengths)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    for arr in (out.numpy(), ref):
        assert not arr[1, 20:].any() and not arr[2].any()
    assert hd in tfa.HEAD_DIMS


def test_attention_dispatch_routes_unscaled_to_flash_plain():
    q, k, v, pos, kv_lengths = _inputs(1)
    args = tuple(torch.from_numpy(a) for a in (q, k, v, pos, kv_lengths))
    assert torch.equal(tatt.attention(*args), tfa.flash_gqa_attention_plain(*args))


def test_scaled_int8_attention_matches_jax():
    """The warm int8 path stays plain PyTorch in both packages."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 8, NQ, HD), dtype=np.float32)
    k8 = rng.integers(-127, 128, (2, 24, NKV, HD), dtype=np.int8)
    v8 = rng.integers(-127, 128, (2, 24, NKV, HD), dtype=np.int8)
    ks = (rng.random((2, 24, NKV), dtype=np.float32) * 0.02).astype(np.float32)
    vs = (rng.random((2, 24, NKV), dtype=np.float32) * 0.02).astype(np.float32)
    pos = (10 + np.arange(8, dtype=np.int32))[None].repeat(2, 0)
    lens = np.array([18, 12], np.int32)
    ref = jatt.attention(*(jnp.asarray(a) for a in (q, k8, v8, pos, lens)),
                         k_scale=jnp.asarray(ks).astype(jnp.bfloat16), v_scale=jnp.asarray(vs).astype(jnp.bfloat16))
    out = tatt.attention(*(torch.from_numpy(a) for a in (q, k8, v8, pos, lens)),
                         k_scale=torch.from_numpy(ks).to(torch.bfloat16), v_scale=torch.from_numpy(vs).to(torch.bfloat16))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
