"""The port's decode attention (``ops/decode_attention.py``) against the
JAX reference: its plain version must match the interpret-mode Pallas
kernel and ``decode_gqa_attention_xla`` within 1e-4 (f32 inputs; the sums
run in another order), with and without the append buffer, on ragged
lengths that include an empty row and a lane pinned at T - 1 (read only
up to ``window``).  The append-buffer flush must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.ops import decode_attention as jda
from generativeaiexamples_tpu_torch.engine import decode as tdecode
from generativeaiexamples_tpu_torch.ops import decode_attention as tda

L, KH, B, T, HD, G, C = 2, 2, 16, 512, 128, 4, 8
WINDOW = 256
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KH * G, HD), dtype=np.float32)
    k8 = rng.integers(-127, 128, (L, KH, B, T, HD), dtype=np.int8)
    v8 = rng.integers(-127, 128, (L, KH, B, T, HD), dtype=np.int8)
    ks = (rng.random((L, KH, B, T), dtype=np.float32) * 0.02).astype(np.float32)
    vs = (rng.random((L, KH, B, T), dtype=np.float32) * 0.02).astype(np.float32)
    kab = rng.integers(-127, 128, (L, KH, B, C, HD), dtype=np.int8)
    vab = rng.integers(-127, 128, (L, KH, B, C, HD), dtype=np.int8)
    ksab = (rng.random((L, KH, B, C), dtype=np.float32) * 0.02).astype(np.float32)
    vsab = (rng.random((L, KH, B, C), dtype=np.float32) * 0.02).astype(np.float32)
    lengths = rng.integers(1, WINDOW, (B,)).astype(np.int32)
    lengths[0] = 0
    lengths[1] = T - 1  # pinned lane: longer than the window
    lengths[2] = WINDOW
    return q, k8, v8, ks, vs, (kab, vab, ksab, vsab), lengths


def _bf16_jax(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _bf16_torch(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("with_append", [False, True])
@pytest.mark.parametrize("jax_fn", ["interpret", "xla"])
def test_plain_matches_jax(with_append, jax_fn):
    q, k8, v8, ks, vs, ab, lengths = _inputs()
    count = 5
    layer = 1
    j_append = t_append = None
    if with_append:
        kab, vab, ksab, vsab = ab
        j_append = (jnp.asarray(kab), jnp.asarray(vab), _bf16_jax(ksab), _bf16_jax(vsab), jnp.int32(count))
        t_append = (torch.from_numpy(kab), torch.from_numpy(vab), _bf16_torch(ksab), _bf16_torch(vsab), count)
    jargs = (jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), _bf16_jax(ks), _bf16_jax(vs),
             jnp.int32(layer), jnp.asarray(lengths), j_append)
    if jax_fn == "interpret":
        ref = jda.decode_gqa_attention(*jargs, window=WINDOW, interpret=True)
    else:
        ref = jda.decode_gqa_attention_xla(*jargs, window=WINDOW)
    out = tda.decode_gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8), _bf16_torch(ks),
        _bf16_torch(vs), layer, torch.from_numpy(lengths), t_append, window=WINDOW,
    )
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    if not with_append:
        assert not out[0].any() and not ref[0].any()  # empty row: exact zeros


def test_flush_clip_start_and_flush_exact():
    for max_len, chunk in [(128, 2), (2048, 8), (512, 16)]:
        assert tda.flush_clip_start(max_len, chunk) == jda.flush_clip_start(max_len, chunk)
    rng = np.random.default_rng(1)
    t, c = 64, 4
    cache = [
        rng.integers(-127, 128, (L, KH, B, t, HD), dtype=np.int8),
        rng.integers(-127, 128, (L, KH, B, t, HD), dtype=np.int8),
        rng.random((L, KH, B, t), dtype=np.float32),
        rng.random((L, KH, B, t), dtype=np.float32),
    ]
    ab = [
        rng.integers(-127, 128, (L, KH, B, c, HD), dtype=np.int8),
        rng.integers(-127, 128, (L, KH, B, c, HD), dtype=np.int8),
        rng.random((L, KH, B, c), dtype=np.float32),
        rng.random((L, KH, B, c), dtype=np.float32),
    ]
    starts = rng.integers(0, t, (B,)).astype(np.int32)
    starts[0], starts[1] = t - 1, 0  # a pinned lane clips into the tail zone
    ref = jdecode._flush_append_buffer(
        tuple(jnp.asarray(x) for x in cache), tuple(jnp.asarray(x) for x in ab), jnp.asarray(starts), t
    )
    out = tdecode._flush_append_buffer(
        tuple(torch.from_numpy(x.copy()) for x in cache), tuple(torch.from_numpy(x) for x in ab),
        torch.from_numpy(starts), t,
    )
    for r, o in zip(ref, out):
        assert np.array_equal(np.asarray(r), o.numpy())
