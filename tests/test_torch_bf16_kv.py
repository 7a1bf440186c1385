"""The float KV cache and the ``xla`` projection path of the port against
the JAX package on the CPU.

The same numpy-seeded params and tokens go through both packages:

* ``init_kv_cache``'s float 2-tuple (the compute dtype: f32 here, bf16 in
  a bf16 config);
* ``q_dot``'s weight-only int8 branch;
* ``forward`` over the 2-tuple cache: cold prefill, a warm chunk at offset
  positions, decode steps, and the verify block (the JAX side's warm
  scatter forward; the port's float append buffer);
* ``prepare_params``' ``quantize`` / ``pack`` / ``matmul_kernel``;
* the ``Scheduler`` on ``xla`` with the preset's cache: greedy streams
  equal the JAX scheduler's over chunked prefill, the prefix cache and
  concurrent requests;
* the paged layout's override to int8, and the ``engine_matmul_kernel``
  label on both paths.

Tolerances: f32 hidden states and logits within 1e-4 (sums in another
order); bf16 within one bf16 step of the values' size, 2e-2 relative.
Greedy token streams are equal.
"""

import dataclasses
import queue
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu_torch.engine import decode as tdecode
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.weights import params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.ops import quant as tquant
from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix

JCFG = jllama.llama_tiny(dtype="float32", max_seq_len=128)
TCFG = tllama.llama_tiny(dtype="float32", max_seq_len=128)
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
T = 64


def _to_port(tree, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu")


@pytest.fixture(scope="module")
def float_params():
    return jllama.init_params(JCFG, jax.random.PRNGKey(3))


@pytest.mark.parametrize("dtype,kv,want", [
    ("float32", "bfloat16", torch.float32),
    ("bfloat16", "bfloat16", torch.bfloat16),
    ("float32", "int8", torch.int8),
])
def test_init_kv_cache_shapes_and_dtypes(dtype, kv, want):
    cfg = tllama.llama_tiny(dtype=dtype, kv_dtype=kv)
    cache = tllama.init_kv_cache(cfg, 3, 40, device="cpu")
    ref = jllama.init_kv_cache(jllama.llama_tiny(dtype=dtype, kv_dtype=kv), 3, 40)
    assert len(cache) == len(ref) == (4 if kv == "int8" else 2)
    for got, exp in zip(cache, ref):
        assert tuple(got.shape) == exp.shape
    assert cache[0].dtype == want and tuple(cache[0].shape) == (cfg.n_layers, cfg.n_kv_heads, 3, 40, cfg.head_dim)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_q_dot_equals_jax(dtype):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 96)).astype(np.float32) * 0.05
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jw = jquant.quantize_matrix(jnp.asarray(w))
    tw = tquant.QuantizedMatrix(q=torch.from_numpy(np.array(jw.q)), scale=torch.from_numpy(np.array(jw.scale)))
    if dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        jx, tx = jnp.asarray(xb), torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16)
        tol = BF16_TOL
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        tol = TOL
    ref = np.asarray(jquant.q_dot(jx, jw, "w")).astype(np.float32)
    got = tquant.q_dot(tx, tw, "w")
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)
    with pytest.raises(ValueError, match="int8"):
        tquant.q_dot(tx, tquant.QuantizedMatrix(q=tw.q.float(), scale=tw.scale), "w")
    with pytest.raises(ValueError, match="scale shape"):
        tquant.q_dot(tx, tquant.QuantizedMatrix(q=tw.q, scale=tw.scale[0]), "w")


def _forward_both(jp, tp, jcfg, tcfg, tol):
    """Cold prefill, a warm chunk at offset positions, two decode steps and
    a verify block through both packages' forwards on the float cache."""
    rng = np.random.default_rng(5)
    b, s = 2, 16
    tokens = rng.integers(0, jcfg.vocab_size, (b, s + 4 + 2 + 3)).astype(np.int32)
    lengths = np.array([16, 11], np.int32)
    jc = jllama.init_kv_cache(jcfg, b, T)
    tc = tllama.init_kv_cache(tcfg, b, T, device="cpu")
    outs = []

    def both(toks, pos, kv_len, **kw):
        nonlocal jc
        jh, jc = jllama.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc, jnp.asarray(kv_len), **kw)
        th, _ = tllama.forward(tp, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(np.array(pos)), tc,
                               torch.from_numpy(kv_len), **kw)
        outs.append((np.asarray(jllama.logits(jp, jh)), tllama.logits(tp, th).numpy()))

    both(tokens[:, :s], np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)), lengths, cold_prefill=True)
    # A warm chunk of 4 at each row's offset (through the flash kernel's
    # plain version: t > s, positions past 0).
    pos = lengths[:, None] + np.arange(4, dtype=np.int32)[None]
    both(tokens[:, s : s + 4], pos, lengths + 4, kv_bucket=32)
    cur = lengths + 4
    for i in range(2):  # decode steps
        both(tokens[:, s + 4 + i : s + 5 + i], cur[:, None], cur + 1, kv_bucket=32)
        cur = cur + 1
    # Verify block of 3: the JAX side's warm scatter forward, the port's
    # float append buffer over the whole cache.
    vt = tokens[:, s + 6 :]
    vpos = cur[:, None] + np.arange(3, dtype=np.int32)[None]
    jh, jc = jllama.forward(jp, jcfg, jnp.asarray(vt), jnp.asarray(vpos), jc, jnp.asarray(cur + 3), kv_bucket=32)
    ab = tdecode._append_buffer(tcfg, b, 3, "cpu")
    th, _, ab = tllama.forward(tp, tcfg, torch.from_numpy(vt).long(), torch.from_numpy(vpos), tc,
                               torch.from_numpy(cur), kv_bucket=32, append_cache=(ab, 0))
    outs.append((np.asarray(jllama.logits(jp, jh)), tllama.logits(tp, th).numpy()))
    tdecode._flush_append_buffer(tc, ab, torch.from_numpy(cur), T)
    for i, (ref, got) in enumerate(outs):
        rows = [(r, int(lengths[r])) for r in range(b)] if i == 0 else [(r, got.shape[1]) for r in range(b)]
        for r, n in rows:
            np.testing.assert_allclose(got[r, :n], ref[r, :n], **tol, err_msg=f"call {i} row {r}")
    for jl, tl in zip(jc, tc):
        live = np.arange(T)[None, :] < (cur + 3)[:, None]
        np.testing.assert_allclose(tl.float().numpy()[:, :, live], np.asarray(jl).astype(np.float32)[:, :, live],
                                   **tol)


def test_forward_on_the_f32_cache_equals_jax(float_params):
    _forward_both(float_params, _to_port(float_params, TCFG), JCFG, TCFG, TOL)


def test_forward_on_the_bf16_cache_equals_jax():
    jcfg = jllama.llama_tiny(dtype="bfloat16", max_seq_len=128)
    tcfg = tllama.llama_tiny(dtype="bfloat16", max_seq_len=128)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    _forward_both(jp, _to_port(jp, tcfg), jcfg, tcfg, BF16_TOL)


def test_forward_refuses_an_append_buffer_decode_on_the_float_cache():
    cfg = tllama.llama_tiny(dtype="float32")
    tp = tdecode.prepare_params(cfg, None, device="cpu")
    cache = tllama.init_kv_cache(cfg, 1, 16, device="cpu")
    ab = tdecode._append_buffer(cfg, 1, 2, "cpu")
    with pytest.raises(ValueError, match="scatter"):
        tllama.forward(tp, cfg, torch.zeros((1, 1), dtype=torch.long), torch.zeros((1, 1), dtype=torch.int32),
                       cache, torch.ones(1, dtype=torch.int32), append_cache=(ab, 0))


@pytest.mark.parametrize("quantize,pack,kernel", [
    (False, False, None), (False, True, "xla"), (True, False, "xla"), (True, True, "xla"),
    (True, True, "pallas_w8a8"), (False, True, "pallas_w8a8"),
])
def test_prepare_params_combinations_equal_jax(float_params, quantize, pack, kernel):
    """The reference's layout leaf for leaf (int8 values bit for bit), and
    a second call returns every leaf as it is."""
    jp = jdecode.prepare_params(JCFG, float_params, None, quantize=quantize, pack=pack, matmul_kernel=kernel)
    raw = _to_port(float_params, TCFG)
    tp = tdecode.prepare_params(TCFG, raw, device="cpu", quantize=quantize, pack=pack, matmul_kernel=kernel)
    want = _to_port(jp, TCFG)
    assert sorted(tp["layers"]) == sorted(want["layers"])
    for name, leaf in tp["layers"].items():
        ref = want["layers"][name]
        assert type(leaf) is type(ref), name
        if isinstance(leaf, BlockedQuantizedMatrix):
            assert torch.equal(leaf.w, ref.w) and torch.equal(leaf.scale, ref.scale)
        elif isinstance(leaf, tquant.QuantizedMatrix):
            assert torch.equal(leaf.q, ref.q) and torch.equal(leaf.scale, ref.scale)
        else:
            assert torch.equal(leaf, ref)
    assert (tsched.live_matmul_kernel(tp) == "pallas_w8a8") == (quantize and kernel == "pallas_w8a8")
    again = tdecode.prepare_params(TCFG, tp, device="cpu", quantize=quantize, pack=pack, matmul_kernel=kernel)
    assert all(again["layers"][n] is leaf for n, leaf in tp["layers"].items())


def test_random_float_params_are_the_compute_dtype_at_every_depth():
    cfg = tllama.llama_tiny(dtype="bfloat16", n_layers=3)
    p = tdecode.prepare_params(cfg, None, device="cpu", generator=torch.Generator().manual_seed(1))
    assert p["layers"]["wq"].dtype == torch.bfloat16 and p["layers"]["wq"].shape[0] == 3
    assert not torch.equal(p["layers"]["wq"][0], p["layers"]["wq"][1])  # layers drawn apart
    assert torch.equal(p["layers"]["attn_norm"], torch.ones_like(p["layers"]["attn_norm"]))
    assert tsched.live_matmul_kernel(p) == "xla"


SCHED_KW = dict(max_batch=4, max_len=128, decode_chunk_size=2, prefill_chunk_tokens=8, prefix_cache="shared")


def _collect(mod, sched, prompt, max_tokens, session_id=""):
    tokens: list[int] = []
    done: "queue.Queue[str]" = queue.Queue()
    sched.submit(mod.Request(
        token_ids=list(prompt), sampling=mod.SamplingParams(temperature=0.0, max_tokens=max_tokens),
        on_token=tokens.append, on_done=done.put, session_id=session_id,
    ))
    return tokens, done.get(timeout=120)


def _streams(mod, sched):
    out = {}
    sched.start()
    try:
        out["cold"] = _collect(mod, sched, [1, 2, 3, 4], 5)
        out["chunked"] = _collect(mod, sched, list(range(2, 26)), 10)
        # The parked history (prompt and all but the last emitted token) is
        # past MIN_PREFIX: the extension takes the shared-prefix graft.
        history = list(range(2, 26)) + out["chunked"][0][:9]
        out["shared"] = _collect(mod, sched, history + [100, 101], 4)
        results: dict = {}
        prompts = {"a": [5, 6, 7], "b": list(range(30, 50)), "c": [9, 10]}
        workers = [threading.Thread(target=lambda k=k: results.__setitem__(k, _collect(mod, sched, prompts[k], 6)))
                   for k in prompts]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        out.update({f"concurrent_{k}": results[k] for k in sorted(prompts)})
    finally:
        sched.stop()
    return out


def test_xla_scheduler_streams_equal_jax(float_params):
    jax_sched = jsched.Scheduler(JCFG, float_params, matmul_kernel="xla", **SCHED_KW)
    ref = _streams(jsched, jax_sched)
    port = tsched.Scheduler(TCFG, _to_port(float_params, TCFG), device="cpu", matmul_kernel="xla", **SCHED_KW)
    assert len(port._cache) == 2 and port._cache[0].dtype == torch.float32
    out = _streams(tsched, port)
    assert out == ref
    assert all(toks for toks, _ in out.values())
    for sched in (jax_sched, port):
        snap = sched.stats.snapshot()
        assert snap["prefill_chunks"] > 0 and snap["shared_prefix_hits"] == 1


def test_paged_layout_overrides_the_kv_dtype_to_int8(caplog):
    from generativeaiexamples_tpu_torch.engine.server import serving_config

    with pytest.raises(ValueError, match="int8 pages"):
        tsched.Scheduler(TCFG, None, device="cpu", kv_layout="paged", **dict(SCHED_KW, max_batch=2))
    with caplog.at_level("INFO"):
        cfg = serving_config("llama-tiny", "xla", "paged")
    assert cfg.kv_dtype == "int8" and "requires int8 KV; overriding kv_dtype=bfloat16" in caplog.text
    assert serving_config("llama-tiny", "xla").kv_dtype == "bfloat16"
    assert serving_config("llama-tiny", "pallas_w8a8").kv_dtype == "int8"
    sched = tsched.Scheduler(dataclasses.replace(TCFG, kv_dtype="int8"), None, device="cpu", kv_layout="paged",
                             matmul_kernel="xla", **dict(SCHED_KW, max_batch=2))
    assert sched._pool is not None and sched._cache[0].dtype == torch.int8 and sched.matmul_kernel == "xla"


@pytest.mark.parametrize("kernel,quantized", [("xla", False), ("xla", True), ("pallas_w8a8", True),
                                              ("pallas_w8a8", False)])
def test_matmul_kernel_label_equals_jax(float_params, kernel, quantized):
    """The reference reports ``pallas_w8a8`` only where a projection was
    blocked: weight-only int8 handed to ``pallas_w8a8`` is blocked; float
    leaves stay on ``xla`` (the reference's scheduler never quantizes)."""
    tree = jdecode.prepare_params(JCFG, float_params, None, quantize=quantized, pack=True)
    jax_sched = jsched.Scheduler(JCFG, tree, matmul_kernel=kernel, max_batch=2, max_len=64)
    tp = tdecode.prepare_params(TCFG, _to_port(tree, TCFG), device="cpu", matmul_kernel=kernel)
    assert tsched.live_matmul_kernel(tp) == jax_sched.matmul_kernel
    # The port's scheduler on its W8A8 route quantizes float leaves first.
    port = tsched.Scheduler(TCFG, _to_port(tree, TCFG), device="cpu", matmul_kernel=kernel, max_batch=2,
                            max_len=64)
    assert port.matmul_kernel == ("pallas_w8a8" if kernel == "pallas_w8a8" else jax_sched.matmul_kernel)
