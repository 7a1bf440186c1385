"""The Gemma, StarCoder2 and MoE branches of the port's forward against the
JAX reference on the CPU.

The same params (made by the JAX package from a seed, converted with
``params_from_numpy``) and the same numpy inputs go through both packages:

* the cacheless forward on float trees (one layer body for Gemma's gated
  tree, StarCoder2's unpacked biased one and the MoE tree's ``_moe_mlp``,
  dropless and with capacity dropping): f32 hidden states and logits
  within 1e-5, and the aux loss;
* the serving forward on prepared W8A8 trees: cold prefill and one
  append-buffer decode step, logits within 1e-4 (f32; an activation
  quantization tie may round one step the other way), as
  ``tests/test_torch_llama.py`` holds Llama;
* ``_moe_mlp`` alone: a long sequence in two dispatch groups (s = 200,
  padded), capacity dropping, and a planted router tie that top-k must
  break to the lower expert: outputs within 1e-5, aux losses within 1e-6;
* ``dense_layer``; the bf16 norms ((1 + g) RMSNorm, LayerNorm) against
  JAX's; the MoE / dense tree mismatch errors;
* greedy streams of the port's ``Scheduler(device="cpu")`` on both KV
  layouts equal the JAX ``Scheduler``'s on the same prepared params.
"""

import dataclasses
import queue

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import scheduler as jsched
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.engine import scheduler as tsched
from generativeaiexamples_tpu_torch.engine.weights import cache_from_numpy, params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama

FAMILIES = ("gemma-tiny", "starcoder2-tiny", "llama-moe-tiny", "llama-moe-tiny-dropless")
TOL = dict(atol=1e-5, rtol=1e-5)  # f32, orders of sums
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)  # as tests/test_torch_llama.py


def _cfgs(name, **kw):
    preset, extra = (name, {}) if not name.endswith("-dropless") else (name[: -len("-dropless")], {"moe_dropless": True})
    kw = dict(dtype="float32", kv_dtype="int8", **extra, **kw)
    return jllama.PRESETS[preset](**kw), tllama.PRESETS[preset](**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    jcfg, tcfg = _cfgs(request.param)
    raw = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    # Gains and biases off their init values, so (1 + g), the norm biases
    # and the projection biases all take part.
    rng = np.random.default_rng(1)
    raw = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        if any(getattr(p, "key", "") in ("attn_norm", "mlp_norm", "final_norm", "final_norm_b", "bq", "bk", "bv",
                                         "bo", "b_up", "b_down", "attn_norm_b", "mlp_norm_b") for p in path)
        else a,
        raw,
    )
    return request.param, jcfg, tcfg, raw, params_from_numpy(_np_tree(raw), tcfg, "cpu")


def _inputs(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    lengths = np.array([s, s - 7][:b], np.int32)
    return tokens, positions, lengths


def test_cacheless_forward_equals_jax(family):
    name, jcfg, tcfg, jp, tp = family
    tokens, positions, lengths = _inputs(jcfg)
    jh, jcache, jaux = jllama.forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                      kv_lengths=jnp.asarray(lengths), return_aux=True)
    th, tcache, taux = tllama.forward(tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions), None,
                                      torch.from_numpy(lengths), return_aux=True)
    assert jcache is None and tcache is None
    jl = np.asarray(jllama.logits(jp, jh))
    tl = tllama.logits(tp, th).numpy()
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(th[r, :n].numpy(), np.asarray(jh)[r, :n], **TOL)
        np.testing.assert_allclose(tl[r, :n], jl[r, :n], **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    if tcfg.n_experts > 1:
        assert 0.5 < float(taux) < tcfg.n_experts


def test_serving_prefill_and_decode_step_equal_jax(family, monkeypatch):
    """The prepared W8A8 tree (packed when unbiased, experts float)
    through a cold prefill and one append-buffer decode step."""
    monkeypatch.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    name, jcfg, tcfg, raw, _ = family
    jp = jdecode.prepare_params(jcfg, raw, None, quantize=True, pack=True, matmul_kernel="pallas_w8a8")
    tp = params_from_numpy(_np_tree(jp), tcfg, "cpu")
    assert ("wqkv" in tp["layers"]) == (not tcfg.proj_bias)
    tokens, positions, lengths = _inputs(jcfg, s=16)
    T = 64
    jh, jc = jllama.forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                            jllama.init_kv_cache(jcfg, 2, T), jnp.asarray(lengths), cold_prefill=True)
    th, _ = tllama.forward(tp, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions),
                           tllama.init_kv_cache(tcfg, 2, T, device="cpu"), torch.from_numpy(lengths),
                           cold_prefill=True)
    jl = np.asarray(jllama.logits(jp, jh))
    tl = tllama.logits(tp, th).numpy()
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(tl[r, :n], jl[r, :n], **SERVE_TOL)
    first = np.array([jl[r, n - 1].argmax() for r, n in enumerate(lengths)], np.int32)
    tc = cache_from_numpy([np.asarray(c) for c in jc], "cpu")
    ab_shape = (jcfg.n_layers, jcfg.n_kv_heads, 2, 2, jcfg.head_dim)
    jab = (jnp.zeros(ab_shape, jnp.int8), jnp.zeros(ab_shape, jnp.int8),
           jnp.zeros(ab_shape[:-1], jnp.bfloat16), jnp.zeros(ab_shape[:-1], jnp.bfloat16))
    tab = tuple(torch.zeros(a.shape, dtype=d) for a, d in zip(
        jab, (torch.int8, torch.int8, torch.bfloat16, torch.bfloat16)))
    pos = lengths[:, None]
    jh1, _, _ = jllama.forward(jp, jcfg, jnp.asarray(first[:, None]), jnp.asarray(pos), jc, jnp.asarray(lengths),
                               kv_bucket=32, append_cache=(jab, 0))
    th1, _, _ = tllama.forward(tp, tcfg, torch.from_numpy(first[:, None]).long(), torch.from_numpy(pos), tc,
                               torch.from_numpy(lengths), kv_bucket=32, append_cache=(tab, 0))
    np.testing.assert_allclose(tllama.logits(tp, th1).numpy(), np.asarray(jllama.logits(jp, jh1)), **SERVE_TOL)


def _moe_layer(cfg, seed=4):
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed))
    lp = {k: np.array(v[0]) for k, v in params["layers"].items()}
    return lp, {k: torch.from_numpy(v.copy()) for k, v in lp.items()}


def _moe_both(jcfg, tcfg, jlp, tlp, h):
    jout, jaux = jllama._moe_mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in jlp.items()}, jcfg, None)
    tout, taux = tllama._moe_mlp(torch.from_numpy(h), tlp, tcfg)
    return (np.asarray(jout), float(jaux)), (tout.numpy(), float(taux))


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("s", [16, 200])
def test_moe_mlp_equals_jax(dropless, s):
    """Capacity dropping and dropless routing, one group (s = 16) and two
    groups with 56 padded slots masked out of routing (s = 200)."""
    jcfg, tcfg = _cfgs("llama-moe-tiny", moe_dropless=dropless, max_seq_len=256)
    jlp, tlp = _moe_layer(jcfg)
    h = np.random.default_rng(2).normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    (jout, jaux), (tout, taux) = _moe_both(jcfg, tcfg, jlp, tlp, h)
    np.testing.assert_allclose(tout, jout, **TOL)
    assert abs(taux - jaux) < 1e-6
    if s == 200:  # the first group is dispatched alone as it is in the sequence
        head, _ = tllama._moe_mlp(torch.from_numpy(h[:, :128].copy()), tlp, tcfg)
        np.testing.assert_allclose(tout[:, :128], head.numpy(), **TOL)


def test_moe_router_tie_breaks_to_the_lower_expert():
    """Router columns 1-3 are zero, so experts 1, 2 and 3 tie exactly on
    every token: top-2 must take the lower indices first, as
    ``jax.lax.top_k`` does, and the capacity slots follow that order."""
    jcfg, tcfg = _cfgs("llama-moe-tiny")
    jlp, _ = _moe_layer(jcfg, seed=5)
    jlp["router"][:, 1:] = 0.0
    tlp = {k: torch.from_numpy(v.copy()) for k, v in jlp.items()}
    h = np.random.default_rng(3).normal(size=(1, 40, jcfg.d_model)).astype(np.float32)
    (jout, jaux), (tout, taux) = _moe_both(jcfg, tcfg, jlp, tlp, h)
    np.testing.assert_allclose(tout, jout, **TOL)
    assert abs(taux - jaux) < 1e-6
    probs = torch.softmax(torch.from_numpy(h[0]) @ tlp["router"], dim=-1)
    _, idx = tllama._top_k(probs, 2)
    lead = probs[:, 0] > probs[:, 1]
    assert lead.any() and (~lead).any()
    assert torch.equal(idx[lead], torch.tensor([0, 1]).expand(int(lead.sum()), 2))
    assert torch.equal(idx[~lead], torch.tensor([1, 2]).expand(int((~lead).sum()), 2))


def test_dense_layer_equals_jax():
    jcfg, tcfg = _cfgs("gemma-tiny")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(6))
    jlp = {k: v[0] for k, v in params["layers"].items()}
    tlp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jlp.items()}
    tokens, positions, lengths = _inputs(jcfg, s=20, seed=7)
    x = np.random.default_rng(7).normal(size=(2, 20, jcfg.d_model)).astype(np.float32)
    jout = jllama.dense_layer(jnp.asarray(x), jlp, jcfg, jnp.asarray(positions), jnp.asarray(lengths))
    tout = tllama.dense_layer(torch.from_numpy(x), tlp, tcfg, torch.from_numpy(positions), torch.from_numpy(lengths))
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(tout[r, :n].numpy(), np.asarray(jout)[r, :n], **TOL)
    # tp_axis is a mesh axis (tests/test_torch_tensor_parallel.py): without a
    # rank's mesh context it raises.
    with pytest.raises(ValueError, match="mesh context"):
        tllama.dense_layer(torch.from_numpy(x), tlp, tcfg, torch.from_numpy(positions), tp_axis="tensor")


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("kind", ["rms_unit_offset", "rms", "layernorm"])
def test_bf16_norms_equal_jax(kind):
    """bf16 in, bf16 out.  The port sums squares in float64 (a row's
    result does not depend on its batch), JAX in f32: the two f32 scales
    can differ in their last bit, so at most 1 element in 1,000 may be 1
    bf16 ulp apart; every other element is equal bit for bit."""
    rng = np.random.default_rng(8)
    x = _bf16(rng.normal(0, 3, (64, 256)).astype(np.float32))
    g = _bf16(rng.normal(0, 0.2, 256).astype(np.float32))
    bias = _bf16(rng.normal(0, 0.2, 256).astype(np.float32))
    tx, tg, tb = (torch.from_numpy(a.astype(np.float32)).bfloat16() for a in (x, g, bias))
    if kind == "layernorm":
        j = jllama._affine_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(bias), 1e-5)
        t = tllama._affine_layer_norm(tx, tg, tb, 1e-5)
    else:
        unit = kind == "rms_unit_offset"
        j = jllama.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6, unit)
        t = tllama.rms_norm(tx, tg, 1e-6, unit)
    assert t.dtype == torch.bfloat16
    jf = np.asarray(j).astype(np.float32)
    tf = t.float().numpy()
    diff = jf != tf
    assert diff.mean() <= 1e-3, diff.mean()
    ulp = np.abs(jf).astype(np.float32) * 2.0**-7
    assert (np.abs(jf - tf)[diff] <= ulp[diff] + 1e-30).all()


def test_moe_and_dense_tree_mismatch_raise():
    jcfg, moe_cfg = _cfgs("llama-moe-tiny")
    _, dense_cfg = _cfgs("llama-tiny")
    moe = tllama.init_params(moe_cfg, torch.Generator().manual_seed(0), "cpu")
    dense = tllama.init_params(dense_cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="n_experts > 1 but params carry a dense MLP tree"):
        tllama.forward(dense, moe_cfg, tokens, pos)
    with pytest.raises(ValueError, match="params carry MoE leaves"):
        tllama.forward(moe, dense_cfg, tokens, pos)


# -- the scheduler ------------------------------------------------------------

SCHED_KW = dict(max_batch=4, max_len=128, decode_chunk_size=2, prefill_chunk_tokens=8, prefix_cache="shared")


def _collect(mod, scheduler, prompt, max_tokens):
    tokens: list[int] = []
    done: "queue.Queue[str]" = queue.Queue()
    scheduler.submit(mod.Request(token_ids=list(prompt), sampling=mod.SamplingParams(temperature=0.0,
                                                                                      max_tokens=max_tokens),
                                 on_token=tokens.append, on_done=done.put))
    return tokens, done.get(timeout=120)


def _streams(mod, sched):
    """A cold prompt, a chunked one, and two submitted together."""
    sched.start()
    try:
        out = {"cold": _collect(mod, sched, [1, 2, 3, 4], 5), "chunked": _collect(mod, sched, range(5, 25), 6)}
        got: dict = {}
        dones = []
        for key, prompt in (("pair_a", [9, 8, 7, 6, 5]), ("pair_b", list(range(30, 42)))):
            got[key] = []
            done: "queue.Queue[str]" = queue.Queue()
            dones.append((key, done))
            sched.submit(mod.Request(token_ids=prompt, sampling=mod.SamplingParams(temperature=0.0, max_tokens=5),
                                     on_token=got[key].append, on_done=done.put))
        for key, done in dones:
            out[key] = (got[key], done.get(timeout=120))
    finally:
        sched.stop()
    return out


@pytest.mark.parametrize("name", ["gemma-tiny", "starcoder2-tiny", "llama-moe-tiny-dropless"])
def test_scheduler_streams_equal_jax_on_both_layouts(name, monkeypatch):
    monkeypatch.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    monkeypatch.setenv("GAIE_EXACT_SAMPLING", "1")
    jcfg, tcfg = _cfgs(name, max_seq_len=128)
    raw = jdecode.init_random_int8_params(jcfg, jax.random.PRNGKey(0))
    packed = jdecode.prepare_params(jcfg, raw, None, pack=True)
    jp = jdecode.prepare_params(jcfg, packed, None, matmul_kernel="pallas_w8a8")
    ref = _streams(jsched, jsched.Scheduler(jcfg, jp, matmul_kernel="pallas_w8a8", **SCHED_KW))
    assert ref["cold"][0] and ref["chunked"][0]
    tp = params_from_numpy(_np_tree(jp), tcfg, "cpu")
    for layout in ({}, dict(kv_layout="paged", kv_page_size=16)):
        out = _streams(tsched, tsched.Scheduler(tcfg, tp, device="cpu", **SCHED_KW, **layout))
        assert out == ref, layout
    assert dataclasses.replace(tcfg).n_layers == 2
