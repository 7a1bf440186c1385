"""The port's speculative-decoding pieces against the JAX package on the
CPU, with the same int8 W8A8 weights (``init_random_int8_params`` +
``prepare_params``, carried over with ``params_from_numpy``):

* ``warped_candidates`` / ``prob_of``: ids equal, probabilities within
  1e-6 (the JAX side selects candidates exactly);
* the verify attention and its paged twin against
  ``verify_gqa_attention_xla`` / ``paged_verify_gqa_attention_xla``
  within the plain decode tolerance (1e-4; f32 sums in another order),
  and paged = contiguous bit for bit;
* ``forward``'s verify mode: logits within 1e-4 of the JAX forward's;
* two greedy rounds of each of the four chunk functions: ``outs`` and
  ``n_emits`` equal to JAX's (the JAX side runs the append-buffer verify,
  ``GAIE_FORCE_APPEND_BUFFER=1``);
* ``gamma_bucket``, ``self_draft`` sharing the target's storage, and K4's
  plain version at head_dim 64 (the draft's) against the interpret-mode
  Pallas kernel.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import sampler as jsampler
from generativeaiexamples_tpu.engine import spec_decode as jspec
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.ops import decode_attention as jda
from generativeaiexamples_tpu.ops import flash_attention as jfa
from generativeaiexamples_tpu_torch.engine import sampler as tsampler
from generativeaiexamples_tpu_torch.engine import spec_decode as tspec
from generativeaiexamples_tpu_torch.engine.weights import cache_from_numpy, params_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.ops import decode_attention as tda
from generativeaiexamples_tpu_torch.ops import flash_attention as tfa
from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix

TINY = dict(dtype="float32", max_seq_len=64, kv_dtype="int8")
DRAFT = dict(n_layers=1, d_model=64, d_ff=128, n_heads=2, n_kv_heads=2, head_dim=32)
JCFG, TCFG = jllama.llama_tiny(**TINY), tllama.llama_tiny(**TINY)
JDCFG, TDCFG = jllama.llama_tiny(**TINY, **DRAFT), tllama.llama_tiny(**TINY, **DRAFT)
MAX_LEN, PT = 64, 8
TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_params(cfg, seed):
    raw = jdecode.init_random_int8_params(cfg, jax.random.PRNGKey(seed))
    packed = jdecode.prepare_params(cfg, raw, None, pack=True)
    return jdecode.prepare_params(cfg, packed, None, matmul_kernel="pallas_w8a8")


@pytest.fixture(scope="module")
def models():
    jp, jd = _jax_params(JCFG, 0), _jax_params(JDCFG, 7)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    td = params_from_numpy(jax.tree.map(np.asarray, jd), TDCFG, "cpu")
    return jp, jd, tp, td


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def test_warped_candidates_and_prob_of_match_jax():
    rng = np.random.default_rng(0)
    b, vocab = 6, 512
    logits = (rng.standard_normal((b, vocab)) * 3).astype(np.float32)
    temp = np.array([1.0, 0.7, 1.2, 0.5, 2.0, 1.0], np.float32)
    top_p = np.array([0.9, 1.0, 0.98, 0.5, 0.95, 1.0], np.float32)
    top_k = np.array([0, 8, 4, 0, 50, 0], np.int32)
    jids, jprobs = jsampler.warped_candidates(*(jnp.asarray(a) for a in (logits, temp, top_p, top_k)), approx=False)
    tids, tprobs = tsampler.warped_candidates(*(torch.from_numpy(a) for a in (logits, temp, top_p, top_k)))
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6, rtol=0)
    tokens = np.asarray(jids)[:, 3].copy()
    tokens[0] = vocab - 1 if vocab - 1 not in np.asarray(jids)[0] else tokens[0]
    ref = jsampler.prob_of(jids, jprobs, jnp.asarray(tokens))
    out = tsampler.prob_of(tids, tprobs, torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    draws = tsampler.sample_from_candidates(tids, tprobs, torch.Generator().manual_seed(0))
    for r in range(b):  # every draw lies in its row's kept pool
        kept = tids[r][tprobs[r] > 0]
        assert int(draws[r]) in kept.tolist()


# ---------------------------------------------------------------------------
# verify attention
# ---------------------------------------------------------------------------

L, KH, G, B, HD, S, T = 2, 2, 4, 6, 64, 5, 64
LENGTHS = [0, 7, 33, 40, T - S, 12]


def _verify_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, KH * G, HD), dtype=np.float32)

    def block(t):
        return [
            rng.integers(-127, 128, (L, KH, B, t, HD), dtype=np.int8),
            rng.integers(-127, 128, (L, KH, B, t, HD), dtype=np.int8),
            (rng.random((L, KH, B, t), dtype=np.float32) * 0.02 + 0.01),
            (rng.random((L, KH, B, t), dtype=np.float32) * 0.02 + 0.01),
        ]

    return q, block(T), block(S), np.array(LENGTHS, np.int32)


def _to_paged(cache, pt, seed=1):
    """Pool leaves (L, KH, P, ...) and a (B, T / pt) table holding every
    row's slots on pages in a shuffled order; page 0 is the garbage page."""
    n_pages = cache[0].shape[3] // pt
    b = cache[0].shape[2]
    order = 1 + np.random.default_rng(seed).permutation(b * n_pages)
    table = order.reshape(b, n_pages).astype(np.int32)
    leaves = []
    for leaf in cache:
        pool = np.zeros(leaf.shape[:2] + ((b * n_pages + 1) * pt,) + leaf.shape[4:], leaf.dtype)
        for r in range(b):
            t = np.arange(leaf.shape[3])
            pool[:, :, table[r, t // pt] * pt + t % pt] = leaf[:, :, r]
        leaves.append(pool)
    return leaves, table


def _j(block):
    return tuple(jnp.asarray(x) if x.dtype == np.int8 else jnp.asarray(x).astype(jnp.bfloat16) for x in block)


def _t(block):
    return tuple(torch.from_numpy(x) if x.dtype == np.int8 else torch.from_numpy(x).to(torch.bfloat16)
                 for x in block)


@pytest.mark.parametrize("window", [T, 48])
def test_verify_attention_matches_jax_and_paged_twin(window):
    q, cache, ab, lengths = _verify_inputs()
    layer = 1
    ref = jda.verify_gqa_attention_xla(jnp.asarray(q), *_j(cache), jnp.int32(layer), jnp.asarray(lengths), _j(ab),
                                       window=window)
    out = tda.verify_gqa_attention(torch.from_numpy(q), *_t(cache), layer, torch.from_numpy(lengths), _t(ab),
                                   window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    leaves, table = _to_paged(cache, PT)
    pref = jda.paged_verify_gqa_attention_xla(
        jnp.asarray(q), *_j(leaves), jnp.int32(layer), jnp.asarray(lengths), jnp.asarray(table), _j(ab),
        window=window, page_tokens=PT,
    )
    pout = tda.paged_verify_gqa_attention(
        torch.from_numpy(q), *_t(leaves), layer, torch.from_numpy(lengths), torch.from_numpy(table), _t(ab),
        window=window, page_tokens=PT,
    )
    np.testing.assert_allclose(pout.numpy(), np.asarray(pref), **TOL)
    assert torch.equal(pout, out)


# ---------------------------------------------------------------------------
# forward's verify mode
# ---------------------------------------------------------------------------


def _prompts():
    """Four rows; rows 1 and 3 repeat, so prompt lookup finds matches
    (whether the random target accepts them is its own business)."""
    return [
        [5, 9, 14, 3, 27, 8, 11, 2, 40],
        [7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9, 10, 7, 8],
        [300, 301, 302],
        [2, 2, 2, 2, 2, 2, 2],
    ]


def _cold_caches(jp, jcfg, tcfg, prompts):
    """Caches holding each prompt but its last token (the chunk's ``tok``,
    whose KV is not yet written), from the JAX cold prefill; the port's
    copy of the same bytes."""
    b = len(prompts)
    s = max(len(p) for p in prompts) - 1
    toks = np.zeros((b, s), np.int32)
    lens = np.zeros((b,), np.int32)
    for r, p in enumerate(prompts):
        toks[r, : len(p) - 1] = p[:-1]
        lens[r] = len(p) - 1
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    _, cache = jllama.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jllama.init_kv_cache(jcfg, b, MAX_LEN),
                              jnp.asarray(lens), cold_prefill=True)
    np_cache = [np.asarray(c) for c in cache]
    return np_cache, lens


def test_forward_verify_mode_logits_match_jax(models, monkeypatch):
    monkeypatch.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    jp, _, tp, _ = models
    prompts = _prompts()
    np_cache, lens = _cold_caches(jp, JCFG, TCFG, prompts)
    rng = np.random.default_rng(3)
    s = 4
    inputs = rng.integers(0, JCFG.vocab_size, (len(prompts), s)).astype(np.int32)
    pos = (lens[:, None] + np.arange(s, dtype=np.int32)[None]).astype(np.int32)
    ab_shape = (JCFG.n_layers, JCFG.n_kv_heads, len(prompts), s, JCFG.head_dim)
    jab = (jnp.zeros(ab_shape, jnp.int8), jnp.zeros(ab_shape, jnp.int8),
           jnp.zeros(ab_shape[:-1], jnp.bfloat16), jnp.zeros(ab_shape[:-1], jnp.bfloat16))
    jh, _, jab = jllama.forward(jp, JCFG, jnp.asarray(inputs), jnp.asarray(pos), tuple(map(jnp.asarray, np_cache)),
                                jnp.asarray(lens), kv_bucket=32, append_cache=(jab, 0))
    tab = tuple(torch.zeros(x.shape, dtype=torch.int8 if x.dtype == jnp.int8 else torch.bfloat16) for x in jab)
    tcache = cache_from_numpy(np_cache, "cpu")
    th, _, tab = tllama.forward(tp, TCFG, torch.from_numpy(inputs).long(), torch.from_numpy(pos), tcache,
                                torch.from_numpy(lens), kv_bucket=32, append_cache=(tab, 0))
    np.testing.assert_allclose(tllama.logits(tp, th).numpy(), np.asarray(jllama.logits(jp, jh)), **TOL)
    for j, t in zip(jab[:2], tab[:2]):  # the fresh block's int8 values
        assert np.abs(np.asarray(j).astype(np.int32) - t.numpy().astype(np.int32)).max() <= 1
    for leaf, ref in zip(tcache, np_cache):  # the cache itself is only read
        assert np.array_equal(leaf.float().numpy(), np.asarray(ref).astype(np.float32))
    with pytest.raises(ValueError, match="verify append buffer"):
        tllama.forward(tp, TCFG, torch.from_numpy(inputs).long(), torch.from_numpy(pos), tcache,
                       torch.from_numpy(lens), append_cache=(tab, 1))


def test_forward_verify_mode_does_not_follow_the_window(models):
    """A row's verify logits are the same bits whatever ``kv_bucket`` the
    batch asks for: the scheduler buckets the window by the batch's longest
    row, so a bucket-length sum would let batch-mates move a row's greedy
    token (the port reads the whole cache in verify mode)."""
    jp, _, tp, _ = models
    prompts = _prompts()
    np_cache, lens = _cold_caches(jp, JCFG, TCFG, prompts)
    rng = np.random.default_rng(4)
    s = 4
    inputs = torch.from_numpy(rng.integers(0, TCFG.vocab_size, (len(prompts), s)).astype(np.int64))
    pos = torch.from_numpy((lens[:, None] + np.arange(s, dtype=np.int32)[None]).astype(np.int32))
    ab_shape = (TCFG.n_layers, TCFG.n_kv_heads, len(prompts), s, TCFG.head_dim)
    outs = []
    for kv_bucket in (16, 32, None):
        ab = (torch.zeros(ab_shape, dtype=torch.int8), torch.zeros(ab_shape, dtype=torch.int8),
              torch.zeros(ab_shape[:-1], dtype=torch.bfloat16), torch.zeros(ab_shape[:-1], dtype=torch.bfloat16))
        h, _, _ = tllama.forward(tp, TCFG, inputs, pos, cache_from_numpy(np_cache, "cpu"), torch.from_numpy(lens),
                                 kv_bucket=kv_bucket, append_cache=(ab, 0))
        outs.append(tllama.logits(tp, h))
    assert max(lens) + 1 <= 16
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# the four chunk functions, greedy
# ---------------------------------------------------------------------------

GAMMA, ROUNDS, KV_BUCKET = 3, 2, 32


def _greedy_args(prompts):
    b = len(prompts)
    tok = np.array([p[-1] for p in prompts], np.int32)
    lens = np.array([len(p) - 1 for p in prompts], np.int32)
    zeros = np.zeros((b,), np.float32)
    return tok, lens, zeros, np.ones((b,), np.float32), np.zeros((b,), np.int32)


def _hist(prompts):
    hist = np.zeros((len(prompts), MAX_LEN), np.int32)
    for r, p in enumerate(prompts):
        hist[r, : len(p)] = p
    return hist


def _chunk_case(models, kind, paged):
    """One greedy chunk of ``kind`` on each side, as two calls: the JAX
    chunk function's and the port's on the same inputs."""
    jp, jd, tp, td = models
    prompts = _prompts()
    np_cache, _ = _cold_caches(jp, JCFG, TCFG, prompts)
    tok, lens, temp, top_p, top_k = _greedy_args(prompts)
    jcommon = (jnp.asarray(tok), jnp.asarray(lens), jax.random.PRNGKey(0), jnp.asarray(temp), jnp.asarray(top_p),
               jnp.asarray(top_k), ROUNDS, GAMMA, KV_BUCKET)
    tcommon = (torch.from_numpy(tok), torch.from_numpy(lens), torch.Generator().manual_seed(0),
               torch.from_numpy(temp), torch.from_numpy(top_p), torch.from_numpy(top_k), ROUNDS, GAMMA, KV_BUCKET,
               False)
    if paged:
        leaves, table = _to_paged(np_cache, PT)
        jtarget = (tuple(map(jnp.asarray, leaves)), jnp.asarray(table))
        ttarget = (cache_from_numpy(leaves, "cpu"), torch.from_numpy(table))
    else:
        jtarget = (tuple(map(jnp.asarray, np_cache)),)
        ttarget = (cache_from_numpy(np_cache, "cpu"),)
    if kind == "draft":
        np_dcache, _ = _cold_caches(jd, JDCFG, TDCFG, prompts)
        jside = tuple(jnp.asarray(x) for x in np_dcache)
        if paged:
            jfn = jspec.make_paged_spec_chunk_fn(JCFG, JDCFG, None, MAX_LEN, PT)
            tfn = tspec.make_paged_spec_chunk_fn(TCFG, TDCFG, MAX_LEN, PT)
        else:
            jfn = jspec.make_spec_chunk_fn(JCFG, JDCFG, None, MAX_LEN)
            tfn = tspec.make_spec_chunk_fn(TCFG, TDCFG, MAX_LEN)
        return (lambda: jfn((jp, jd), *jtarget, jside, *jcommon),
                lambda: tfn((tp, td), *ttarget, cache_from_numpy(np_dcache, "cpu"), *tcommon))
    hist = _hist(prompts)
    if paged:
        jfn = jspec.make_paged_ngram_spec_chunk_fn(JCFG, None, MAX_LEN, PT, ngram=2)
        tfn = tspec.make_paged_ngram_spec_chunk_fn(TCFG, MAX_LEN, PT, ngram=2)
    else:
        jfn = jspec.make_ngram_spec_chunk_fn(JCFG, None, MAX_LEN, ngram=2)
        tfn = tspec.make_ngram_spec_chunk_fn(TCFG, MAX_LEN, ngram=2)
    return (lambda: jfn(jp, *jtarget, jnp.asarray(hist), *jcommon),
            lambda: tfn(tp, *ttarget, torch.from_numpy(hist.copy()), *tcommon))


CHUNK_CASES = [(kind, paged) for paged in (False, True) for kind in ("draft", "ngram")]


@pytest.fixture(scope="module")
def jax_chunks(models):
    """The four JAX chunk functions' outputs, compiled side by side (XLA
    compiles release the GIL)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GAIE_FORCE_APPEND_BUFFER", "1")
    try:
        with ThreadPoolExecutor(len(CHUNK_CASES)) as pool:
            outs = pool.map(lambda case: jax.tree.map(np.asarray, _chunk_case(models, *case)[0]()), CHUNK_CASES)
            return dict(zip(CHUNK_CASES, outs))
    finally:
        mp.undo()


@pytest.mark.parametrize("kind", ["draft", "ngram"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_greedy_chunk_matches_jax(models, jax_chunks, kind, paged):
    jout = jax_chunks[kind, paged]
    tout = _chunk_case(models, kind, paged)[1]()
    if kind == "ngram":
        assert np.array_equal(tout[1].numpy(), jout[1])  # the carried history
    assert np.array_equal(tout[3].numpy(), jout[3]), "n_emits"
    assert np.array_equal(tout[2].numpy(), jout[2]), "outs"


# ---------------------------------------------------------------------------
# gamma_bucket, self_draft, K4 at head_dim 64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma_max", [1, 3, 4, 8])
def test_gamma_bucket_matches_jax(gamma_max):
    for desired in range(-1, 11):
        assert tspec.gamma_bucket(desired, gamma_max) == jspec.gamma_bucket(desired, gamma_max)


def test_self_draft_shares_the_target_storage(models):
    _, _, tp, _ = models
    cfg = dataclasses.replace(TCFG, n_layers=2)
    dcfg, dp = tspec.self_draft(cfg, tp, 1)
    assert dcfg.n_layers == 1 and dp["embed"] is tp["embed"] and dp["lm_head"] is tp["lm_head"]
    for name, leaf in tp["layers"].items():
        sl = dp["layers"][name]
        if isinstance(leaf, BlockedQuantizedMatrix):
            assert sl.w.data_ptr() == leaf.w.data_ptr() and sl.w.shape[0] == 1 and (sl.k, sl.n) == (leaf.k, leaf.n)
            assert sl.scale.data_ptr() == leaf.scale.data_ptr()
        else:
            assert sl.data_ptr() == leaf.data_ptr() and sl.shape[0] == 1
    with pytest.raises(ValueError, match="self-draft depth"):
        tspec.self_draft(cfg, tp, 2)


def test_flash_plain_at_head_dim_64_matches_interpret_kernel():
    """K4's plain version at the draft's geometry (32 / 8 heads, head_dim
    64) against the interpret-mode Pallas kernel, on ragged lengths and a
    padded row; f32 within 1e-4."""
    rng = np.random.default_rng(5)
    b, s, nq, nkv, hd = 2, 32, 32, 8, 64
    q = rng.standard_normal((b, s, nq, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, nkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, nkv, hd), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[1, 20:] = -1
    lens = np.array([s, 19], np.int32)
    ref = jfa.flash_gqa_attention(*(jnp.asarray(a) for a in (q, k, v, pos, lens)), block_q=16, block_k=16,
                                  interpret=True)
    out = tfa.flash_gqa_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, lens)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out[1, 20:].any()
    assert 64 in tfa.HEAD_DIMS and 128 in tfa.HEAD_DIMS
