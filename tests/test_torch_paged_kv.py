"""The port's paged KV layout against the JAX reference and against the
port's own contiguous layout, on the CPU.

* Pool operations: the same sequence of ``make_writable`` (with a
  copy-on-write), ``share``, ``share_pages``, ``trim``, ``detach``,
  ``release`` and ``reset_slot`` on the JAX pool and the port's pool gives
  equal tables, refcounts, free lists, ``PAGE_EVENTS`` deltas and leaves.
* Paged plain attention: bit for bit the port's contiguous plain version
  on mirrored content, with and without the append buffer; within 1e-4 of
  ``paged_decode_gqa_attention_xla``; within the reference's own rtol 1e-3
  / atol 1e-4 of the interpret-mode Pallas kernel.
* The paged append-buffer flush equals the reference's exactly.
* Tiny-Llama ``forward`` gives bitwise-equal logits paged and contiguous
  on the warm path and the append-buffer decode path.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import decode as jdecode
from generativeaiexamples_tpu.engine import paged_kv as jpaged
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.ops import decode_attention as jda
from generativeaiexamples_tpu_torch.engine import decode as tdecode
from generativeaiexamples_tpu_torch.engine import paged_kv as tpaged
from generativeaiexamples_tpu_torch.engine.weights import pool_from_numpy
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.ops import decode_attention as tda

L, KH, B, T, G, C = 2, 2, 4, 128, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_threads():
    """One large elementwise op before anything else in the module.  The
    first parallel torch op of a process, run right after JAX work, has
    been seen to compute ``exp`` at reduced precision in some of its fresh
    worker threads (~1e-4 relative, that call only); the bitwise
    comparisons here must not see that call."""
    torch.exp(torch.linspace(-5.0, 5.0, 1 << 20)).sum()


def _cfgs(hd):
    kw = dict(n_layers=L, n_kv_heads=KH, n_heads=KH * G, head_dim=hd, kv_dtype="int8", max_seq_len=T)
    return jllama.llama_tiny(**kw), tllama.llama_tiny(**kw)


def _bf16_torch(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# pool operations
# ---------------------------------------------------------------------------


def _pool_state(pool):
    return (
        np.asarray(pool.tables).tolist(),
        np.asarray(pool._refcount).tolist(),
        list(pool._free),
        np.asarray(pool._held).tolist(),
        pool.cow_breaks,
        pool.frees_total,
    )


@pytest.mark.parametrize("hd,pt", [(64, 16), (128, 64)])
def test_pool_operations_match_jax(hd, pt):
    jcfg, tcfg = _cfgs(hd)
    rng = np.random.default_rng(0)
    jpool = jpaged.PagedKVPool(jcfg, B, 4 * pt, pt)
    # Random content, so the copy-on-write copies something visible.
    jpool.leaves = tuple(
        jnp.asarray(rng.integers(-127, 128, leaf.shape, dtype=np.int8)) if leaf.dtype == jnp.int8
        else jnp.asarray(rng.random(leaf.shape, dtype=np.float32)).astype(jnp.bfloat16)
        for leaf in jpool.leaves
    )
    tpool = pool_from_numpy(jpool, tcfg, "cpu")
    assert _pool_state(tpool) == _pool_state(jpool)

    def step(fn):
        before = (dict(jpaged.PAGE_EVENTS), dict(tpaged.PAGE_EVENTS))
        out = (fn(jpool), fn(tpool))
        jdelta = {k: jpaged.PAGE_EVENTS[k] - before[0][k] for k in before[0]}
        tdelta = {k: tpaged.PAGE_EVENTS[k] - before[1][k] for k in before[1]}
        assert tdelta == jdelta
        assert _pool_state(tpool) == _pool_state(jpool)
        assert np.array_equal(np.asarray(jpool.device_table()), tpool.device_table().numpy())
        return out, jdelta

    step(lambda p: p.make_writable(0, 0, 2 * pt + 5))  # three pages
    step(lambda p: p.share(0, 1, 2 * pt + 1))  # zero-copy graft of all three
    _, delta = step(lambda p: p.make_writable(1, pt + 3, 3 * pt))  # COW of two shared pages
    assert delta["cow_copies"] == 2 and delta["cow_dispatch"] == 1
    assert delta["device_graft_dispatch"] == 0
    for jl, tl in zip(jpool.leaves, tpool.leaves):
        assert np.array_equal(np.asarray(jl).astype(np.float32), tl.float().numpy())
    (pages, tpages), _ = step(lambda p: p.detach(0))
    assert pages == tpages and len(pages) == 3
    step(lambda p: p.share_pages(pages, 2, 2 * pt + 1))
    step(lambda p: p.trim(1, pt + 1))
    step(lambda p: p.release(pages))
    step(lambda p: p.reset_slot(2))
    step(lambda p: p.reset_slot(1))
    assert tpool.pages_free == tpool.total_pages - 1 and int(tpool._refcount.sum()) == 1


def test_pool_floor_garbage_page_and_exhaustion():
    _, tcfg = _cfgs(64)
    pool = tpaged.PagedKVPool(tcfg, 2, 64, 16, total_pages=1, device="cpu")
    assert pool.n_slot_pages == 4 and pool.total_pages == 2 * 4 + 1
    assert tpaged.num_slot_pages(129, 16) == 9 and tpaged.num_slot_pages(0, 16) == 0
    for i in range(2):
        pool.make_writable(i, 0, 64)
    assert pool.pages_free == 0 and 0 not in pool.tables
    with pytest.raises(tpaged.PoolExhausted):
        pool._alloc()
    with pytest.raises(ValueError, match="reset first"):
        pool.share(0, 1, 16)
    pool.leaves[0].fill_(3)
    pool.reset_all()
    assert pool.pages_free == pool.total_pages - 1 and not pool.leaves[0].any()
    with pytest.raises(ValueError, match="int8"):
        tpaged.PagedKVPool(tllama.llama_tiny(), 2, 64, 16, device="cpu")


def test_device_table_uploads_from_a_copy():
    _, tcfg = _cfgs(64)
    pool = tpaged.PagedKVPool(tcfg, 2, 64, 16, device="cpu")
    pool.make_writable(0, 0, 20)
    table = pool.device_table()
    assert pool.device_table() is table  # unchanged host state: no upload
    snapshot = table.clone()
    pool.make_writable(1, 0, 20)
    assert torch.equal(table, snapshot)  # the host edit never reaches it
    assert pool.device_table() is not table


# ---------------------------------------------------------------------------
# paged plain attention
# ---------------------------------------------------------------------------


def _contiguous(rng, hd, t=T):
    return (
        rng.integers(-127, 128, (L, KH, B, t, hd), dtype=np.int8),
        rng.integers(-127, 128, (L, KH, B, t, hd), dtype=np.int8),
        (rng.random((L, KH, B, t), dtype=np.float32) * 0.02 + 0.01),
        (rng.random((L, KH, B, t), dtype=np.float32) * 0.02 + 0.01),
    )


def _mirror(cache, lengths, pt, hd, rng, own=None):
    """Pool leaves and table holding each row's first ``lengths[b]`` slots
    of ``cache`` on pages taken in a shuffled order; row b owns the pages
    of its first ``own`` tokens (default: its length), the rest of its
    table is the garbage page."""
    _, tcfg = _cfgs(hd)
    pool = tpaged.PagedKVPool(tcfg, len(lengths), T, pt, device="cpu")
    pool._free = [int(p) for p in rng.permutation(pool._free)]
    for b, n in enumerate(lengths):
        pool.make_writable(b, 0, n if own is None else own)
    leaves = [np.zeros(tuple(x.shape), dtype=np.float32 if x.dtype == torch.bfloat16 else np.int8)
              for x in pool.leaves]
    for b, n in enumerate(lengths):
        t = np.arange(n)
        flat = pool.tables[b][t // pt] * pt + t % pt
        for leaf, src in zip(leaves, cache):
            leaf[:, :, flat] = src[:, :, b, :n]
    return leaves, pool.tables.copy()


LENGTHS = [0, 7, 33, T - 1]


def _attention_inputs(hd, pt, seed):
    rng = np.random.default_rng(seed)
    cache = _contiguous(rng, hd)
    q = rng.standard_normal((B, KH * G, hd), dtype=np.float32)
    ab = _contiguous(rng, hd, t=C)
    leaves, table = _mirror(cache, LENGTHS, pt, hd, rng)
    return q, cache, ab, leaves, table


@pytest.mark.parametrize("with_append", [False, True])
@pytest.mark.parametrize("hd,pt", [(64, 16), (128, 64)])
def test_paged_plain_bitwise_equal_to_contiguous_plain(hd, pt, with_append):
    q, cache, ab, leaves, table = _attention_inputs(hd, pt, 1)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    t_ab = (*(torch.from_numpy(a) for a in ab[:2]), *(_bf16_torch(a) for a in ab[2:]), 5) if with_append else None
    tq = torch.from_numpy(q)
    contiguous = [torch.from_numpy(c) for c in cache[:2]] + [_bf16_torch(c) for c in cache[2:]]
    pooled = [torch.from_numpy(x) for x in leaves[:2]] + [_bf16_torch(x) for x in leaves[2:]]
    for layer in range(L):
        for window in (T, 64):
            ref = tda.decode_gqa_attention_plain(tq, *contiguous, layer, lengths, t_ab, window=window)
            out = tda.paged_decode_gqa_attention(
                tq, *pooled, layer, lengths, torch.from_numpy(table), t_ab, window=window, page_tokens=pt
            )
            assert torch.equal(out, ref), (layer, window)
    if not with_append:
        assert not out[0].any()  # the empty row gives exact zeros


@pytest.mark.parametrize("with_append", [False, True])
@pytest.mark.parametrize("hd,pt", [(64, 16), (128, 64)])
def test_paged_plain_matches_jax(hd, pt, with_append):
    q, _, ab, leaves, table = _attention_inputs(hd, pt, 2)
    lengths = np.array(LENGTHS, np.int32)
    j_ab = t_ab = None
    if with_append:
        j_ab = (jnp.asarray(ab[0]), jnp.asarray(ab[1]), jnp.asarray(ab[2]).astype(jnp.bfloat16),
                jnp.asarray(ab[3]).astype(jnp.bfloat16), jnp.int32(5))
        t_ab = (torch.from_numpy(ab[0]), torch.from_numpy(ab[1]), _bf16_torch(ab[2]), _bf16_torch(ab[3]), 5)
    j_leaves = [jnp.asarray(x) for x in leaves[:2]] + [jnp.asarray(x).astype(jnp.bfloat16) for x in leaves[2:]]
    t_leaves = [torch.from_numpy(x) for x in leaves[:2]] + [_bf16_torch(x) for x in leaves[2:]]
    out = tda.paged_decode_gqa_attention(
        torch.from_numpy(q), *t_leaves, 1, torch.from_numpy(lengths), torch.from_numpy(table), t_ab,
        window=T, page_tokens=pt,
    ).numpy()
    jargs = (jnp.asarray(q), *j_leaves, jnp.int32(1), jnp.asarray(lengths), jnp.asarray(table), j_ab)
    xla = np.asarray(jda.paged_decode_gqa_attention_xla(*jargs, window=T, page_tokens=pt))
    np.testing.assert_allclose(out, xla, atol=1e-4, rtol=1e-4)
    kernel = np.asarray(jda.paged_decode_gqa_attention(*jargs, page_tokens=pt, interpret=True), np.float32)
    np.testing.assert_allclose(out, kernel, rtol=1e-3, atol=1e-4)


def test_paged_flush_equals_reference():
    rng = np.random.default_rng(3)
    pt, hd = 16, 64
    cache = _contiguous(rng, hd)
    # Rows: an empty lane (table all garbage), a lane pinned at T - 1 whose
    # tail entries are unowned, and two live lanes.
    leaves, table = _mirror(cache, [0, 40, 70, 100], pt, hd, rng)
    assert (table[0] == 0).all() and (table[1, -1] == 0)
    ab = _contiguous(rng, hd, t=C)
    starts = np.array([0, T - 1, 69, 99], np.int32)
    ref = jdecode._flush_append_buffer_paged(
        tuple(jnp.asarray(x) for x in leaves), tuple(jnp.asarray(x) for x in ab),
        jnp.asarray(starts), jnp.asarray(table), T, pt,
    )
    out = tdecode._flush_append_buffer_paged(
        tuple(torch.from_numpy(x.copy()) for x in leaves), tuple(torch.from_numpy(x) for x in ab),
        torch.from_numpy(starts), torch.from_numpy(table), T, pt,
    )
    for r, o in zip(ref, out):
        assert np.array_equal(np.asarray(r), o.numpy())


# ---------------------------------------------------------------------------
# tiny Llama: paged forward equals contiguous forward bit for bit
# ---------------------------------------------------------------------------


def test_forward_paged_equals_contiguous():
    cfg = tllama.llama_tiny(dtype="float32", max_seq_len=T, kv_dtype="int8")
    params = tdecode.prepare_params(cfg, None, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    b, s0, pt = 3, 24, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s0))).long()
    lengths = torch.tensor([24, 17, 9], dtype=torch.int32)
    pos = torch.arange(s0, dtype=torch.int32).expand(b, s0).contiguous()
    cache = tllama.init_kv_cache(cfg, b, T, device="cpu")
    with torch.inference_mode():
        tllama.forward(params, cfg, tokens, pos, cache, lengths, cold_prefill=True)
    np_cache = [c.numpy() if c.dtype != torch.bfloat16 else c.float().numpy() for c in cache]
    # Each row owns pages for the whole logical capacity, so the warm and
    # flush writes land on private pages.
    leaves, table = _mirror(np_cache, lengths.tolist(), pt, cfg.head_dim, rng, own=T)
    leaves = [torch.from_numpy(x) for x in leaves[:2]] + [_bf16_torch(x) for x in leaves[2:]]
    paged = dict(page_table=torch.from_numpy(table), page_tokens=pt, pages_len=T)
    with torch.inference_mode():
        # Warm chunk of 8 tokens per row at each row's length.
        warm = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 8))).long()
        wpos = lengths[:, None] + torch.arange(8, dtype=torch.int32)[None, :]
        h_c, _ = tllama.forward(params, cfg, warm, wpos, cache, lengths + 8, kv_bucket=64)
        h_p, _ = tllama.forward(params, cfg, warm, wpos, leaves, lengths + 8, kv_bucket=64, **paged)
        assert torch.equal(tllama.logits(params, h_p), tllama.logits(params, h_c))
        # Two decode chunks of two steps through both chunk functions.
        c_fn = tdecode.make_decode_chunk_fn(cfg, T)
        p_fn = tdecode.make_paged_decode_chunk_fn(cfg, T, pt)
        tok = warm[:, -1].to(torch.int32)
        lens = lengths + 8
        samp = (torch.zeros(b), torch.ones(b), torch.zeros(b, dtype=torch.int32))
        for _ in range(2):
            _, tc = c_fn(params, cache, tok, lens, torch.Generator().manual_seed(0), *samp, 2, 64)
            _, tp = p_fn(params, leaves, paged["page_table"], tok, lens, torch.Generator().manual_seed(0), *samp, 2, 64)
            assert torch.equal(tc, tp)
            tok, lens = tc[-1], lens + 2
        # One append-buffer step, logits compared directly.
        ab = tuple(torch.zeros(x, dtype=d) for x, d in (
            ((cfg.n_layers, cfg.n_kv_heads, b, 1, cfg.head_dim), torch.int8),
            ((cfg.n_layers, cfg.n_kv_heads, b, 1, cfg.head_dim), torch.int8),
            ((cfg.n_layers, cfg.n_kv_heads, b, 1), torch.bfloat16),
            ((cfg.n_layers, cfg.n_kv_heads, b, 1), torch.bfloat16)))
        ab2 = tuple(x.clone() for x in ab)
        h_c, _, _ = tllama.forward(params, cfg, tok[:, None].long(), lens[:, None], cache, lens,
                                   kv_bucket=64, append_cache=(ab, 0))
        h_p, _, _ = tllama.forward(params, cfg, tok[:, None].long(), lens[:, None], leaves, lens,
                                   kv_bucket=64, append_cache=(ab2, 0), **paged)
        assert torch.equal(tllama.logits(params, h_p), tllama.logits(params, h_c))


def test_forward_paged_rejects_cold_prefill():
    cfg = tllama.llama_tiny(dtype="float32", max_seq_len=T, kv_dtype="int8")
    pool = tpaged.PagedKVPool(cfg, 1, T, 16, device="cpu")
    with pytest.raises(ValueError, match="cold_prefill"):
        tllama.forward({}, cfg, torch.zeros((1, 4), dtype=torch.long), torch.zeros((1, 4), dtype=torch.int32),
                       pool.leaves, torch.ones(1, dtype=torch.int32), cold_prefill=True,
                       page_table=pool.device_table(), page_tokens=16, pages_len=T)


def test_pool_from_numpy_carries_the_reference_state():
    jcfg, tcfg = _cfgs(64)
    jpool = jpaged.PagedKVPool(dataclasses.replace(jcfg), 2, 64, 16)
    jpool.make_writable(0, 0, 40)
    jpool.share(0, 1, 20)
    tpool = pool_from_numpy(jpool, tcfg, "cpu")
    assert _pool_state(tpool) == _pool_state(jpool)
    assert [tuple(x.shape) for x in tpool.leaves] == [tuple(x.shape) for x in jpool.leaves]
