"""The decode kernels' launch plan (``ops/decode_attention.py::decode_plan``)
and their split-and-combine arithmetic, on the CPU.

The kernels (``csrc/decode_tile.cuh``) deal each row's 64-slot logical
tiles round-robin to ``splits`` blocks of a cluster; each block's 4 warps
take 16 slots of every tile and keep their own online softmax, and the
partials combine in warp order, then in split order.  Here that
arithmetic runs in plain torch and must match
``decode_gqa_attention_plain`` within the kernels' stated tolerance, and
the plan must cover each row's window exactly once, put the append buffer
in exactly one split, and be the same for the contiguous and paged
layouts.
"""

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.ops import _cuda
from generativeaiexamples_tpu_torch.ops import decode_attention as da

DECODE_TOL = dict(atol=5e-3, rtol=2e-2)  # as chip_smoke.py states for the kernels
WARPS, WARP_SLOTS = 4, 16


def deal_tiles(splits, n_cache, has_append):
    """The kernels' tile dealing: per split, the (first slot, slot count)
    of its tiles in the order it walks them.  A row's cache slots are cut
    into ``TILE``-slot logical tiles dealt round-robin; the append buffer,
    logical tile ``ceil(n_cache / TILE)``, is ``("append", 0)``."""
    n_ct = -(-n_cache // da.TILE)
    seq = [(i * da.TILE, min(da.TILE, n_cache - i * da.TILE)) for i in range(n_ct)]
    if has_append:
        seq.append(("append", 0))
    return [seq[z::splits] for z in range(splits)]


def test_plan_at_the_serving_shape():
    """B=32 rows x 8 kv heads: 2 splits give 512 blocks, ~3.9 per SM."""
    assert da.decode_plan(32, 8) == 2
    assert da.decode_plan(1, 8) == da.MAX_SPLITS
    assert da.decode_plan(128, 8) == 1
    assert da.decode_plan(17, 2) == 8


@pytest.mark.parametrize("b,n_kv,window", [(32, 8, 1024), (5, 2, 200), (1, 8, 2048), (2, 2, 300)])
def test_plan_covers_each_window_once(b, n_kv, window):
    splits = da.decode_plan(b, n_kv)
    assert 1 <= splits <= da.MAX_SPLITS and splits & (splits - 1) == 0
    edges = sorted({0, 1, window, window - 1} | {k * da.TILE + d for k in range(1, window // da.TILE + 1)
                                                 for d in (-1, 0, 1)})
    for n_cache in [n for n in edges if 0 <= n <= window]:
        for has_append in (False, True):
            per_split = deal_tiles(splits, n_cache, has_append)
            assert len(per_split) == splits
            slots = []
            appends = [z for z, tiles in enumerate(per_split) for t in tiles if t[0] == "append"]
            for tiles in per_split:
                cache_tiles = [t for t in tiles if t[0] != "append"]
                # Each split walks its tiles in ascending order, the append last.
                assert cache_tiles == sorted(cache_tiles) and tiles[: len(cache_tiles)] == cache_tiles
                for start, n in cache_tiles:
                    assert start % da.TILE == 0 and 1 <= n <= da.TILE
                    slots.extend(range(start, start + n))
            assert sorted(slots) == list(range(n_cache))
            assert len(appends) == (1 if has_append else 0)
            # The splits' loads differ by at most one tile.
            counts = [len(t) for t in per_split]
            assert max(counts) - min(counts) <= 1


def test_contiguous_and_paged_launch_the_same_split(monkeypatch):
    """Both wrappers pass the kernel the same ``splits`` for the same rows
    and heads, whatever the page size: the split points are logical slots,
    so K3 can equal K2 bit for bit."""
    seen = []

    def fake_function(name, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            seen.append((name, args[-3]))  # ..., splits, scale, stream
            return 0

        return fn

    monkeypatch.setattr(_cuda, "require", lambda cond, msg: None)
    monkeypatch.setattr(_cuda, "function", fake_function)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_cuda, "LAUNCHES", dict(_cuda.LAUNCHES))
    L, KH, B, T, HD, G = 1, 8, 32, 2048, 128, 4
    q = torch.zeros(B, KH * G, HD, dtype=torch.bfloat16)
    lengths = torch.zeros(B, dtype=torch.int32)
    cache = [torch.zeros(L, KH, B, T, HD, dtype=torch.int8)] * 2 + [torch.zeros(L, KH, B, T, dtype=torch.bfloat16)] * 2
    da.decode_attention_cuda(q, *cache, 0, lengths, None, 1024)
    for pt in (16, 64, 128):
        pool = [torch.zeros(L, KH, 4 * pt, HD, dtype=torch.int8)] * 2 + [torch.zeros(L, KH, 4 * pt, dtype=torch.bfloat16)] * 2
        table = torch.zeros(B, T // pt, dtype=torch.int32)
        da.paged_decode_attention_cuda(q, *pool, 0, lengths, table, None, 1024, pt)
    assert seen[0] == ("decode_attention", 2)
    assert seen[1:] == [("paged_decode_attention", 2)] * 3


@pytest.mark.parametrize("pt,ok", [(16, True), (64, True), (128, True), (48, False), (96, False)])
def test_paged_launch_takes_only_power_of_two_pages(monkeypatch, pt, ok):
    """The paged kernel addresses a slot by shifts and masks, so its wrapper
    refuses a page that is not a power of two of slots (the scheduler never
    makes one)."""
    failed = []
    monkeypatch.setattr(_cuda, "require", lambda cond, msg: cond or failed.append(msg))
    monkeypatch.setattr(_cuda, "function", lambda name, symbol, argtypes: lambda *args: 0)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_cuda, "LAUNCHES", dict(_cuda.LAUNCHES))
    L, KH, B, HD, G = 1, 2, 2, 128, 4
    q = torch.zeros(B, KH * G, HD, dtype=torch.bfloat16)
    pool = [torch.zeros(L, KH, 4 * pt, HD, dtype=torch.int8)] * 2 + [torch.zeros(L, KH, 4 * pt, dtype=torch.bfloat16)] * 2
    table = torch.zeros(B, 4, dtype=torch.int32)
    da.paged_decode_attention_cuda(q, *pool, 0, torch.zeros(B, dtype=torch.int32), table, None, pt, pt)
    assert any("power of two" in m for m in failed) != ok


def combine_partials(m, l, acc):
    """Merge per-part softmax partials as the kernels do: parts along dim 0
    (the warps of a block, then the splits of a cluster), combined in
    order.  ``m`` and ``l`` (P, ...) are each part's running max and
    weight sum, ``acc`` (P, ..., HD) its unnormalized output.  Returns the
    merged (m, l, acc); the output is ``acc / l.clamp_min(1e-30)``."""
    big_m = m.amax(dim=0)
    out_acc = torch.zeros_like(acc[0])
    out_l = torch.zeros_like(l[0])
    for i in range(m.shape[0]):
        f = torch.exp(m[i] - big_m)
        out_acc = out_acc + acc[i] * f[..., None]
        out_l = out_l + l[i] * f
    return big_m, out_l, out_acc


def _inputs(seed, L, KH, B, T, HD, G, C, count, with_append):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, KH * G, HD), dtype=np.float32)).to(torch.bfloat16)
    k8 = torch.from_numpy(rng.integers(-127, 128, (L, KH, B, T, HD), dtype=np.int8))
    v8 = torch.from_numpy(rng.integers(-127, 128, (L, KH, B, T, HD), dtype=np.int8))
    ks = torch.from_numpy(rng.random((L, KH, B, T), dtype=np.float32) * 0.015 + 0.005).to(torch.bfloat16)
    vs = torch.from_numpy(rng.random((L, KH, B, T), dtype=np.float32) * 0.015 + 0.005).to(torch.bfloat16)
    append = None
    if with_append:
        append = (
            torch.from_numpy(rng.integers(-127, 128, (L, KH, B, C, HD), dtype=np.int8)),
            torch.from_numpy(rng.integers(-127, 128, (L, KH, B, C, HD), dtype=np.int8)),
            torch.from_numpy(rng.random((L, KH, B, C), dtype=np.float32) * 0.015 + 0.005).to(torch.bfloat16),
            torch.from_numpy(rng.random((L, KH, B, C), dtype=np.float32) * 0.015 + 0.005).to(torch.bfloat16),
            count,
        )
    return q, k8, v8, ks, vs, append


def _split_kernel_arithmetic(q, k8, v8, ks, vs, layer, lengths, append, window):
    """The kernels' order of work in plain f32 torch: per (row, kv head),
    per split, per warp an online softmax over the warp's slots of each of
    the split's tiles (p * vscale rounded to bf16), then the warps'
    partials combined in order, then the splits'."""
    b, n_q, hd = q.shape
    n_kv = k8.shape[1]
    g = n_q // n_kv
    scale = hd**-0.5
    splits = da.decode_plan(b, n_kv)
    out = torch.zeros(b, n_q, hd)
    for r in range(b):
        n_cache = max(0, min(int(lengths[r]), window))
        for h in range(n_kv):
            qh = q[r, h * g:(h + 1) * g].float()
            parts = []
            for split_tiles in deal_tiles(splits, n_cache, append is not None and append[4] > 0):
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), -1e30)
                    l = torch.zeros(g)
                    acc = torch.zeros(g, hd)
                    for start, n in split_tiles:
                        if start == "append":
                            kk, vv, kss, vss = (x[layer, h, r] for x in append[:4])
                            start, n = 0, append[4]
                        else:
                            kk, vv, kss, vss = k8[layer, h, r], v8[layer, h, r], ks[layer, h, r], vs[layer, h, r]
                        sl = slice(start + w * WARP_SLOTS, start + min(n, (w + 1) * WARP_SLOTS))
                        if w * WARP_SLOTS >= n:
                            continue
                        s = (qh @ kk[sl].float().T * scale) * kss[sl].float()
                        m_new = torch.maximum(m, s.amax(dim=1))
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * alpha + p.sum(dim=1)
                        pv = (p * vss[sl].float()).to(torch.bfloat16).float()
                        acc = acc * alpha[:, None] + pv @ vv[sl].float()
                        m = m_new
                    warps.append((m, l, acc))
                parts.append(combine_partials(*(torch.stack(x) for x in zip(*warps))))
            _, l, acc = combine_partials(*(torch.stack(x) for x in zip(*parts)))
            out[r, h * g:(h + 1) * g] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("with_append", [False, True])
def test_split_combine_matches_plain(with_append):
    L, KH, B, T, HD, G, C = 2, 2, 9, 300, 128, 4, 8
    window, count = 256, 5
    q, k8, v8, ks, vs, append = _inputs(7, L, KH, B, T, HD, G, C, count, with_append)
    # An empty row, tile and split boundaries +-1, the window, a pinned lane.
    lengths = torch.tensor([0, 1, 63, 64, 65, 129, 200, window, T - 1], dtype=torch.int32)
    out = _split_kernel_arithmetic(q, k8, v8, ks, vs, 1, lengths, append, window)
    ref = da.decode_gqa_attention_plain(q, k8, v8, ks, vs, 1, lengths, append, window=window)
    torch.testing.assert_close(out, ref, **DECODE_TOL)
    if not with_append:
        assert not out[0].any()  # empty row: exact zeros


def test_split_result_does_not_move_with_the_window():
    """The scheduler's window is a bucket of the batch's longest row; a row
    shorter than both windows must get the same bits under either, so a
    prompt decodes alike alone and in a batch."""
    L, KH, B, T, HD, G, C = 1, 2, 4, 600, 128, 4, 8
    q, k8, v8, ks, vs, append = _inputs(8, L, KH, B, T, HD, G, C, 3, True)
    lengths = torch.tensor([40, 130, 64, 0], dtype=torch.int32)
    small = _split_kernel_arithmetic(q, k8, v8, ks, vs, 0, lengths, append, 192)
    large = _split_kernel_arithmetic(q, k8, v8, ks, vs, 0, lengths, append, 576)
    assert torch.equal(small, large)
