"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests skip without a card (the
decision is made inside the fixture).  On a machine with one:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from chip_smoke import paged_mirror
from generativeaiexamples_tpu_torch.ops import _cuda
from generativeaiexamples_tpu_torch.ops import decode_attention as da
from generativeaiexamples_tpu_torch.ops import flash_attention as fa
from generativeaiexamples_tpu_torch.ops import qmm, quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


QMM_M = (1, 5, 16, 32, 33, 64, 65, 130, 256, 2048)
# Llama-3-8B widths (wqkv, w_down) and a ragged N (five 64-column blocks).
QMM_KN = ((4096, 6144), (14336, 4096), (384, 320))


def _check_qmm(xq, a_scale, w, ws, n, out_dtype):
    """One kernel call per launch, bit-equal to the plain version, the same
    bits on a second call (no state left between launches), and the design
    the plan names."""
    design = qmm.qmm_plan(xq.shape[0], w.shape[0], w.shape[1]).design
    before, before_design = _cuda.LAUNCHES["qmm"], qmm.DESIGN_LAUNCHES[design]
    out = qmm.qmm_cuda(xq, a_scale, w, ws, n, out_dtype)
    again = qmm.qmm_cuda(xq, a_scale, w, ws, n, out_dtype)
    assert _cuda.LAUNCHES["qmm"] == before + 2
    assert qmm.DESIGN_LAUNCHES[design] == before_design + 2
    assert design == ("decode" if xq.shape[0] <= qmm.DECODE_MAX_M else "wide")
    assert torch.equal(out, qmm.qmm_plain(xq, a_scale, w, ws, n, out_dtype))
    assert torch.equal(out, again)


@pytest.mark.parametrize("m", QMM_M)
@pytest.mark.parametrize("k,n", QMM_KN)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_qmm_bit_identical(dev, m, k, n, out_dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=g)
    ws = torch.rand(n, device=dev, generator=g) * 1e-2
    xq, a_scale = qmm.quantize_activations(torch.randn(m, k, device=dev, generator=g))
    _check_qmm(xq, a_scale, w, ws, n, out_dtype)


@pytest.mark.parametrize("m", (32, 256))
def test_qmm_on_a_stacked_layer_view(dev, m):
    """Layer i > 0 of a stacked weight is a view whose base is offset by
    i·N_pad·K_pad bytes; the kernel must read that layer's rows only (the
    ragged N tile's padding rows of the next layer are not its own)."""
    g = torch.Generator(device=dev).manual_seed(5)
    k, n = 384, 300
    bw = qmm.block_matrix(quant.quantize_matrix(torch.randn(3, k, n, device=dev, generator=g)))
    layer = bw.layer(1)
    assert layer.w.data_ptr() == bw.w.data_ptr() + bw.w[0].numel()
    xq, a_scale = qmm.quantize_activations(torch.randn(m, k, device=dev, generator=g))
    xq = torch.nn.functional.pad(xq, (0, layer.w.shape[1] - k)).contiguous()
    _check_qmm(xq, a_scale, layer.w, layer.scale, n, torch.bfloat16)


@pytest.mark.parametrize("with_append", [False, True])
def test_decode_attention_close(dev, with_append):
    g = torch.Generator(device=dev).manual_seed(1)
    L, KH, B, T, HD, G, C = 2, 2, 5, 300, 128, 4, 4
    q = torch.randn(B, KH * G, HD, device=dev, generator=g).to(torch.bfloat16)
    k8 = torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=g)
    v8 = torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=g)
    ks = (torch.rand(L, KH, B, T, device=dev, generator=g) * 0.01 + 0.005).to(torch.bfloat16)
    vs = (torch.rand(L, KH, B, T, device=dev, generator=g) * 0.01 + 0.005).to(torch.bfloat16)
    append = None
    if with_append:
        append = (
            torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=g),
            torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=g),
            (torch.rand(L, KH, B, C, device=dev, generator=g) * 0.01 + 0.005).to(torch.bfloat16),
            (torch.rand(L, KH, B, C, device=dev, generator=g) * 0.01 + 0.005).to(torch.bfloat16),
            3,
        )
    lengths = torch.tensor([0, T - 1, 70, 200, 129], dtype=torch.int32, device=dev)
    out = da.decode_gqa_attention(q, k8, v8, ks, vs, 1, lengths, append, window=200)
    ref = da.decode_gqa_attention_plain(q, k8, v8, ks, vs, 1, lengths, append, window=200)
    torch.testing.assert_close(out, ref, atol=5e-3, rtol=2e-2)
    if not with_append:
        assert not out[0].any()


@pytest.mark.parametrize("pt", [16, 64])
@pytest.mark.parametrize("with_append", [False, True])
def test_paged_decode_attention_close_and_equal_to_contiguous(dev, pt, with_append):
    g = torch.Generator(device=dev).manual_seed(4)
    L, KH, B, T, HD, G, C = 2, 2, 5, 320, 128, 4, 4
    q = torch.randn(B, KH * G, HD, device=dev, generator=g).to(torch.bfloat16)
    cache = (
        torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=g),
        torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=g),
        (torch.rand(L, KH, B, T, device=dev, generator=g) * 0.01 + 0.005).to(torch.bfloat16),
        (torch.rand(L, KH, B, T, device=dev, generator=g) * 0.01 + 0.005).to(torch.bfloat16),
    )
    append = None
    if with_append:
        append = (
            torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=g),
            torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=g),
            (torch.rand(L, KH, B, C, device=dev, generator=g) * 0.01 + 0.005).to(torch.bfloat16),
            (torch.rand(L, KH, B, C, device=dev, generator=g) * 0.01 + 0.005).to(torch.bfloat16),
            3,
        )
    window = 192
    lengths = torch.tensor([0, T - 1, 70, 192, 129], dtype=torch.int32, device=dev)
    # The pinned lane owns only its window's pages: its tail is page 0.
    leaves, table = paged_mirror(torch, cache, [0, window, 70, 192, 129], pt, torch.Generator().manual_seed(pt))
    before = _cuda.LAUNCHES["paged_decode_attention"]
    out = da.paged_decode_gqa_attention(q, *leaves, 1, lengths, table, append, window=window, page_tokens=pt)
    assert _cuda.LAUNCHES["paged_decode_attention"] == before + 1
    ref = da.paged_decode_gqa_attention_plain(q, *leaves, 1, lengths, table, append, window=window, page_tokens=pt)
    torch.testing.assert_close(out, ref, atol=5e-3, rtol=2e-2)
    k2 = da.decode_gqa_attention(q, *cache, 1, lengths, append, window=window)
    assert torch.equal(out, k2)  # same tiles, same order: K2's bits
    if not with_append:
        assert not out[0].any()


def test_paged_decode_attention_raises_on_shapes_it_cannot_serve(dev):
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16, device=dev)
    pool = [torch.zeros(1, 2, 64, 64, dtype=torch.int8, device=dev)] * 2
    scales = [torch.zeros(1, 2, 64, dtype=torch.bfloat16, device=dev)] * 2
    table = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    lengths = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        da.paged_decode_gqa_attention(q, *pool, *scales, 0, lengths, table, window=64, page_tokens=16)


def test_flash_attention_close(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    b, s, nq, nkv, hd = 3, 100, 8, 2, 128
    q = torch.randn(b, s, nq, hd, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, nkv, hd, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, nkv, hd, device=dev, generator=g).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    pos[1, 60:] = -1
    lengths = torch.tensor([100, 60, 0], dtype=torch.int32, device=dev)
    out = fa.flash_gqa_attention(q, k, v, pos, lengths)
    ref = fa.flash_gqa_attention_plain(q, k, v, pos, lengths)
    torch.testing.assert_close(out, ref, atol=1e-2, rtol=2e-2)
    assert not out[1, 60:].any() and not out[2].any()


def _int8_cache(dev, g, shape):
    return (
        torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g),
        torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g),
        (torch.rand(shape[:-1], device=dev, generator=g) * 0.015 + 0.005).to(torch.bfloat16),
        (torch.rand(shape[:-1], device=dev, generator=g) * 0.015 + 0.005).to(torch.bfloat16),
    )


def _poisoned_call(torch_fn, like):
    """Call once on a freed NaN-filled block of the output's size (the
    caching allocator hands it back), so a slot the kernel leaves unwritten
    shows; then again on the same buffer, which must give the same bits."""
    junk = torch.full_like(like, float("nan"))
    del junk
    first = torch_fn()
    keep = first.clone()
    del first
    second = torch_fn()
    assert torch.equal(second, keep)
    return second


# Window 512 = 8 tiles; 17 rows x 2 kv heads plan 8 splits, one tile each.
SPLIT_WINDOW = 512
SPLIT_LENGTHS = (0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 447, 448, 449, 511, SPLIT_WINDOW, 1023)


@pytest.mark.parametrize("with_append", [False, True])
def test_decode_attention_split_boundaries(dev, with_append):
    """Lengths at every tile/split boundary +-1, 0, the window and a lane
    pinned at T - 1, on a plan with 8 splits: within tolerance of the plain
    version, exact zeros on the empty lane, and the same bits on a reused
    (poisoned) output buffer."""
    g = torch.Generator(device=dev).manual_seed(11)
    L, KH, HD, G, C, T = 2, 2, 128, 4, 8, 1024
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    B = lengths.numel()
    assert da.decode_plan(B, KH) == 8
    q = torch.randn(B, KH * G, HD, device=dev, generator=g).to(torch.bfloat16)
    cache = _int8_cache(dev, g, (L, KH, B, T, HD))
    append = (*_int8_cache(dev, g, (L, KH, B, C, HD)), 5) if with_append else None
    out = _poisoned_call(lambda: da.decode_gqa_attention(q, *cache, 1, lengths, append, window=SPLIT_WINDOW), q)
    ref = da.decode_gqa_attention_plain(q, *cache, 1, lengths, append, window=SPLIT_WINDOW)
    torch.testing.assert_close(out, ref, atol=5e-3, rtol=2e-2)
    if not with_append:
        assert not out[0].any()


@pytest.mark.parametrize("pt", [16, 32, 64, 128])
@pytest.mark.parametrize("with_append", [False, True])
def test_paged_decode_attention_split_equals_contiguous(dev, pt, with_append):
    """K3 through a shuffled page table equals K2 bit for bit with the split
    (8 splits), at every page size, and is within tolerance of its plain
    version."""
    g = torch.Generator(device=dev).manual_seed(12)
    L, KH, HD, G, C, T = 2, 2, 128, 4, 8, 1024
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    B = lengths.numel()
    q = torch.randn(B, KH * G, HD, device=dev, generator=g).to(torch.bfloat16)
    cache = _int8_cache(dev, g, (L, KH, B, T, HD))
    append = (*_int8_cache(dev, g, (L, KH, B, C, HD)), 5) if with_append else None
    own = lengths.clamp(max=SPLIT_WINDOW).tolist()
    leaves, table = paged_mirror(torch, cache, own, pt, torch.Generator().manual_seed(pt))
    out = _poisoned_call(lambda: da.paged_decode_gqa_attention(
        q, *leaves, 1, lengths, table, append, window=SPLIT_WINDOW, page_tokens=pt), q)
    k2 = da.decode_gqa_attention(q, *cache, 1, lengths, append, window=SPLIT_WINDOW)
    assert torch.equal(out, k2)
    ref = da.paged_decode_gqa_attention_plain(q, *leaves, 1, lengths, table, append, window=SPLIT_WINDOW,
                                              page_tokens=pt)
    torch.testing.assert_close(out, ref, atol=5e-3, rtol=2e-2)


@pytest.mark.parametrize("B,KH", [(32, 8), (5, 2)])
@pytest.mark.parametrize("with_append", [False, True])
def test_decode_attention_does_not_move_with_the_window(dev, B, KH, with_append):
    """The scheduler's window is a bucket of the batch's longest row: rows
    shorter than both windows get the same bits from K2 and from K3 under
    window 192 and window 576, so a prompt decodes alike alone and in a
    batch (at the serving plan, 2 splits, and at 8 splits)."""
    g = torch.Generator(device=dev).manual_seed(14)
    L, HD, G, C, T, pt = 1, 128, 4, 8, 640, 64
    lengths = torch.randint(0, 192, (B,), dtype=torch.int32, device=dev, generator=g)
    lengths[0], lengths[-1] = 0, 191
    q = torch.randn(B, KH * G, HD, device=dev, generator=g).to(torch.bfloat16)
    cache = _int8_cache(dev, g, (L, KH, B, T, HD))
    append = (*_int8_cache(dev, g, (L, KH, B, C, HD)), 3) if with_append else None
    leaves, table = paged_mirror(torch, cache, lengths.tolist(), pt, torch.Generator().manual_seed(5))
    small, large = (da.decode_gqa_attention(q, *cache, 0, lengths, append, window=w) for w in (192, 576))
    assert torch.equal(small, large)
    paged_small, paged_large = (da.paged_decode_gqa_attention(q, *leaves, 0, lengths, table, append, window=w,
                                                              page_tokens=pt) for w in (192, 576))
    assert torch.equal(paged_small, paged_large) and torch.equal(paged_small, small)


@pytest.mark.parametrize("n_q,n_kv", [(8, 8), (8, 2), (16, 2)])
@pytest.mark.parametrize("s", [100, 257])
def test_flash_attention_group_sizes(dev, n_q, n_kv, s):
    """Group sizes 1, 4 and 8 stacked on the 64-row tiles, s not a multiple
    of a tile, padded rows, a zero-length row and a row whose keys stop
    short of its queries: within tolerance, exact zeros where nothing is
    visible, and the same bits on a reused (poisoned) output buffer."""
    g = torch.Generator(device=dev).manual_seed(13)
    b, hd = 4, 128
    q = torch.randn(b, s, n_q, hd, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, n_kv, hd, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, n_kv, hd, device=dev, generator=g).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    pos[1, s - 37:] = -1  # padded rows
    pos[3] = torch.arange(s, dtype=torch.int32, device=dev) + 5  # a warm suffix: positions past 0
    lengths = torch.tensor([s, s - 37, 0, s // 2], dtype=torch.int32, device=dev)
    out = _poisoned_call(lambda: fa.flash_gqa_attention(q, k, v, pos, lengths), q)
    ref = fa.flash_gqa_attention_plain(q, k, v, pos, lengths)
    torch.testing.assert_close(out, ref, atol=1e-2, rtol=2e-2)
    assert not out[1, s - 37:].any() and not out[2].any()


def test_logits_bf16_head_accumulates_in_f32(dev):
    """The bf16 head copy (exact int8 values) with f32 accumulation and f32
    output gives the f32 product of the same values."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.quant import QuantizedMatrix

    g = torch.Generator(device=dev).manual_seed(3)
    q8 = torch.randint(-127, 128, (512, 1000), dtype=torch.int8, device=dev, generator=g)
    scale = torch.rand(1, 1000, device=dev, generator=g) * 1e-3
    hidden = torch.randn(2, 3, 512, device=dev, generator=g).to(torch.bfloat16)
    out = llama.logits({"lm_head": QuantizedMatrix(q8.to(torch.bfloat16), scale)}, hidden)
    ref = (hidden.double() @ q8.double()).float() * scale[0]
    assert out.dtype == torch.float32 and out.shape == (2, 3, 1000)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-5)
