"""One-token decode attention over the int8 KV cache, contiguous or paged
(port of the decode half of ``ops/decode_attention.py``).

Semantics: for one layer ``li`` of the head-major cache, row ``b`` attends
cache slots ``[0, min(kv_lengths[b], window))`` and then the decode
chunk's append-buffer slots ``[0, count)``.  int8 k/v never dequantize
into a wide copy: the per-(token, head) scales fold into the scores and
the softmax weights, and a row with no visible slot gives exact zeros.

Cache layout (``models.llama.init_kv_cache``): values ``(L, KH, B, T, HD)``
int8, scales ``(L, KH, B, T)`` bf16; the append buffer is
``(L, KH, B, C, HD)`` / ``(L, KH, B, C)``.

The paged pool (``engine.paged_kv``) holds values ``(L, KH, P, HD)`` and
scales ``(L, KH, P)``, read through a ``(B, n_slot_pages)`` int32 page
table; the paged functions gather the same logical window and give the
contiguous functions' result on the same content.

On a CUDA tensor :func:`decode_gqa_attention` launches
``csrc/decode_attention.cu`` and :func:`paged_decode_gqa_attention`
``csrc/paged_decode_attention.cu``; on a CPU tensor they run the plain
versions, :func:`decode_gqa_attention_plain` and
:func:`paged_decode_gqa_attention_plain` (the reference's
``decode_gqa_attention_xla`` and ``paged_decode_gqa_attention_xla``).
Both kernels split each row's window over a cluster of blocks as
:func:`decode_plan` says, at one of three ``(head_dim, max group)``
instances (``_cuda.DECODE_INSTANCES``): (128, 8), (128, 16) and (256, 8).

The speculative verify pass (S = gamma + 1 fresh tokens a row) attends
through :func:`verify_gqa_attention` and
:func:`paged_verify_gqa_attention`: plain PyTorch on every device, on
the same window core, as the reference computes them in XLA.

A float cache (``kv_dtype`` other than int8: values ``(L, KH, B, T, HD)``
in the compute dtype, no scales) decodes and verifies through
:func:`float_cache_attention`, plain PyTorch on every device, as the
reference's bf16 cache runs XLA code there.  Its callers read the whole
cache, never a bucket of the batch's longest row, so a row's sums do not
follow its batch-mates.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from generativeaiexamples_tpu_torch.ops import _cuda
from generativeaiexamples_tpu_torch.ops.quant import f32_product

_NEG_INF = -1e30


def flush_clip_start(max_len: int, chunk: int) -> int:
    """First cache position the chunk-end append-buffer flush can
    garbage-write for a lane that cannot advance.

    ``engine.decode._flush_append_buffer`` clips each row's flush start to
    ``max_len - chunk``, so lanes pinned at ``max_len - 1`` take ``chunk``
    slots of garbage in ``[max_len - chunk, max_len)``.  Every producer of
    KV that must survive such a flush (parked histories, same-tick
    admission prefills, grafted prefixes) stays strictly below this
    position; the scheduler derives its parking margin and admission
    length bound from it.
    """
    return max_len - chunk


def _window_attention_plain(q, k_w, v_w, ks_w, vs_w, kv_lengths, append_w, buf_base):
    """The reference's window core (``_window_buffer_attention_core``):
    q (B, S, n_q, HD); window values (KH, B, W, HD) with (KH, B, W)
    scales; window slot ``t`` visible iff ``t < kv_lengths[b]``, append
    slot ``j`` visible to query ``i`` iff ``j <= buf_base + i``."""
    b, s, n_q, hd = q.shape
    n_kv = k_w.shape[0]
    g = n_q // n_kv
    scale = hd**-0.5
    window = k_w.shape[2]
    qg = q.reshape(b, s, n_kv, g, hd).float()

    def scores_part(kpart, kspart):
        sc = torch.einsum("bsngh,nbth->bngst", qg, kpart.float()) * scale
        return sc * kspart.permute(1, 0, 2).float()[:, :, None, None, :]

    t_idx = torch.arange(window, dtype=torch.int32, device=q.device)
    mask_w = (t_idx[None, :] < kv_lengths[:, None])[:, None, None, None, :]
    sc_w = scores_part(k_w, ks_w)
    sc_w = torch.where(mask_w, sc_w, torch.full_like(sc_w, _NEG_INF))
    parts = [(sc_w, mask_w.expand(sc_w.shape))]
    vals = [(v_w, vs_w)]
    if append_w is not None:
        k_ab, v_ab, ks_ab, vs_ab = append_w
        c = k_ab.shape[2]
        j_idx = torch.arange(c, dtype=torch.int32, device=q.device)
        s_idx = torch.arange(s, dtype=torch.int32, device=q.device)
        visible = (j_idx[None, :] <= buf_base + s_idx[:, None])[None, None, None, :, :]
        sc_b = scores_part(k_ab, ks_ab)
        sc_b = torch.where(visible, sc_b, torch.full_like(sc_b, _NEG_INF))
        parts.append((sc_b, visible.expand(sc_b.shape)))
        vals.append((v_ab, vs_ab))

    scores = torch.cat([p[0] for p in parts], dim=-1)
    masks = torch.cat([p[1] for p in parts], dim=-1)
    m = scores.amax(dim=-1, keepdim=True)
    weights = torch.exp(scores - m) * masks
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.zeros((b, n_kv, g, s, hd), dtype=torch.float32, device=q.device)
    off = 0
    for vpart, vspart in vals:
        t = vpart.shape[2]
        w = weights[..., off : off + t] * vspart.permute(1, 0, 2).float()[:, :, None, None, :]
        out = out + torch.einsum("bngst,nbth->bngsh", w.to(q.dtype).float(), vpart.float())
        off += t
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, n_q, hd).to(q.dtype)


def float_cache_attention(q, k_w, v_w, q_positions, kv_lengths, append=None) -> torch.Tensor:
    """Attention of ``q`` (b, s, n_q, HD) over one layer's head-major
    float cache window ``k_w`` / ``v_w`` (KH, b, W, HD), plus an optional
    causal block ``append = (k_ab, v_ab)`` (KH, b, s, HD).

    Window slot ``t`` is visible to query ``i`` of row ``r`` iff ``t <=
    q_positions[r, i]`` and ``t < kv_lengths[r]``; buffer slot ``j`` iff
    ``j <= i``.  The arithmetic is the reference's ``gqa_attention``
    without scales: scores and the PV product accumulate in f32 over
    operands in the cache's dtype (on the card a bf16 product with an f32
    output, so the cache is read once and never widened), the softmax
    weights round to q's dtype before the PV product, and a row with
    nothing visible gives exact zeros.  Returns (b, s, n_q, HD) in q's
    dtype.  Batched products run over (KH * b) row pairs, so a
    ``cache[layer]`` window is read in place."""
    b, s, n_q, hd = q.shape
    n_kv = k_w.shape[0]
    g = n_q // n_kv
    scale = hd**-0.5
    # Query rows of one kv head, (g, s)-major: (KH * b, g * s, HD).
    qh = q.reshape(b, s, n_kv, g, hd).permute(2, 0, 3, 1, 4).reshape(n_kv * b, g * s, hd).to(k_w.dtype)

    def scores_of(k):
        kk = k.reshape(n_kv * b, k.shape[2], hd)
        return (f32_product(qh, kk.transpose(1, 2)) * scale).reshape(n_kv, b, g, s, k.shape[2])

    window = k_w.shape[2]
    t_idx = torch.arange(window, dtype=torch.int32, device=q.device)
    vis = (t_idx[None, None, :] <= q_positions[:, :, None]) & (t_idx[None, None, :] < kv_lengths[:, None, None])
    vis = vis[None, :, None]  # (1, b, 1, s, W)
    sc = scores_of(k_w)
    parts = [torch.where(vis, sc, torch.full_like(sc, _NEG_INF))]
    masks = [vis.expand(sc.shape)]
    vals = [v_w]
    if append is not None:
        k_ab, v_ab = append
        c = k_ab.shape[2]
        j_idx = torch.arange(c, dtype=torch.int32, device=q.device)
        i_idx = torch.arange(s, dtype=torch.int32, device=q.device)
        bvis = (j_idx[None, :] <= i_idx[:, None])[None, None, None]  # (1, 1, 1, s, c)
        sb = scores_of(k_ab)
        parts.append(torch.where(bvis, sb, torch.full_like(sb, _NEG_INF)))
        masks.append(bvis.expand(sb.shape))
        vals.append(v_ab)
    scores = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    mask = torch.cat(masks, dim=-1) if len(masks) > 1 else masks[0]
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * mask
    weights = (weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype).to(v_w.dtype)
    out = None
    off = 0
    for v in vals:
        t = v.shape[2]
        w = weights[..., off : off + t].reshape(n_kv * b, g * s, t)
        part = f32_product(w, v.reshape(n_kv * b, t, hd))
        out = part if out is None else out + part
        off += t
    return out.reshape(n_kv, b, g, s, hd).permute(1, 3, 0, 2, 4).reshape(b, s, n_q, hd).to(q.dtype)


def decode_gqa_attention_plain(
    q, k8, v8, ks, vs, layer: int, kv_lengths, append=None, *, window: int
) -> torch.Tensor:
    """Plain version of the kernel: slice layer ``layer``'s first
    ``window`` slots (and its append buffer) and run the window core."""
    append_w, buf_base = None, 0
    if append is not None:
        k_ab, v_ab, ks_ab, vs_ab, count = append
        append_w = (k_ab[layer], v_ab[layer], ks_ab[layer], vs_ab[layer])
        buf_base = int(count) - 1
    return _window_attention_plain(
        q[:, None],
        k8[layer, :, :, :window],
        v8[layer, :, :, :window],
        ks[layer, :, :, :window],
        vs[layer, :, :, :window],
        kv_lengths,
        append_w,
        buf_base,
    )[:, 0]


def paged_slots(page_table: torch.Tensor, positions: torch.Tensor, page_tokens: int) -> torch.Tensor:
    """Flat pool slots (B, N) of logical positions (B, N) through the
    (B, n_slot_pages) page table: logical token ``t`` of row ``b`` lives at
    ``page_table[b, t // page_tokens] * page_tokens + t % page_tokens``."""
    positions = positions.long()
    bidx = torch.arange(page_table.shape[0], device=page_table.device)[:, None]
    return page_table.long()[bidx, positions // page_tokens] * page_tokens + positions % page_tokens


def paged_window_index(page_table: torch.Tensor, window: int, page_tokens: int) -> torch.Tensor:
    """Flat pool slots of logical window slots ``[0, window)``: (B, W).
    Unowned table entries are 0 (the garbage page), so slots past a row's
    pages gather page-0 garbage, which the window core masks exactly."""
    w = torch.arange(window, device=page_table.device)
    return paged_slots(page_table, w.expand(page_table.shape[0], window), page_tokens)


def paged_decode_gqa_attention_plain(
    q, k8, v8, ks, vs, layer: int, kv_lengths, page_table, append=None, *, window: int, page_tokens: int
) -> torch.Tensor:
    """Plain version of the paged kernel (the reference's
    ``paged_decode_gqa_attention_xla``): gather layer ``layer``'s logical
    window through the page table and run the same window core as
    :func:`decode_gqa_attention_plain`, so the two agree bit for bit when
    the page-mapped content of each row's valid slots matches the
    contiguous cache."""
    append_w, buf_base = None, 0
    if append is not None:
        k_ab, v_ab, ks_ab, vs_ab, count = append
        append_w = (k_ab[layer], v_ab[layer], ks_ab[layer], vs_ab[layer])
        buf_base = int(count) - 1
    flat = paged_window_index(page_table, window, page_tokens)
    return _window_attention_plain(
        q[:, None],
        k8[layer][:, flat],
        v8[layer][:, flat],
        ks[layer][:, flat],
        vs[layer][:, flat],
        kv_lengths,
        append_w,
        buf_base,
    )[:, 0]


def verify_gqa_attention(q, k8, v8, ks, vs, layer: int, kv_lengths, append, *, window: int) -> torch.Tensor:
    """Speculative verify attention over [cache prefix ; fresh block] (the
    reference's ``verify_gqa_attention_xla``, plain PyTorch on every
    device, as the reference leaves it to XLA).

    q (B, S, n_q, HD): row r's S fresh tokens sit at positions
    ``kv_lengths[r] + i``.  Every query sees the cache slots ``t <
    min(kv_lengths[r], window)`` of layer ``layer``; ``append`` is the
    round's ``(k_ab, v_ab, ks_ab, vs_ab)`` buffer of S slots ((L, KH, B, S,
    HD) / (L, KH, B, S)), whose slot j query i sees iff ``j <= i``.
    Returns (B, S, n_q, HD) in q's dtype."""
    k_ab, v_ab, ks_ab, vs_ab = append
    return _window_attention_plain(
        q,
        k8[layer, :, :, :window],
        v8[layer, :, :, :window],
        ks[layer, :, :, :window],
        vs[layer, :, :, :window],
        kv_lengths,
        (k_ab[layer], v_ab[layer], ks_ab[layer], vs_ab[layer]),
        0,
    )


def paged_verify_gqa_attention(
    q, k8, v8, ks, vs, layer: int, kv_lengths, page_table, append, *, window: int, page_tokens: int
) -> torch.Tensor:
    """Paged twin of :func:`verify_gqa_attention` (the reference's
    ``paged_verify_gqa_attention_xla``): the logical window gathered
    through the page table, then the same window core, so it equals the
    contiguous function on the same content."""
    k_ab, v_ab, ks_ab, vs_ab = append
    flat = paged_window_index(page_table, window, page_tokens)
    return _window_attention_plain(
        q,
        k8[layer][:, flat],
        v8[layer][:, flat],
        ks[layer][:, flat],
        vs[layer][:, flat],
        kv_lengths,
        (k_ab[layer], v_ab[layer], ks_ab[layer], vs_ab[layer]),
        0,
    )


# Geometry shared with csrc/decode_tile.cuh.
TILE = 64  # logical slots a tile
MAX_SPLITS = 8  # portable thread-block cluster size
# Blocks wanted per SM, from a sweep of 1-8 splits at B=32, KH=8 on an
# H100 (PERF.md): 2 splits (~3.9 blocks per SM) were the fastest.
BLOCKS_PER_SM = 3


@functools.lru_cache(maxsize=None)
def decode_plan(b: int, n_kv: int) -> int:
    """The split count of the decode kernels for ``b`` rows and ``n_kv``
    kv heads: the fewest splits, a power of two up to ``MAX_SPLITS``, that
    give ``BLOCKS_PER_SM`` blocks per SM.

    The grid is (B, KH, splits); each (row, kv head)'s ``splits`` blocks
    are one cluster.  A row's cache slots ``[0, min(len, window))`` are cut
    into ``TILE``-slot logical tiles dealt round-robin: split ``z`` takes
    tiles ``z, z + splits, ...``, and the append buffer is the next logical
    tile after the cache's last.

    It depends on ``(b, n_kv)`` only, never on the window or the lengths:
    the split count fixes the order in which a row's partial sums are
    combined, so a row's result must not move with the window the batch's
    longest row sets (a prompt gives the same greedy text alone as in a
    batch; the scheduler decodes at its fixed ``max_batch``), and the
    contiguous and paged kernels split at the same logical slots."""
    if b <= 0 or n_kv <= 0:
        raise ValueError(f"decode_plan: bad shape b={b} n_kv={n_kv}")
    want = -(-BLOCKS_PER_SM * _cuda.SMS // (b * n_kv))
    splits = 1
    while splits < want and splits < MAX_SPLITS:
        splits *= 2
    return splits


def _append_args(append, n_layers: int, n_kv: int, b: int, hd: int, name: str):
    """Check a launch's append buffer; returns ((k_ab, v_ab, ks_ab, vs_ab)
    or Nones, width C, valid count)."""
    if append is None:
        return (None, None, None, None), 0, 0
    k_ab, v_ab, ks_ab, vs_ab, count = append
    c, count = k_ab.shape[3], int(count)
    _cuda.require(
        tuple(k_ab.shape) == (n_layers, n_kv, b, c, hd) and tuple(v_ab.shape) == tuple(k_ab.shape)
        and tuple(ks_ab.shape) == (n_layers, n_kv, b, c) and tuple(vs_ab.shape) == tuple(ks_ab.shape),
        f"{name}: append buffer shapes",
    )
    _cuda.require(0 <= count <= c <= 64, f"{name}: append count {count} / width {c}")
    _cuda.require(k_ab.dtype == torch.int8 and v_ab.dtype == torch.int8, f"{name}: append values must be int8")
    _cuda.require(ks_ab.dtype == torch.bfloat16 and vs_ab.dtype == torch.bfloat16, f"{name}: append scales must be bf16")
    return (k_ab, v_ab, ks_ab, vs_ab), c, count


def decode_instance(hd: int, g: int) -> tuple:
    """The kernels' ``(head_dim, max group)`` instance that serves head_dim
    ``hd`` at ``g`` query heads a kv head (the smallest that holds it), or
    None when none does."""
    return next(((h, mg) for h, mg in _cuda.DECODE_INSTANCES if h == hd and 1 <= g <= mg), None)


def _check_common(name: str, tensors, q, k8, v8, ks, vs, n_q: int, n_kv: int, hd: int, chd: int) -> None:
    g = n_q // n_kv
    for tname, x in tensors:
        _cuda.require(x.is_cuda and x.is_contiguous(), f"{name}: {tname} must be a contiguous CUDA tensor")
        # The kernels copy 16-byte vectors.
        _cuda.require(x.data_ptr() % 16 == 0, f"{name}: {tname} must be 16-byte aligned")
    _cuda.require(q.dtype == torch.bfloat16, f"{name}: q must be bf16, got {q.dtype}")
    _cuda.require(k8.dtype == torch.int8 and v8.dtype == torch.int8, f"{name}: cache values must be int8")
    _cuda.require(ks.dtype == torch.bfloat16 and vs.dtype == torch.bfloat16, f"{name}: scales must be bf16")
    _cuda.require(
        hd == chd and n_q % n_kv == 0 and decode_instance(hd, g) is not None,
        f"{name}: no kernel instance for head_dim {hd} (cache {chd}) at group size {n_q}/{n_kv}; "
        f"the instances are (head_dim, max group) {_cuda.DECODE_INSTANCES}",
    )


_DECODE_ARGS = [_cuda.c_ptr] * 11 + [_cuda.c_int] * 10 + [_cuda.c_float, _cuda.c_ptr]


def decode_attention_cuda(q, k8, v8, ks, vs, layer: int, kv_lengths, append, window: int):
    """Launch ``csrc/decode_attention.cu`` on CUDA tensors."""
    b, n_q, hd = q.shape
    n_layers, n_kv, cb, t, chd = k8.shape
    (k_ab, v_ab, ks_ab, vs_ab), c, count = _append_args(append, n_layers, n_kv, b, hd, "decode_attention")
    tensors = [("q", q), ("k8", k8), ("v8", v8), ("ks", ks), ("vs", vs)]
    if append is not None:
        tensors += [("k_ab", k_ab), ("v_ab", v_ab), ("ks_ab", ks_ab), ("vs_ab", vs_ab)]
    _check_common("decode_attention", tensors, q, k8, v8, ks, vs, n_q, n_kv, hd, chd)
    _cuda.require(cb == b, "decode_attention: cache batch must match q")
    _cuda.require(tuple(v8.shape) == tuple(k8.shape) and tuple(ks.shape) == (n_layers, n_kv, b, t)
                  and tuple(vs.shape) == tuple(ks.shape), "decode_attention: cache shapes")
    _cuda.require(0 <= layer < n_layers and 0 < window <= t, f"decode_attention: layer {layer} / window {window}")
    kv_lengths = kv_lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _cuda.function("decode_attention", "decode_attention_launch", _DECODE_ARGS)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = fn(
        q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        kv_lengths.data_ptr(), ptr(k_ab), ptr(v_ab), ptr(ks_ab), ptr(vs_ab), out.data_ptr(),
        int(layer), b, n_kv, n_q // n_kv, hd, t, c, count, int(window), decode_plan(b, n_kv), hd**-0.5,
        _cuda.stream_ptr(q),
    )
    _cuda.check("decode_attention", err)
    _cuda.LAUNCHES["decode_attention"] += 1
    _cuda.DECODE_INSTANCE_LAUNCHES["decode_attention"]["%dx%d" % decode_instance(hd, n_q // n_kv)] += 1
    return out


_PAGED_ARGS = [_cuda.c_ptr] * 12 + [_cuda.c_int] * 12 + [_cuda.c_float, _cuda.c_ptr]


def paged_decode_attention_cuda(
    q, k8, v8, ks, vs, layer: int, kv_lengths, page_table, append, window: int, page_tokens: int
):
    """Launch ``csrc/paged_decode_attention.cu`` on CUDA tensors."""
    b, n_q, hd = q.shape
    n_layers, n_kv, p, chd = k8.shape
    (k_ab, v_ab, ks_ab, vs_ab), c, count = _append_args(append, n_layers, n_kv, b, hd, "paged_decode_attention")
    tensors = [("q", q), ("k8", k8), ("v8", v8), ("ks", ks), ("vs", vs), ("page_table", page_table)]
    if append is not None:
        tensors += [("k_ab", k_ab), ("v_ab", v_ab), ("ks_ab", ks_ab), ("vs_ab", vs_ab)]
    _check_common("paged_decode_attention", tensors, q, k8, v8, ks, vs, n_q, n_kv, hd, chd)
    _cuda.require(tuple(v8.shape) == tuple(k8.shape) and tuple(ks.shape) == (n_layers, n_kv, p)
                  and tuple(vs.shape) == tuple(ks.shape), "paged_decode_attention: pool shapes")
    pt = int(page_tokens)
    _cuda.require(pt >= 1 and pt & (pt - 1) == 0, f"paged_decode_attention: page of {pt} slots is not a power of two")
    _cuda.require(p % pt == 0, f"paged_decode_attention: pool of {p} slots is not whole pages of {pt}")
    _cuda.require(page_table.dtype == torch.int32 and page_table.ndim == 2 and page_table.shape[0] == b,
                  "paged_decode_attention: page_table must be (B, n_slot_pages) int32")
    n_pages = page_table.shape[1]
    _cuda.require(0 <= layer < n_layers and 0 < window <= n_pages * page_tokens,
                  f"paged_decode_attention: layer {layer} / window {window} / table {n_pages}x{page_tokens}")
    kv_lengths = kv_lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _cuda.function("paged_decode_attention", "paged_decode_attention_launch", _PAGED_ARGS)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = fn(
        q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        kv_lengths.data_ptr(), page_table.data_ptr(), ptr(k_ab), ptr(v_ab), ptr(ks_ab), ptr(vs_ab),
        out.data_ptr(), int(layer), b, n_kv, n_q // n_kv, hd, p, n_pages, pt, c, count,
        int(window), decode_plan(b, n_kv), hd**-0.5, _cuda.stream_ptr(q),
    )
    _cuda.check("paged_decode_attention", err)
    _cuda.LAUNCHES["paged_decode_attention"] += 1
    _cuda.DECODE_INSTANCE_LAUNCHES["paged_decode_attention"]["%dx%d" % decode_instance(hd, n_q // n_kv)] += 1
    return out


def decode_gqa_attention(
    q: torch.Tensor,
    k8: torch.Tensor,
    v8: torch.Tensor,
    ks: torch.Tensor,
    vs: torch.Tensor,
    layer: int,
    kv_lengths: torch.Tensor,
    append: Optional[tuple] = None,
    *,
    window: int,
) -> torch.Tensor:
    """Decode attention for one layer of the stacked cache.

    q (B, n_q, HD) with rope applied; k8/v8 (L, KH, B, T, HD) int8;
    ks/vs (L, KH, B, T) bf16; ``layer`` an int; kv_lengths (B,) int32;
    ``append`` optional ``(k_ab, v_ab, ks_ab, vs_ab, count)``; ``window``
    caps the cache slots read.  Returns (B, n_q, HD) in q's dtype.
    """
    if _cuda.on_cuda(q):
        return decode_attention_cuda(q, k8, v8, ks, vs, layer, kv_lengths, append, window)
    return decode_gqa_attention_plain(q, k8, v8, ks, vs, layer, kv_lengths, append, window=window)


def paged_decode_gqa_attention(
    q: torch.Tensor,
    k8: torch.Tensor,
    v8: torch.Tensor,
    ks: torch.Tensor,
    vs: torch.Tensor,
    layer: int,
    kv_lengths: torch.Tensor,
    page_table: torch.Tensor,
    append: Optional[tuple] = None,
    *,
    window: int,
    page_tokens: int,
) -> torch.Tensor:
    """Decode attention for one layer of the paged pool.

    q (B, n_q, HD) with rope applied; k8/v8 (L, KH, P, HD) int8 pool
    values (P = total_pages * page_tokens); ks/vs (L, KH, P) bf16;
    page_table (B, n_slot_pages) int32; kv_lengths (B,) int32; ``append``
    and ``window`` as in :func:`decode_gqa_attention`.  Returns
    (B, n_q, HD) in q's dtype.
    """
    if _cuda.on_cuda(q):
        return paged_decode_attention_cuda(q, k8, v8, ks, vs, layer, kv_lengths, page_table, append, window, page_tokens)
    return paged_decode_gqa_attention_plain(
        q, k8, v8, ks, vs, layer, kv_lengths, page_table, append, window=window, page_tokens=page_tokens
    )
