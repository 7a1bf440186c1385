"""Decode-path builders for the scheduler and the offline generators
(port of ``engine/decode.py``): params, cache and paged-pool preparation,
the append-buffer flushes, and the chunked decode loops (contiguous and
paged)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from generativeaiexamples_tpu_torch.core.logging import get_logger
from generativeaiexamples_tpu_torch.engine.sampler import sample
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops.decode_attention import flush_clip_start, paged_slots
from generativeaiexamples_tpu_torch.ops.quant import (
    QUANT_TARGETS,
    QuantizedMatrix,
    quantize_embedding,
    quantize_llama_params,
    quantize_matrix,
)

logger = get_logger(__name__)


MATMUL_KERNELS = ("xla", "pallas_w8a8")


def prepare_params(
    cfg: llama.LlamaConfig,
    params,
    *,
    device,
    quantize: bool = False,
    pack: bool = False,
    matmul_kernel: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
):
    """Lay params out for serving, with the reference's semantics, for
    every family of ``models.llama.PRESETS``.

    ``params=None`` builds random weights from ``generator`` on
    ``device``: int8 projections with ``quantize``, float in the compute
    dtype otherwise.  ``quantize`` turns float projections, head and
    embedding into weight-only int8 (int8 leaves pass through; the MoE
    router and experts stay float, as in the reference).  ``pack`` fuses
    qkv and gate/up where the tree has no biases.  ``matmul_kernel``
    picks the projection path: ``"xla"`` / None serves the leaves as they
    are (float, or weight-only int8 through ``ops.quant.q_dot``);
    ``"pallas_w8a8"`` blocks every int8 projection once for the W8A8
    kernel (``engine.weights.preblock_llama_params``), while float and
    already blocked leaves pass through, so a call is idempotent.  An
    int8 head is held in the compute dtype for the logits product
    (``engine.weights.head_for_logits``).

    The port's W8A8 serving route is ``quantize=True, pack=True,
    matmul_kernel="pallas_w8a8"`` (:func:`w8a8_params`).

    With ``mesh`` (a rank's ``parallel.runtime.RankContext``) the result
    is this rank's shard (``engine.weights.shard_params``), as the
    reference shards over its mesh: the whole tree is built or quantized
    first (scales over whole columns), then sliced; ``pack`` applies only
    when the ``tensor`` axis is 1 (a packed leaf would cross the head
    shards) and nothing is blocked (``pallas_w8a8`` is single-device).
    """
    from generativeaiexamples_tpu_torch.engine.weights import head_for_logits, preblock_llama_params

    if matmul_kernel not in (None,) + MATMUL_KERNELS:
        raise ValueError(f"unknown matmul_kernel {matmul_kernel!r} (expected 'xla' or 'pallas_w8a8')")
    if params is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if quantize:
            logger.info("initializing random int8 llama params (%s)", cfg)
            params = init_random_int8_params(cfg, generator, device)
        else:
            logger.info("initializing random float llama params (%s)", cfg)
            params = init_random_params(cfg, generator, device)
    elif quantize:
        params = quantize_llama_params(params, include_embed=True)
    if mesh is not None:
        from generativeaiexamples_tpu_torch.engine.weights import shard_params

        params = shard_params(params, cfg, mesh.sizes, mesh.coords, device)
        return llama.pack_for_serving(params) if pack and mesh.size("tensor") == 1 else params
    # One step at a time, so each step's input is freed before the next
    # copies it (the unpacked and packed projections never both stay alive
    # through the blocking).
    if pack:
        params = llama.pack_for_serving(params)
    if matmul_kernel == "pallas_w8a8":
        params = preblock_llama_params(params)
    return head_for_logits(params, cfg)


def w8a8_params(cfg: llama.LlamaConfig, params, *, device, generator: Optional[torch.Generator] = None):
    """The port's ``pallas_w8a8`` serving layout: quantized (random int8
    from ``generator`` when ``params`` is None), packed and blocked for
    the W8A8 kernel."""
    return prepare_params(cfg, params, device=device, quantize=True, pack=True, matmul_kernel="pallas_w8a8",
                          generator=generator)


def init_random_params(cfg: llama.LlamaConfig, generator: torch.Generator, device):
    """Random float serving params in the compute dtype (0.02-std normal;
    norm gains 1, biases 0), drawn on ``device`` one layer of one leaf at
    a time, so no full-depth f32 copy of the model ever exists (Llama-3-8B:
    16.06 GB of bf16)."""
    shapes = llama.param_shapes(cfg)
    dt = cfg.compute_dtype

    def draw(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device) * 0.02).to(dt)

    def leaf(name, shape, stacked):
        if name in llama.NORM_GAINS:
            return torch.ones(shape, dtype=dt, device=device)
        if name in llama.BIASES:
            return torch.zeros(shape, dtype=dt, device=device)
        if not stacked:
            return draw(shape)
        out = torch.empty(shape, dtype=dt, device=device)
        for i in range(shape[0]):
            out[i] = draw(shape[1:])
        return out

    out = {name: leaf(name, shape, False) for name, shape in shapes.items() if name != "layers"}
    out["layers"] = {name: leaf(name, shape, True) for name, shape in shapes["layers"].items()}
    return out


def init_random_int8_params(cfg: llama.LlamaConfig, generator: torch.Generator, device):
    """Random serving params with projections born int8: one random layer,
    quantized, then copied to full depth, so no full-depth float copy of
    the model ever exists (Llama-3-8B: about 8 GB of int8 weights).  Float
    leaves (norms, biases, the MoE router and experts) are copied to depth
    as they are (Mixtral's bf16 experts: 2.82 GB a layer)."""
    params = llama.init_params(dataclasses.replace(cfg, n_layers=1), generator, device)
    layers = {}
    for name, leaf in params["layers"].items():
        if name in QUANT_TARGETS:
            qm = quantize_matrix(leaf)
            layers[name] = QuantizedMatrix(
                q=qm.q.expand(cfg.n_layers, *qm.q.shape[1:]).contiguous(),
                scale=qm.scale.expand(cfg.n_layers, *qm.scale.shape[1:]).contiguous(),
            )
        else:
            layers[name] = leaf.expand(cfg.n_layers, *leaf.shape[1:]).contiguous()
        params["layers"][name] = None
    out = {**params, "layers": layers}
    out["lm_head"] = quantize_matrix(params["lm_head"])
    out["embed"] = quantize_embedding(params["embed"])
    return out


def prepare_cache(cfg: llama.LlamaConfig, batch: int, max_len: int, device, mesh=None):
    """Allocate the slot KV cache: the int8 4-tuple or the float 2-tuple
    (``models.llama.init_kv_cache``).  With ``mesh`` (a rank's context):
    this rank's shard, its KV heads of the ``tensor`` axis and its slots of
    the ``data`` axis (``models.llama.kv_cache_specs``)."""
    if mesh is not None:
        if batch % mesh.size("data"):
            raise ValueError(f"{batch} slots do not split over data={mesh.size('data')}")
        cfg, batch = llama.local_config(cfg, mesh), batch // mesh.size("data")
    return llama.init_kv_cache(cfg, batch, max_len, device=device)


def prepare_paged_pool(
    cfg: llama.LlamaConfig,
    max_batch: int,
    max_len: int,
    page_tokens: int,
    total_pages: Optional[int] = None,
    *,
    device,
    mesh=None,
):
    """Allocate the paged KV pool (``engine.paged_kv.PagedKVPool``), the
    paged counterpart of :func:`prepare_cache`; ``total_pages`` floors at
    ``max_batch * n_slot_pages + 1`` so admission never deadlocks on
    pages."""
    from generativeaiexamples_tpu_torch.engine.paged_kv import PagedKVPool

    return PagedKVPool(cfg, max_batch, max_len, page_tokens, total_pages=total_pages, device=device, mesh=mesh)


def _flush_append_buffer(cache, ab, starts: torch.Tensor, max_len: int):
    """Write the chunk's append buffer into the big cache, in place.

    Row r's C slots land at positions ``[start_r, start_r + C)`` of every
    layer and head, with ``start_r = clip(starts[r], 0, max_len - C)``
    (``ops.decode_attention.flush_clip_start``): rows pinned at
    ``max_len - 1`` write the tail garbage zone."""
    b = ab[0].shape[2]
    c = ab[0].shape[3]
    start = starts.clamp(0, flush_clip_start(max_len, c)).long()
    pos = start[:, None] + torch.arange(c, device=start.device)[None, :]  # (b, c)
    bidx = torch.arange(b, device=start.device)[:, None]
    for big, small in zip(cache, ab):
        big[:, :, bidx, pos] = small
    return cache


def _flush_append_buffer_paged(leaves, ab, starts: torch.Tensor, table: torch.Tensor, max_len: int, page_tokens: int):
    """Paged twin of :func:`_flush_append_buffer`: write the chunk's append
    buffer through the page table into the flat pool, in place.

    Row r's C slots land at logical positions ``[start_r, start_r + C)``
    with the same ``flush_clip_start`` clip, so lanes pinned at
    ``max_len - 1`` write the logical tail zone, whose unowned table
    entries map to the garbage page 0 (duplicate writes there are
    harmless).  Live rows' pages were made private by the scheduler's
    ``make_writable`` before dispatch."""
    c = ab[0].shape[3]
    start = starts.clamp(0, flush_clip_start(max_len, c)).long()
    pos = start[:, None] + torch.arange(c, device=start.device)[None, :]  # (b, c)
    phys = paged_slots(table, pos, page_tokens)
    # (L, KH, b, c, ...) updates land on big[:, :, phys]: the update shape
    # is the append buffer's own.
    for big, small in zip(leaves, ab):
        big[:, :, phys] = small
    return leaves


def _append_buffer(cfg: llama.LlamaConfig, b: int, n_steps: int, dev):
    """An append buffer of ``n_steps`` slots shaped like the cache: int8
    values and bf16 scales, or float ``(k, v)`` (the verify pass only)."""
    ab_shape = (cfg.n_layers, cfg.n_kv_heads, b, n_steps, cfg.head_dim)
    if cfg.kv_dtype != "int8":
        return (
            torch.zeros(ab_shape, dtype=cfg.compute_dtype, device=dev),
            torch.zeros(ab_shape, dtype=cfg.compute_dtype, device=dev),
        )
    return (
        torch.zeros(ab_shape, dtype=torch.int8, device=dev),
        torch.zeros(ab_shape, dtype=torch.int8, device=dev),
        torch.zeros(ab_shape[:-1], dtype=torch.bfloat16, device=dev),
        torch.zeros(ab_shape[:-1], dtype=torch.bfloat16, device=dev),
    )


def data_rows(mesh, b: int) -> slice:
    """The rows of a ``b``-row batch that this rank of ``mesh`` holds: its
    block of the ``data`` axis (all rows without a mesh)."""
    n = mesh.size("data") if mesh is not None else 1
    if n == 1:
        return slice(None)
    if b % n:
        raise ValueError(f"{b} rows do not split over data={n}")
    i = mesh.index("data")
    return slice(i * (b // n), (i + 1) * (b // n))


def mesh_logits(params, hidden: torch.Tensor, mesh) -> torch.Tensor:
    """f32 logits of this rank's rows, gathered over the vocabulary shards
    and over the ``data`` axis: every rank of ``mesh`` holds the whole
    batch's logits, so one sampler draw from equal generators gives every
    rank the same tokens."""
    lg = llama.logits(params, hidden, mesh)
    if mesh is not None and mesh.size("data") > 1:
        lg = mesh.all_gather(lg.contiguous(), "data", dim=0)
    return lg


def make_decode_chunk_fn(cfg: llama.LlamaConfig, max_len: int, mesh=None):
    """Multi-step decode.

    ``fn(params, cache, tokens, lengths, generator, temp, top_p, top_k,
    n_steps, kv_bucket=None) -> (cache, toks)`` with toks (n_steps, b) on
    the device.  Nothing here waits for the device.  Two paths, by the
    cache:

    * the int8 cache, the append-buffer protocol: each step's fresh KV
      goes to a small (L, KH, B, n_steps, HD) append buffer; attention
      reads the big-cache window plus the buffer through the decode
      kernel; one scatter per leaf flushes the buffer at the end of the
      chunk.  The big cache is read-only inside the steps.
    * the float cache (the reference's per-step path): each step scatters
      its KV into the cache and attends over it (``models.llama.forward``'s
      warm decode).

    With ``mesh`` (a ``parallel.runtime.RankContext``) the chunk is one
    rank's program: ``params`` and ``cache`` are its shards and it runs
    the forward on its rows of the ``data`` axis (:func:`data_rows`) while
    ``tokens``, ``lengths`` and the sampling rows cover the whole batch;
    every step's logits are gathered (:func:`mesh_logits`) and every rank
    samples the whole batch from its equal generator.
    """
    lc = llama.local_config(cfg, mesh)

    def float_chunk(params, cache, tokens, lengths, generator, temp, top_p, top_k, n_steps, kv_bucket):
        rows = data_rows(mesh, tokens.shape[0])
        tok = tokens
        toks = []
        for step in range(n_steps):
            live = lengths[rows] + step
            hidden, _ = llama.forward(
                params, cfg, tok[rows, None].long(), live.clamp(max=max_len - 1)[:, None], cache,
                (live + 1).clamp(max=max_len), kv_bucket=kv_bucket, mesh=mesh,
            )
            lg = mesh_logits(params, hidden, mesh)[:, 0]
            tok = sample(lg, generator, temp, top_p, top_k)
            toks.append(tok)
        return cache, torch.stack(toks)

    def decode_chunk(params, cache, tokens, lengths, generator, temp, top_p, top_k, n_steps, kv_bucket=None):
        if len(cache) == 2:
            return float_chunk(params, cache, tokens, lengths, generator, temp, top_p, top_k, n_steps, kv_bucket)
        b = cache[0].shape[2]
        rows = data_rows(mesh, tokens.shape[0])
        # Valid big-cache slots per row: the current token's write position
        # (its KV lives in the append buffer this chunk).
        lengths0 = lengths[rows].clamp(max=max_len - 1)
        ab = _append_buffer(lc, b, n_steps, tokens.device)
        tok = tokens
        toks = []
        for step in range(n_steps):
            positions = (lengths0 + step).clamp(max=max_len - 1)[:, None]
            hidden, _, ab = llama.forward(
                params, cfg, tok[rows, None].long(), positions, cache, lengths0,
                kv_bucket=kv_bucket, append_cache=(ab, step), mesh=mesh,
            )
            lg = mesh_logits(params, hidden, mesh)[:, 0]
            tok = sample(lg, generator, temp, top_p, top_k)
            toks.append(tok)
        _flush_append_buffer(cache, ab, lengths0, max_len)
        return cache, torch.stack(toks)

    return decode_chunk


def make_paged_decode_chunk_fn(cfg: llama.LlamaConfig, max_len: int, page_tokens: int, mesh=None):
    """Paged twin of :func:`make_decode_chunk_fn`.

    ``fn(params, leaves, table, tokens, lengths, generator, temp, top_p,
    top_k, n_steps, kv_bucket=None) -> (leaves, toks)``: the pool leaves
    are updated in place, the device page table rides alongside (the host
    owns it), and ``max_len`` is the logical per-slot capacity the table
    maps.  The steps mirror the contiguous chunk's (append-buffer
    protocol, paged decode kernel), so greedy decode gives the same
    tokens in both layouts.  With ``mesh`` it is one rank's program over
    its pool shard (its KV heads' pages; one ``data`` row block only).
    """
    lc = llama.local_config(cfg, mesh)

    def paged_decode_chunk(
        params, leaves, table, tokens, lengths, generator, temp, top_p, top_k, n_steps, kv_bucket=None
    ):
        b = tokens.shape[0]
        lengths0 = lengths.clamp(max=max_len - 1)
        ab = _append_buffer(lc, b, n_steps, tokens.device)
        tok = tokens
        toks = []
        for step in range(n_steps):
            positions = (lengths0 + step).clamp(max=max_len - 1)[:, None]
            hidden, _, ab = llama.forward(
                params, cfg, tok[:, None].long(), positions, leaves, lengths0,
                kv_bucket=kv_bucket, append_cache=(ab, step),
                page_table=table, page_tokens=page_tokens, pages_len=max_len, mesh=mesh,
            )
            lg = llama.logits(params, hidden, mesh)[:, 0]
            tok = sample(lg, generator, temp, top_p, top_k)
            toks.append(tok)
        _flush_append_buffer_paged(leaves, ab, lengths0, table, max_len, page_tokens)
        return leaves, torch.stack(toks)

    return paged_decode_chunk
