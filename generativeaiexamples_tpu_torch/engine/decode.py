"""Decode-path builders for the scheduler (port of ``engine/decode.py``):
params, cache and paged-pool preparation, the append-buffer flushes, and
the chunked decode loops (contiguous and paged)."""

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


def prepare_params(
    cfg: llama.LlamaConfig,
    params,
    *,
    device,
    generator: Optional[torch.Generator] = None,
):
    """Lay params out for W8A8 serving, the one layout the port serves.

    ``params=None`` builds random int8 weights from ``generator``.  Float
    leaves are quantized (projections, head and embedding; int8 leaves
    pass through), qkv and gate/up are fused, every projection is blocked
    once for the W8A8 kernel (``engine.weights.preblock_llama_params``),
    and the int8 head is held in the compute dtype for the logits product
    (``engine.weights.head_for_logits``).
    """
    from generativeaiexamples_tpu_torch.engine.weights import head_for_logits, preblock_llama_params

    if params is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        logger.info("initializing random int8 llama params (%s)", cfg)
        params = init_random_int8_params(cfg, generator, device)
    # One step at a time, so each step's input is freed before the next
    # copies it (the unpacked and packed projections never both stay alive
    # through the blocking).
    params = llama.pack_for_serving(quantize_llama_params(params, include_embed=True))
    params = preblock_llama_params(params)
    return head_for_logits(params, cfg)


def init_random_int8_params(cfg: llama.LlamaConfig, generator: torch.Generator, device):
    """Random serving params with projections born int8: one random layer,
    quantized, then copied to full depth, so no full-depth float copy of
    the model ever exists (Llama-3-8B: about 8 GB of int8 weights)."""
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


def prepare_cache(cfg: llama.LlamaConfig, batch: int, max_len: int, device):
    """Allocate the slot KV cache."""
    return llama.init_kv_cache(cfg, batch, max_len, device=device)


def prepare_paged_pool(
    cfg: llama.LlamaConfig,
    max_batch: int,
    max_len: int,
    page_tokens: int,
    total_pages: Optional[int] = None,
    *,
    device,
):
    """Allocate the paged KV pool (``engine.paged_kv.PagedKVPool``), the
    paged counterpart of :func:`prepare_cache`; ``total_pages`` floors at
    ``max_batch * n_slot_pages + 1`` so admission never deadlocks on
    pages."""
    from generativeaiexamples_tpu_torch.engine.paged_kv import PagedKVPool

    return PagedKVPool(cfg, max_batch, max_len, page_tokens, total_pages=total_pages, device=device)


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
    ab_shape = (cfg.n_layers, cfg.n_kv_heads, b, n_steps, cfg.head_dim)
    return (
        torch.zeros(ab_shape, dtype=torch.int8, device=dev),
        torch.zeros(ab_shape, dtype=torch.int8, device=dev),
        torch.zeros(ab_shape[:-1], dtype=torch.bfloat16, device=dev),
        torch.zeros(ab_shape[:-1], dtype=torch.bfloat16, device=dev),
    )


def make_decode_chunk_fn(cfg: llama.LlamaConfig, max_len: int):
    """Multi-step decode with the append-buffer protocol.

    ``fn(params, cache, tokens, lengths, generator, temp, top_p, top_k,
    n_steps, kv_bucket=None) -> (cache, toks)`` with toks (n_steps, b) on
    the device.  Each step's fresh KV goes to a small (L, KH, B, n_steps,
    HD) append buffer; attention reads the big-cache window plus the
    buffer through the decode kernel; one scatter per leaf flushes the
    buffer at the end of the chunk.  The big cache is read-only inside the
    steps.  Nothing here waits for the device.
    """

    def decode_chunk(params, cache, tokens, lengths, generator, temp, top_p, top_k, n_steps, kv_bucket=None):
        b = cache[0].shape[2]
        # Valid big-cache slots per row: the current token's write position
        # (its KV lives in the append buffer this chunk).
        lengths0 = lengths.clamp(max=max_len - 1)
        ab = _append_buffer(cfg, b, n_steps, tokens.device)
        tok = tokens
        toks = []
        for step in range(n_steps):
            positions = (lengths0 + step).clamp(max=max_len - 1)[:, None]
            hidden, _, ab = llama.forward(
                params, cfg, tok[:, None].long(), positions, cache, lengths0,
                kv_bucket=kv_bucket, append_cache=(ab, step),
            )
            lg = llama.logits(params, hidden)[:, 0]
            tok = sample(lg, generator, temp, top_p, top_k)
            toks.append(tok)
        _flush_append_buffer(cache, ab, lengths0, max_len)
        return cache, torch.stack(toks)

    return decode_chunk


def make_paged_decode_chunk_fn(cfg: llama.LlamaConfig, max_len: int, page_tokens: int):
    """Paged twin of :func:`make_decode_chunk_fn`.

    ``fn(params, leaves, table, tokens, lengths, generator, temp, top_p,
    top_k, n_steps, kv_bucket=None) -> (leaves, toks)``: the pool leaves
    are updated in place, the device page table rides alongside (the host
    owns it), and ``max_len`` is the logical per-slot capacity the table
    maps.  The steps mirror the contiguous chunk's (append-buffer
    protocol, paged decode kernel), so greedy decode gives the same
    tokens in both layouts.
    """

    def paged_decode_chunk(
        params, leaves, table, tokens, lengths, generator, temp, top_p, top_k, n_steps, kv_bucket=None
    ):
        b = tokens.shape[0]
        lengths0 = lengths.clamp(max=max_len - 1)
        ab = _append_buffer(cfg, b, n_steps, tokens.device)
        tok = tokens
        toks = []
        for step in range(n_steps):
            positions = (lengths0 + step).clamp(max=max_len - 1)[:, None]
            hidden, _, ab = llama.forward(
                params, cfg, tok[:, None].long(), positions, leaves, lengths0,
                kv_bucket=kv_bucket, append_cache=(ab, step),
                page_table=table, page_tokens=page_tokens, pages_len=max_len,
            )
            lg = llama.logits(params, hidden)[:, 0]
            tok = sample(lg, generator, temp, top_p, top_k)
            toks.append(tok)
        _flush_append_buffer_paged(leaves, ab, lengths0, table, max_len, page_tokens)
        return leaves, torch.stack(toks)

    return paged_decode_chunk
