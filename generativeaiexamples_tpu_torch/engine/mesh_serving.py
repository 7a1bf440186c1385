"""The serving engine's device work as programs every rank of a mesh runs.

``Scheduler(mesh=...)`` keeps its tick loop, admission, prefix cache and
``/metrics`` on the controller and sends each piece of device work here
through ``Mesh.run`` with its small host inputs (tokens, lengths, sampling
rows, slot ids, page tables).  Each rank keeps a :class:`RankEngine` in
its context's ``state``: its shard of the parameters
(``engine.decode.prepare_params(mesh=...)``), of the cache (its KV heads
of the ``tensor`` axis and its slots of the ``data`` axis) or of the paged
pool (its KV heads' pages; the controller owns the page tables), and a
sampling generator seeded as the single-device scheduler's.  The forward
on each rank is the single-device one on the local shapes, the port's
kernels included (``models.llama.forward(mesh=...)``); logits are gathered
so that every rank samples the whole batch from equal generators and
holds the same tokens.  Rank 0's tokens come back to the controller.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional

import numpy as np
import torch

from generativeaiexamples_tpu_torch.engine.decode import (
    make_decode_chunk_fn,
    make_paged_decode_chunk_fn,
    prepare_cache,
    prepare_params,
)
from generativeaiexamples_tpu_torch.engine.sampler import sample
from generativeaiexamples_tpu_torch.models import llama

# Where ``Scheduler(mesh=...)`` refuses a feature this slice does not carry.
MESH_LATER = "ROADMAP.md Queue 1 item 10b-iii"


@dataclasses.dataclass(frozen=True)
class RankParams:
    """Where each rank gets its weights, so the controller never ships a
    whole tree: ``"seed"`` (random, drawn on each rank from the sampling
    generator's seed, as the single-device scheduler draws them),
    ``"tree"`` (a small tree, numpy or CPU tensors, sent to every rank),
    ``"checkpoint"`` (an HF checkpoint directory every rank reads) or
    ``"sharded"`` (the port's checkpoint format, ``engine.weights.
    save_checkpoint``: each rank reads only its slice of each leaf).
    ``quantize`` turns the projections, head and embedding into
    weight-only int8 before slicing (not for ``"sharded"``, whose slices
    are never whole)."""

    kind: str = "seed"
    tree: Any = None
    path: str = ""
    quantize: bool = False


@dataclasses.dataclass
class RankEngine:
    cfg: llama.LlamaConfig
    params: Any
    cache: tuple
    gen: torch.Generator
    device: torch.device
    max_batch: int
    max_len: int
    page_tokens: int
    chunk: Any
    digest: Any = dataclasses.field(default_factory=hashlib.sha256)
    sampled: int = 0


def tree_to_host(tree):
    """A param tree with its tensors moved to the CPU (to send to ranks)."""
    from generativeaiexamples_tpu_torch.ops.quant import QuantizedMatrix

    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedMatrix):
        return QuantizedMatrix(q=tree.q.cpu(), scale=tree.scale.cpu())
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def setup(ctx, key: str, cfg: llama.LlamaConfig, source: RankParams, max_batch: int, max_len: int,
          kv_layout: str, page_tokens: int, total_pages: Optional[int], seed: int) -> dict:
    """Build this rank's engine under ``key``; returns its shard's bytes."""
    dev = ctx.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if source.kind == "seed":
        params = prepare_params(cfg, None, device=dev, quantize=source.quantize, generator=gen, mesh=ctx)
    elif source.kind == "tree":
        params = prepare_params(cfg, source.tree, device=dev, quantize=source.quantize, mesh=ctx)
    elif source.kind == "checkpoint":
        from generativeaiexamples_tpu_torch.engine.weights import load_hf_causal_lm

        params = prepare_params(cfg, load_hf_causal_lm(cfg, source.path, device="cpu"), device=dev,
                                quantize=source.quantize, mesh=ctx)
    elif source.kind == "sharded":
        from generativeaiexamples_tpu_torch.engine.weights import load_checkpoint_shard

        if source.quantize:
            raise ValueError("a sharded checkpoint is read slice by slice: quantize it before saving")
        params = load_checkpoint_shard(cfg, source.path, ctx.sizes, ctx.coords, dev)
    else:
        raise ValueError(f"unknown RankParams kind {source.kind!r}")
    lc = llama.local_config(cfg, ctx)
    if kv_layout == "paged":
        from generativeaiexamples_tpu_torch.engine.paged_kv import PagedKVPool

        cache = PagedKVPool(lc, max_batch, max_len, page_tokens, total_pages, device=dev).leaves
        chunk = make_paged_decode_chunk_fn(cfg, max_len, page_tokens, mesh=ctx)
    else:
        cache = prepare_cache(cfg, max_batch, max_len, dev, mesh=ctx)
        chunk = make_decode_chunk_fn(cfg, max_len, mesh=ctx)
    ctx.state[key] = RankEngine(cfg, params, cache, gen, dev, max_batch, max_len, page_tokens, chunk)
    return {"param_bytes": _nbytes(params), "cache_bytes": sum(c.numel() * c.element_size() for c in cache)}


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_nbytes(getattr(tree, f)) for f in ("q", "scale") if hasattr(tree, f))


def drop(ctx, key: str) -> None:
    ctx.state.pop(key, None)


def _per(ctx, eng: RankEngine) -> int:
    return eng.max_batch // ctx.size("data")


def _sample(ctx, eng: RankEngine, lg, temp, top_p, top_k) -> torch.Tensor:
    """One sampler draw over the whole batch's logits (equal on every
    rank), folded into the rank's digest of what it sampled."""
    dev = eng.device
    tok = sample(lg, eng.gen, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (temp, top_p, top_k)))
    host = tok.cpu()
    eng.digest.update(host.numpy().tobytes())
    eng.sampled += host.numel()
    return host


def _gather_rows(ctx, lg: Optional[torch.Tensor], rows: list[int], n: int, vocab: int, dev) -> torch.Tensor:
    """The (n, vocab) logits of a batch whose rows ``rows`` this rank's data
    block computed (``lg``, or None for none): a ``psum`` over ``data``
    of each block's rows at their places (exact: one nonzero term)."""
    if ctx.size("data") == 1:
        return lg
    full = torch.zeros((n, vocab), dtype=torch.float32, device=dev)
    if rows:
        full[torch.tensor(rows, device=dev)] = lg
    return ctx.psum(full, "data")


def admit(ctx, key: str, tokens: np.ndarray, lengths: np.ndarray, temp, top_p, top_k, slots: np.ndarray,
          phys: Optional[np.ndarray]) -> torch.Tensor:
    """Cold-prefill an admission batch (``tokens`` (pb, s), the first
    ``len(slots)`` rows real) into a fresh small cache, sample every row's
    first token and copy the real rows into their slots (``phys``: their
    physical pool slots on the paged layout).  Each data block prefills the
    rows whose slots it holds (all ``pb`` rows when ``data`` is 1, as the
    single-device scheduler does)."""
    eng = ctx.state[key]
    dev, cfg = eng.device, eng.cfg
    pb, s = tokens.shape
    k = len(slots)
    if ctx.size("data") == 1:
        rows, local = list(range(pb)), list(slots)
    else:
        per, d = _per(ctx, eng), ctx.index("data")
        rows = [r for r in range(k) if slots[r] // per == d]
        local = [int(slots[r]) - d * per for r in rows]
    lg, small = None, None
    if rows:
        t = torch.from_numpy(np.ascontiguousarray(tokens[rows])).to(dev).long()
        lens = torch.from_numpy(np.ascontiguousarray(lengths[rows])).to(dev)
        small = llama.init_kv_cache(llama.local_config(cfg, ctx), len(rows), s, device=dev)
        positions = torch.arange(s, dtype=torch.int32, device=dev).expand(len(rows), s)
        hidden, small = llama.forward(eng.params, cfg, t, positions, small, lens, cold_prefill=True, mesh=ctx)
        last = hidden[torch.arange(len(rows), device=dev), (lens.long() - 1).clamp(min=0)]
        lg = llama.logits(eng.params, last[:, None, :], ctx)[:, 0]
    tok = _sample(ctx, eng, _gather_rows(ctx, lg, rows, pb, cfg.vocab_size, dev), temp, top_p, top_k)
    n_local = min(len(local), k)
    if n_local:
        if phys is not None:
            idx = torch.from_numpy(np.ascontiguousarray(phys)).to(dev)
            for big, sm in zip(eng.cache, small):
                big[:, :, idx] = sm[:, :, :n_local]
        else:
            idx = torch.tensor(local[:n_local], device=dev)
            for big, sm in zip(eng.cache, small):
                big[:, :, idx, :s] = sm[:, :, :n_local]
    return tok


def prefill_suffix(ctx, key: str, tokens: np.ndarray, start: int, suffix_len: int, slot: int, sampling,
                   kv_bucket: int, table_row: Optional[np.ndarray]) -> torch.Tensor:
    """Warm-prefill ``tokens`` (1, s) at positions ``start..`` into
    ``slot`` (through its page-table row on the paged layout) and sample
    the next token; only the slot's data block runs the forward."""
    eng = ctx.state[key]
    dev, cfg = eng.device, eng.cfg
    per = _per(ctx, eng)
    mine = slot // per == ctx.index("data")
    lg = None
    if mine:
        t = torch.from_numpy(np.ascontiguousarray(tokens)).to(dev).long()
        s = t.shape[1]
        positions = start + torch.arange(s, dtype=torch.int32, device=dev)[None, :]
        kv_len = torch.full((1,), start + suffix_len, dtype=torch.int32, device=dev)
        if table_row is not None:
            hidden, _ = llama.forward(eng.params, cfg, t, positions, eng.cache, kv_len, kv_bucket=kv_bucket,
                                      page_table=torch.from_numpy(np.ascontiguousarray(table_row)).to(dev),
                                      page_tokens=eng.page_tokens, pages_len=eng.max_len, mesh=ctx)
        else:
            li = slot - ctx.index("data") * per
            row = tuple(c[:, :, li : li + 1] for c in eng.cache)
            hidden, _ = llama.forward(eng.params, cfg, t, positions, row, kv_len, kv_bucket=kv_bucket, mesh=ctx)
        last = hidden[0, max(suffix_len - 1, 0)]
        lg = llama.logits(eng.params, last[None, None, :], ctx)[:, 0]
    temp, top_p, top_k = sampling
    return _sample(ctx, eng, _gather_rows(ctx, lg, [0] if mine else [], 1, cfg.vocab_size, dev), temp, top_p,
                   top_k)


def graft_prefix(ctx, key: str, src: int, dst: int, n: int) -> None:
    """Copy the first ``n`` cache positions of slot ``src`` into ``dst``
    (contiguous layout); across data blocks the source block broadcasts
    the row over ``data``."""
    eng = ctx.state[key]
    per, d = _per(ctx, eng), ctx.index("data")
    s_owner, d_owner = src // per, dst // per
    for buf in eng.cache:
        m = min(n, buf.shape[3])
        if s_owner == d_owner:
            if d == s_owner:
                buf[:, :, dst - d * per, :m] = buf[:, :, src - d * per, :m]
            continue
        row = buf[:, :, src - d * per, :m] if d == s_owner else torch.zeros_like(buf[:, :, 0, :m])
        row = ctx.broadcast(row.contiguous(), "data", s_owner)
        if d == d_owner:
            buf[:, :, dst - d * per, :m] = row


def decode(ctx, key: str, cur_tok: np.ndarray, lengths: np.ndarray, temp, top_p, top_k, n_steps: int,
           kv_bucket: int, table: Optional[np.ndarray]) -> torch.Tensor:
    """One decode chunk of ``n_steps`` over the whole batch; returns the
    (n_steps, max_batch) tokens."""
    eng = ctx.state[key]
    dev = eng.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cache_args = (eng.cache,) if table is None else (eng.cache, t(table))
    _, toks = eng.chunk(eng.params, *cache_args, t(cur_tok), t(lengths), eng.gen, t(temp), t(top_p), t(top_k),
                        n_steps, kv_bucket)
    host = toks.cpu()
    eng.digest.update(host.numpy().tobytes())
    eng.sampled += host.numel()
    return host


def reset_cache(ctx, key: str) -> None:
    """Recovery: zero this rank's cache (or pool leaves)."""
    for leaf in ctx.state[key].cache:
        leaf.zero_()


def sampled_digest(ctx, key: str) -> tuple[str, int]:
    """The rank's digest of every token it sampled, and their count: equal
    on every rank when the ranks sampled alike."""
    eng = ctx.state[key]
    return eng.digest.hexdigest(), eng.sampled
