"""Speculative decoding in the serving scheduler: the device-side chunk
(port of ``engine/spec_decode.py``).

One **speculation round** per live slot:

* a draft proposes ``gamma`` tokens: an independent W8A8 draft model with
  its own contiguous slot cache, the target's own first layers
  (:func:`self_draft`), or no model at all (prompt lookup: the tokens
  that followed the latest earlier occurrence of the trailing n-gram);
* the target scores ``[tok, d_1..d_gamma]`` in one verify forward: the
  fresh K/V ride a ``gamma + 1``-slot append buffer, attention reads the
  cache prefix plus the causal buffer (``models.llama.forward``'s verify
  mode), and one windowed flush lands the buffer in the cache;
* greedy rows accept the longest prefix that agrees with the target's
  argmax plus the target's own next token, so their stream is the plain
  chunk's;
* filtered sampled rows (top_p < 1 or top_k > 0) run rejection sampling
  on the sparse candidate pool (``engine.sampler.warped_candidates``):
  draft ``x_i`` is kept with probability ``min(1, p_i(x_i) / q_i(x_i))``,
  the first rejection emits a draw from the residual ``max(p - q, 0)``,
  and a fully accepted round emits a bonus draw from ``p_gamma``;
* unfiltered sampled rows emit one token a round (the plain sampler draws
  them from the full vocabulary, which the sparse test cannot match).

A chunk is an eager loop of ``n_rounds`` rounds with no host sync inside:
the all-greedy gate (skip the warps when no row samples) is the host's
decision, passed in as ``sampled``, and every per-row choice is a tensor
``where``.  Rows advance by their own acceptance; KV written for rejected
drafts lies past a row's accepted length and is overwritten before any
mask or graft exposes it.
"""

from __future__ import annotations

import dataclasses

import torch

from generativeaiexamples_tpu_torch.engine.decode import (
    _append_buffer,
    _flush_append_buffer,
    _flush_append_buffer_paged,
)
from generativeaiexamples_tpu_torch.engine.sampler import (
    CANDIDATES,
    prob_of,
    sample,
    sample_from_candidates,
    warped_candidates,
)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix
from generativeaiexamples_tpu_torch.ops.quant import QuantizedMatrix


def gamma_bucket(desired: int, gamma_max: int) -> int:
    """Round a desired lookahead up to the next power of two, clamped to
    ``[1, gamma_max]``: the adaptive controller's chunks run at one of
    ``{1, 2, 4, ...} | {gamma_max}``, and rounding up can only
    over-speculate."""
    d = max(1, min(int(desired), int(gamma_max)))
    b = 1
    while b < d:
        b <<= 1
    return min(b, int(gamma_max))


def _first_layers(leaf, n: int):
    if isinstance(leaf, BlockedQuantizedMatrix):
        return BlockedQuantizedMatrix(leaf.w[:n], leaf.scale[:n], leaf.k, leaf.n)
    if isinstance(leaf, QuantizedMatrix):
        return QuantizedMatrix(leaf.q[:n], leaf.scale[:n])
    return leaf[:n]


def self_draft(cfg: llama.LlamaConfig, params, n_layers: int) -> tuple[llama.LlamaConfig, dict]:
    """Early-exit self-speculation: the draft is the target's first
    ``n_layers`` layers with its embedding, final norm and head.  Every
    layer leaf is a view of the target's stacked leaf (prepared W8A8
    params included), so the draft adds no weights, only its KV cache."""
    if not 1 <= n_layers < cfg.n_layers:
        raise ValueError(f"self-draft depth must be in [1, {cfg.n_layers}), got {n_layers}")
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    dparams = dict(params)
    dparams["layers"] = {name: _first_layers(leaf, n_layers) for name, leaf in params["layers"].items()}
    return dcfg, dparams


def _verify_and_emit(
    tparams, tcfg, max_len, kv_bucket, gamma, tcache, tok, lengths0, drafts, q_ids, q_probs,
    greedy, temp, top_p, top_k, generator, sampled, page_table=None, page_tokens=0,
):
    """The target's verify pass, acceptance and emission: the shared back
    half of every round.  ``drafts`` (b, gamma); ``q_ids`` / ``q_probs``
    (gamma, b, kq) the draft's sparse distributions (one-hot, kq = 1, for
    prompt lookup).  Returns ``(out (b, gamma + 1), n_emit (b,), next_tok,
    new_lengths)``; the target cache is updated in place."""
    b = tok.shape[0]
    dev = tok.device
    bidx = torch.arange(b, device=dev)
    inputs = torch.cat([tok[:, None], drafts], dim=1).long()
    offs = torch.arange(gamma + 1, dtype=torch.int32, device=dev)[None, :]
    tpos = (lengths0[:, None] + offs).clamp(max=max_len - 1)
    ab = _append_buffer(tcfg, b, gamma + 1, dev)
    if page_table is not None:
        hidden, _, ab = llama.forward(
            tparams, tcfg, inputs, tpos, tcache, lengths0, kv_bucket=kv_bucket, append_cache=(ab, 0),
            page_table=page_table, page_tokens=page_tokens, pages_len=max_len,
        )
        _flush_append_buffer_paged(tcache, ab, lengths0, page_table, max_len, page_tokens)
    else:
        hidden, _, ab = llama.forward(
            tparams, tcfg, inputs, tpos, tcache, lengths0, kv_bucket=kv_bucket, append_cache=(ab, 0)
        )
        _flush_append_buffer(tcache, ab, lengths0, max_len)
    tlogits = llama.logits(tparams, hidden)  # (b, gamma + 1, vocab)
    targets = torch.argmax(tlogits, dim=-1).to(torch.int32)

    # Greedy: targets[:, i] is the target's token after input i, so draft
    # d_{i+1} stands iff it equals targets[:, i].
    agree = (drafts == targets[:, :gamma]).to(torch.int32)
    n_accept = torch.cumprod(agree, dim=1).sum(dim=1)

    if sampled:
        out_s, n_emit_s = _rejection_sample(
            tlogits, drafts, q_ids, q_probs, greedy, temp, top_p, top_k, generator, gamma, offs
        )
    else:
        out_s = torch.zeros((b, gamma + 1), dtype=torch.int32, device=dev)
        n_emit_s = torch.ones((b,), dtype=torch.int32, device=dev)

    out = torch.where(greedy[:, None], targets, out_s)
    n_emit = torch.where(greedy, n_accept.to(torch.int32) + 1, n_emit_s)
    # Never advance past max_len - 1: a full row emits garbage the host has
    # finished (or finishes) on its length cap.
    room = (max_len - 1 - lengths0).clamp(min=1)
    n_emit = torch.minimum(n_emit, room).to(torch.int32)
    next_tok = out[bidx, (n_emit - 1).long()]
    new_lengths = (lengths0 + n_emit).clamp(max=max_len - 1)
    return out, n_emit, next_tok, new_lengths


def _rejection_sample(tlogits, drafts, q_ids, q_probs, greedy, temp, top_p, top_k, generator, gamma, offs):
    """Sampled rows: accept ``x_i`` iff ``u * q_i(x_i) < p_i(x_i)``, then
    one draw from the residual at the first rejection (``p_gamma`` when
    all were accepted).  Returns ``(out_s, n_emit_s)``."""
    b = tlogits.shape[0]
    dev = tlogits.device
    bidx = torch.arange(b, device=dev)
    flat = tlogits.reshape(b * (gamma + 1), -1)

    def rep(a):
        return a.repeat_interleave(gamma + 1, dim=0)

    p_ids_f, p_probs_f = warped_candidates(flat, rep(temp), rep(top_p), rep(top_k))
    kk = p_ids_f.shape[-1]
    p_ids = p_ids_f.reshape(b, gamma + 1, kk)
    p_probs = p_probs_f.reshape(b, gamma + 1, kk)
    kq = q_ids.shape[-1]
    qx = prob_of(q_ids.reshape(gamma * b, kq), q_probs.reshape(gamma * b, kq), drafts.t().reshape(gamma * b))
    qx = qx.reshape(gamma, b)
    px = prob_of(
        p_ids[:, :gamma].reshape(b * gamma, kk), p_probs[:, :gamma].reshape(b * gamma, kk), drafts.reshape(b * gamma)
    ).reshape(b, gamma)
    u = torch.rand((b, gamma), generator=generator, device=dev, dtype=torch.float32)
    accept = (u * qx.t() < px).to(torch.int32)
    n_acc = torch.cumprod(accept, dim=1).sum(dim=1)
    # The correction at position j = n_acc: the residual max(p_j - q_j, 0)
    # over p's candidates, with q_gamma = 0 (so an all-accepted row draws
    # its bonus token from p_gamma).
    j = n_acc.long()
    p_at_ids = p_ids[bidx, j]
    p_at = p_probs[bidx, j]
    q_ids_b = torch.cat([q_ids.transpose(0, 1), torch.zeros((b, 1, kq), dtype=q_ids.dtype, device=dev)], dim=1)
    q_probs_b = torch.cat([q_probs.transpose(0, 1), torch.zeros((b, 1, kq), dtype=q_probs.dtype, device=dev)], dim=1)
    q_at_ids = q_ids_b[bidx, j]
    q_at = q_probs_b[bidx, j]
    hit = p_at_ids[:, :, None] == q_at_ids[:, None, :].to(p_at_ids.dtype)
    q_on_p = torch.where(hit, q_at[:, None, :], torch.zeros_like(q_at[:, None, :])).sum(dim=-1)
    residual = (p_at - q_on_p).clamp(min=0.0)
    # An all-zero residual can only come from rounding: fall back to p.
    residual = torch.where(residual.sum(dim=-1, keepdim=True) > 1e-9, residual, p_at)
    correction = sample_from_candidates(p_at_ids, residual, generator)
    drafts_pad = torch.cat([drafts, torch.zeros((b, 1), dtype=drafts.dtype, device=dev)], dim=1)
    out_s = torch.where(offs < n_acc[:, None], drafts_pad, torch.zeros_like(drafts_pad)).to(torch.int32)
    out_s[bidx, j] = correction
    n_emit_s = (n_acc + 1).to(torch.int32)
    # Unfiltered sampled rows: one token from the plain sampler.
    sampled0 = sample(tlogits[:, 0], generator, temp, top_p, top_k)
    unfiltered = (~greedy) & (top_p >= 1.0) & (top_k <= 0)
    first_only = torch.where(offs == 0, sampled0[:, None], torch.zeros_like(sampled0[:, None]))
    out_s = torch.where(unfiltered[:, None], first_only, out_s)
    return out_s, torch.where(unfiltered, torch.ones_like(n_emit_s), n_emit_s)


def _draft_round(dparams, dcfg, dcache, tok, lengths0, max_len, kv_bucket, gamma, greedy, temp, top_p, top_k,
                 generator, sampled):
    """The draft model's gamma autoregressive steps (warm single-token
    forwards into its contiguous slot cache), then d_gamma's K/V (a fully
    accepted round advances past it).  Returns ``(drafts (b, gamma),
    q_ids, q_probs (gamma, b, kq))``."""
    b = tok.shape[0]
    dev = tok.device
    kq = min(CANDIDATES, dcfg.vocab_size)
    cur, pos = tok, lengths0
    drafts, qi, qp = [], [], []
    for _ in range(gamma):
        hidden, _ = llama.forward(
            dparams, dcfg, cur[:, None].long(), pos.clamp(max=max_len - 1)[:, None], dcache,
            (pos + 1).clamp(max=max_len), kv_bucket=kv_bucket,
        )
        dlogits = llama.logits(dparams, hidden)[:, 0]
        if sampled:
            q_ids, q_probs = warped_candidates(dlogits, temp, top_p, top_k)
            drawn = sample_from_candidates(q_ids, q_probs, generator)
        else:
            q_ids = torch.zeros((b, kq), dtype=torch.int64, device=dev)
            q_probs = torch.zeros((b, kq), dtype=torch.float32, device=dev)
            drawn = torch.zeros((b,), dtype=torch.int32, device=dev)
        cur = torch.where(greedy, torch.argmax(dlogits, dim=-1).to(torch.int32), drawn)
        drafts.append(cur)
        qi.append(q_ids)
        qp.append(q_probs)
        pos = pos + 1
    llama.forward(
        dparams, dcfg, cur[:, None].long(), (lengths0 + gamma).clamp(max=max_len - 1)[:, None], dcache,
        (lengths0 + gamma + 1).clamp(max=max_len), kv_bucket=kv_bucket,
    )
    return torch.stack(drafts, dim=1), torch.stack(qi), torch.stack(qp)


def _ngram_drafts(hist, tok, lengths0, max_len, gamma, ngram):
    """Prompt lookup: the gamma tokens after the latest earlier occurrence
    of the trailing n-gram (``hist[p]`` is the token whose KV lands at
    position p, the current token at ``lengths0``), preferring a match
    whose whole continuation is already written; the current token
    repeated when nothing matches (verified, never trusted)."""
    b = tok.shape[0]
    dev = tok.device
    p_idx = torch.arange(max_len, dtype=torch.int32, device=dev)[None, :]
    match = (p_idx >= ngram - 1) & (p_idx < lengths0[:, None])
    for k in range(ngram):
        tail = torch.gather(hist, 1, (lengths0[:, None] - k).clamp(min=0).long())
        # roll(hist, k)[p] == hist[p - k] for p >= k; the wrapped columns
        # p < k <= ngram - 1 are masked above.
        match &= torch.roll(hist, k, dims=1) == tail
    found = match.any(dim=1)
    full = match & (p_idx + gamma <= lengths0[:, None])
    neg = torch.full_like(p_idx.expand(b, max_len), -1)
    score = torch.where(full, p_idx + max_len, torch.where(match, p_idx.expand(b, max_len), neg))
    j = torch.argmax(score, dim=1) % max_len
    gidx = (j[:, None] + 1 + torch.arange(gamma, device=dev)[None, :]).clamp(0, max_len - 1)
    drafts = torch.gather(hist, 1, gidx)
    return torch.where(found[:, None], drafts, tok[:, None]).to(torch.int32)


def _record_history(hist, out, n_emit, lengths0, max_len, gamma):
    """Write each row's emitted tokens at ``lengths0 + 1 + i`` for ``i <
    n_emit``, dropping positions at or past ``max_len`` (the reference's
    ``mode="drop"`` scatter).  Each offset is one write per row, and a row
    with nothing to write there writes back the value it reads (at a
    clamped position), so no write collides with another and none lands
    out of range."""
    bidx = torch.arange(hist.shape[0], device=hist.device)
    for i in range(gamma + 1):
        pos = lengths0 + 1 + i
        write = (i < n_emit) & (pos < max_len)
        pos = pos.clamp(max=max_len - 1).long()
        keep = torch.gather(hist, 1, pos[:, None])[:, 0]
        hist[bidx, pos] = torch.where(write, out[:, i], keep)


def _spec_loop(round_fn, tok, lengths, n_rounds):
    outs, n_emits = [], []
    for _ in range(n_rounds):
        out, n_emit, tok, lengths = round_fn(tok, lengths)
        outs.append(out)
        n_emits.append(n_emit)
    return torch.stack(outs), torch.stack(n_emits)


def _make_model_chunk(tcfg, dcfg, max_len, page_tokens=0):
    def chunk(params_pair, tcache, table, dcache, tok, lengths, generator, temp, top_p, top_k,
              n_rounds, gamma, kv_bucket, sampled):
        tparams, dparams = params_pair
        greedy = temp <= 0.0

        def round_fn(tok, lengths):
            lengths0 = lengths.clamp(max=max_len - 1)
            drafts, q_ids, q_probs = _draft_round(
                dparams, dcfg, dcache, tok, lengths0, max_len, kv_bucket, gamma, greedy, temp, top_p, top_k,
                generator, sampled,
            )
            return _verify_and_emit(
                tparams, tcfg, max_len, kv_bucket, gamma, tcache, tok, lengths0, drafts, q_ids, q_probs,
                greedy, temp, top_p, top_k, generator, sampled, page_table=table, page_tokens=page_tokens,
            )

        outs, n_emits = _spec_loop(round_fn, tok.to(torch.int32), lengths.to(torch.int32), n_rounds)
        return tcache, dcache, outs, n_emits

    return chunk


def make_spec_chunk_fn(tcfg: llama.LlamaConfig, dcfg: llama.LlamaConfig, max_len: int):
    """Multi-round speculation with a draft model, on the contiguous cache.

    ``fn(params_pair, tcache, dcache, tok, lengths, generator, temp,
    top_p, top_k, n_rounds, gamma, kv_bucket, sampled) -> (tcache,
    dcache, outs, n_emits)``: both caches are updated in place;
    ``lengths`` is each row's next write position (the current token
    ``tok``'s KV is not yet in either cache, the plain chunk's
    convention); ``sampled`` is the host's answer to "does any row
    sample" (False skips every warp).  ``outs`` (n_rounds, b, gamma + 1)
    holds each round's candidates and ``n_emits`` (n_rounds, b) how many
    are real: the host emits ``outs[r, i, :n_emits[r, i]]``.
    """
    chunk = _make_model_chunk(tcfg, dcfg, max_len)

    def spec_chunk(params_pair, tcache, dcache, tok, lengths, generator, temp, top_p, top_k,
                   n_rounds, gamma, kv_bucket, sampled):
        return chunk(params_pair, tcache, None, dcache, tok, lengths, generator, temp, top_p, top_k,
                     n_rounds, gamma, kv_bucket, sampled)

    return spec_chunk


def make_paged_spec_chunk_fn(tcfg: llama.LlamaConfig, dcfg: llama.LlamaConfig, max_len: int, page_tokens: int):
    """Paged-target twin of :func:`make_spec_chunk_fn`: ``fn(params_pair,
    tleaves, table, dcache, tok, lengths, generator, temp, top_p, top_k,
    n_rounds, gamma, kv_bucket, sampled)``.  The target's verify pass and
    flush go through the page table; the draft cache stays contiguous.
    The caller makes ``[lengths, lengths + n_rounds * (gamma + 1) + 1)``
    writable for each live lane first and trims back to the accepted
    length after (``engine.paged_kv.PagedKVPool.make_writable`` /
    ``trim``)."""
    return _make_model_chunk(tcfg, dcfg, max_len, page_tokens)


def _make_ngram_chunk(tcfg, max_len, ngram, page_tokens=0):
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")

    def chunk(tparams, tcache, table, hist, tok, lengths, generator, temp, top_p, top_k,
              n_rounds, gamma, kv_bucket, sampled):
        greedy = temp <= 0.0
        bidx = torch.arange(tok.shape[0], device=tok.device)

        def round_fn(tok, lengths):
            lengths0 = lengths.clamp(max=max_len - 1)
            # The current token is part of the matchable pattern.
            hist[bidx, lengths0.long()] = tok
            drafts = _ngram_drafts(hist, tok, lengths0, max_len, gamma, ngram)
            q_ids = drafts.t()[..., None]  # one-hot q: width-1 candidate lists
            q_probs = torch.ones(q_ids.shape, dtype=torch.float32, device=tok.device)
            out, n_emit, next_tok, new_lengths = _verify_and_emit(
                tparams, tcfg, max_len, kv_bucket, gamma, tcache, tok, lengths0, drafts, q_ids, q_probs,
                greedy, temp, top_p, top_k, generator, sampled, page_table=table, page_tokens=page_tokens,
            )
            # Later rounds of this chunk match against the accepted tokens
            # (the host rebuilds rows only at admission).
            _record_history(hist, out, n_emit, lengths0, max_len, gamma)
            return out, n_emit, next_tok, new_lengths

        outs, n_emits = _spec_loop(round_fn, tok.to(torch.int32), lengths.to(torch.int32), n_rounds)
        return tcache, hist, outs, n_emits

    return chunk


def make_ngram_spec_chunk_fn(tcfg: llama.LlamaConfig, max_len: int, ngram: int = 2):
    """Prompt-lookup speculation on the contiguous cache: no draft weights,
    no draft cache.  ``hist`` is the (b, max_len) int32 token history on
    the device (``hist[p]`` = the token whose KV lands at position p), kept
    by the scheduler from prompts and carried forward by the chunk, in
    place.  ``fn(tparams, tcache, hist, tok, lengths, generator, temp,
    top_p, top_k, n_rounds, gamma, kv_bucket, sampled) -> (tcache, hist,
    outs, n_emits)``; proposals verify as one-hot q distributions, so
    greedy rows keep the plain stream and sampled rows the warped target
    marginal."""
    chunk = _make_ngram_chunk(tcfg, max_len, ngram)

    def ngram_chunk(tparams, tcache, hist, tok, lengths, generator, temp, top_p, top_k,
                    n_rounds, gamma, kv_bucket, sampled):
        return chunk(tparams, tcache, None, hist, tok, lengths, generator, temp, top_p, top_k,
                     n_rounds, gamma, kv_bucket, sampled)

    return ngram_chunk


def make_paged_ngram_spec_chunk_fn(tcfg: llama.LlamaConfig, max_len: int, page_tokens: int, ngram: int = 2):
    """Paged-target twin of :func:`make_ngram_spec_chunk_fn`:
    ``fn(tparams, tleaves, table, hist, tok, lengths, generator, temp,
    top_p, top_k, n_rounds, gamma, kv_bucket, sampled)``, with the
    make_writable / trim contract of :func:`make_paged_spec_chunk_fn`."""
    return _make_ngram_chunk(tcfg, max_len, ngram, page_tokens)
