#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. ``build``: nvcc builds the four kernels from ``csrc/`` in parallel
   (with each kernel function's registers, spills and shared memory).
3. ``kernel``: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (the W8A8 matmul bitwise, both of its
   designs, at M = 1, 33, 65 and at the timed M = 32, 256, 2048 over
   Llama-3-8B's four projections, with its achieved rate and bound share;
   the attention kernels
   within stated bf16 tolerances; the paged decode kernel also bit for bit
   equal to the contiguous one on mirrored content at page sizes 16, 32,
   64 and 128), with kernel, plain and library times and the least time
   the card could take (its bound).  Kernels and library calls are timed
   as CUDA-graph replays (the device's time; an eager loop of a short
   kernel measures the host's launch rate), with the eager time beside
   (``eager_ms``); the decode kernel also at each split count.
4. ``reference``: a small bf16 model (head_dim 128) run through the
   kernels on the card and through the plain versions on the CPU: the
   cold-prefill logits and one append-buffer decode step's logits agree
   element by element within a stated tolerance.
5. ``bert``: BERT at arctic-embed-l's width (2 layers, bf16, random
   weights from seed 0) on the card and on the CPU with the same weights:
   embeddings, and rerank scores of a padded two-segment batch, within
   ``BERT_TOL``.
6. ``embed``: arctic-embed-l at full depth (24 layers, bf16, seed 0) through
   the port's ``GPUEmbedder``: 256 documents of 510 byte tokens (batches of
   32 x 512) and 32 queries; unit-norm finite vectors, each query alone
   within ``EMBED_TOL`` of itself in the batch; ms per 32 x 512 forward
   (CUDA events) beside its FLOP bound, docs/s.
7. ``retrieve``: the exact ``GPUVectorStore``, built by the port's
   ``get_store()`` from the ``AppConfig`` defaults, with 1,000,000 clustered
   bf16 rows of 1024 (numpy, seed 0): 128 queries (64 planted on corpus rows)
   at top_k 4 and 10, ids against an f64 brute force over the bf16 values,
   5,000 rows appended through the tail (no rebuild), a masked delete
   (masks only); the scan's device ms per 128-query batch beside its byte
   bound, and the share of ``torch.topk``.
8. ``retriever``: the retrieval chain as ``chains/factory.py`` builds it from
   the ``AppConfig`` defaults (arctic-embed-l, 24 layers, random bf16, seed
   0; the result cache on; no reranker) over that store plus 2,048
   documents of 510 byte tokens.  Cold: 128 queries through
   ``Retriever.retrieve_many`` give the direct calls' hits and scores, none
   degraded, with each trace stage's ms.  Warm: the same 128 are exact-tier
   hits with no BERT forward, scan or ring scan.  The semantic ring at 512 x
   1024 against a numpy f64 reference (argmax and hit/miss).  32 concurrent
   requests through ``get_retrieval_batcher()``, each with its own 2 s
   deadline, logs and trace: none degraded or failed.  The ladder: a
   ``store`` fault serves ``index_fallback`` with the device search's
   ranks (and ``search_fallback`` alone at 1M rows, timed and checked on
   planted queries); without the fallback a warm cache serves
   ``cache_stale``.  Then ``ranking.model_engine`` ``tpu`` (the 24-layer
   cross-encoder): 32 queries at fetch_k 16 rank as a direct
   ``score_pairs`` of their 512 pairs, and a ``reranker`` fault serves
   vector-search order.  The chain and the store are freed after.
9. ``serve``: Llama-3-8B at full width and depth (random int8 weights from
   a seed, int8 contiguous KV), served by the port's Scheduler and HTTP
   front on 127.0.0.1: eight concurrent completions, a streaming chat, two
   prompts sent alone, models, health and metrics.  Launch counts are
   zeroed just before and read just after; every kernel of the path, and
   both designs of the W8A8 kernel, must have launched.  Then the same
   front's ``/v1/embeddings`` (the arctic embedder behind the
   micro-batcher: 32 concurrent single queries, one 64-passage request)
   and ``/v1/ranking`` (an arctic reranker, 16 passages) against direct
   calls, with the ``rag_*`` series showing the queries coalesced.  Then
   one decode chunk at batch 32 is timed, untraced.
10. ``serve_paged``: the same on the paged KV pool (page 64, same params),
   plus a shared-prefix group (a 300-token prompt, then four extensions of
   it): the paged decode kernel must have launched, grafts must be host
   table copies, the shared boundary page must be copied on write, the
   prompts sent alone must give the contiguous server's greedy text, and
   the pool must be all free once the parked segments are dropped.
11. ``profile`` and ``profile_paged``: the decode chunk of each layout
   traced with torch.profiler (device time by kernel, and the device's
   busy share of the traced call's own span); then ``profile_embed``, one
   32 x 512 arctic-embed-l forward traced the same way.  The traces come
   after every untraced measurement: a trace leaves the process's later
   host work slower.
12. ``chain``: the chain server as ``create_app()`` builds it from the
   ``APP_*`` defaults (Llama-3-8B W8A8 behind ``GPUChatLLM``, random int8,
   seed 0; arctic-embed-l; the exact store; the result cache; no
   reranker), the earlier phases' params freed first, driven over HTTP on
   127.0.0.1 (K4 first held against its plain version at the phase's
   prefill shape, s = 2048).  64 short documents and 4 of ~6 KB uploaded
   through ``/documents``; 16 ``/search`` queries equal to
   ``QAChatbot().document_search`` and to the store's threshold-filtered
   search, bit for bit; the long documents deleted and no longer
   searched; one greedy ``/generate`` whose system turn is the RAG
   template over the hits ``/search`` gave, and whose streamed text is
   the engine's own for the same ids submitted directly; 8 concurrent
   streams and one with the knowledge base off (TTFT, decode tokens/s,
   Server-Timing stages, micro-batches); ``/health``, ``/metrics``, a 504
   at a 1 ms deadline.  Launch counts are zeroed after the build and read
   at the end: K1, K2 and K4 must have launched, K3 not.

Then the ``kernels`` summary line (each kernel's ``launches`` from its
serving phase, ``chain_launches`` from ``chain``), the ``nvidia-smi``
line, and last ``{"ok": true, "device": {...}}``.
It needs one CUDA card and the repository's ``generativeaiexamples_tpu_torch``
package beside it; without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): used for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

# Stated tolerances of the attention kernels against their plain versions
# (bf16 outputs; the kernel rounds unnormalized softmax weights to bf16
# where the plain version rounds normalized ones, and sums in another order).
DECODE_TOL = dict(atol=5e-3, rtol=2e-2)
FLASH_TOL = dict(atol=1e-2, rtol=2e-2)
# The small bf16 model's f32 logits, card kernels against CPU plain
# versions: the attention kernels' bf16 roundings carried through two
# layers, the head and the final norm (logits of magnitude up to ~2).
REFERENCE_TOL = dict(atol=5e-2, rtol=2e-2)
# BERT in bf16, card against CPU on the same weights: cuBLAS and the CPU's
# GEMM round bf16 results after sums in other orders, carried through two
# layers (unit-norm embeddings; rerank logits of magnitude ~0.5).
BERT_TOL = dict(atol=2e-2, rtol=2e-2)
# A query embedded alone (a batch of 4) and inside a batch of 32, 24 bf16
# layers: cuBLAS may choose another algorithm, and order of sums, per M.
EMBED_TOL = dict(atol=1e-2, rtol=0)
# Score gap below which two ranks may swap between the card's f32 sums of
# bf16 products and an f64 brute force over the same bf16 values (a sum of
# 1024 products of unit vectors in f32 is off by ~1e-6).
RANK_EPS = 1e-4

REPLACES = {
    "qmm": "generativeaiexamples_tpu/ops/qmm.py:264",
    "decode_attention": "generativeaiexamples_tpu/ops/decode_attention.py:689",
    "flash_attention": "generativeaiexamples_tpu/ops/flash_attention.py:126",
    "paged_decode_attention": "generativeaiexamples_tpu/ops/decode_attention.py:1030",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n_variants: int, iters: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` launches, cycling over
    ``n_variants`` input copies so the inputs do not sit in the 50 MB L2.
    With ``graph`` the launches are captured into one CUDA graph and timed
    as its replay: the device's time alone, where a short kernel would
    otherwise be timed at the host's launch rate."""
    import torch

    for i in range(warmup):
        fn(i % n_variants)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(i % n_variants)
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    else:
        def run():
            for i in range(iters):
                fn(i % n_variants)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    """Input copies to cycle so the working set exceeds L2 several times."""
    return max(1, min(8, math.ceil(160e6 / max(nbytes, 1))))


def tolerance_use(out, ref, atol: float, rtol: float) -> float:
    """Largest |out - ref| / (atol + rtol * |ref|): below 1 passes, and the
    distance from 1 is the margin."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def _short_name(mangled: str) -> str:
    """``qmm_decode<32,1>`` from an Itanium-mangled kernel name: the last
    length-prefixed identifier of the nested name, then its integer
    template arguments."""
    import re

    i, name = 3 if mangled.startswith("_ZN") else 2, None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if name is None:
        return mangled[:60]
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[i:])
    return name + (f"<{','.join(re.findall(r'L[a-z](\d+)E', args.group(1)))}>" if args else "")


def ptxas_summary(log: str) -> dict:
    """Registers, shared memory and spills per kernel function from
    ``nvcc -Xptxas -v`` output, keyed by a short name (``qmm_decode<32,1>``)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = _short_name(entry.group(1))
            out[name] = ""
        elif name and ("spill" in line or "Used" in line):
            out[name] = (out[name] + "; " if out[name] else "") + line.split(":", 1)[-1].strip()
    return out


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


QMM_PROJECTIONS = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w_gu", 4096, 28672), ("w_down", 14336, 4096))
QMM_TIMED_M = (32, 256, 2048)  # a decode step, a warm chunk, a cold batch
QMM_CHECKED_M = (1, 33, 65)  # the designs' edges, checked bit for bit only


def achieved(nbytes: float, ops: float, ms: float, by: str) -> dict:
    """What a kernel reached, in the unit of what bounds it."""
    if by == "bytes":
        return {"achieved_gb_per_s": nbytes / ms / 1e6}
    return {"achieved_tops": ops / ms / 1e9}


def check_qmm(torch, dev, log):
    """K1 at Llama-3-8B's four projections: bit for bit against its plain
    version at every M of QMM_TIMED_M and QMM_CHECKED_M, timed at
    QMM_TIMED_M beside its bound, the plain version and ``torch._int_mm``.
    Returns the summary entry (one decode step's four projections at
    M=32) with the layer's sums at each timed M."""
    from generativeaiexamples_tpu_torch.ops import qmm

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for m in QMM_TIMED_M + QMM_CHECKED_M:
        timed = m in QMM_TIMED_M
        for name, k, n in QMM_PROJECTIONS:
            wbytes = n * k
            nv = copies_for(wbytes + m * k) if timed else 1
            ws = [torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gen) for _ in range(nv)]
            wscale = torch.rand(n, device=dev, generator=gen) * 1e-3 + 1e-4
            xs = [torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
            qs = [qmm.quantize_activations(x) for x in xs]
            out = qmm.qmm_cuda(qs[0][0], qs[0][1], ws[0], wscale, n, torch.bfloat16)
            again = qmm.qmm_cuda(qs[0][0], qs[0][1], ws[0], wscale, n, torch.bfloat16)
            ref = qmm.qmm_plain(qs[0][0], qs[0][1], ws[0], wscale, n, torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                diff = (out.float() - ref.float()).abs().max().item()
                raise AssertionError(f"qmm {name} M={m}: kernel differs from plain (max {diff})")
            if not torch.equal(out, again):
                raise AssertionError(f"qmm {name} M={m}: two calls in a row differ")
            plan = qmm.qmm_plan(m, n, k)
            if not timed:
                emit("kernel", kernel="qmm", proj=name, m=m, k=k, n=n, design=plan.design, bitwise_equal=True)
                del ws, xs, qs, out, again, ref
                continue
            # Kernel and library call timed as graph replays (device time;
            # a 5 µs product launched from Python is host-bound), and the
            # kernel also eagerly, at the rate the host can launch it.
            iters = 20 if m <= 256 else 10
            k_ms = time_ms(lambda i: qmm.qmm_cuda(qs[i][0], qs[i][1], ws[i], wscale, n, torch.bfloat16), nv, iters,
                           graph=True)
            eager_ms = time_ms(lambda i: qmm.qmm_cuda(qs[i][0], qs[i][1], ws[i], wscale, n, torch.bfloat16), nv,
                               iters)
            p_ms = time_ms(lambda i: qmm.qmm_plain(qs[i][0], qs[i][1], ws[i], wscale, n, torch.bfloat16), nv, 3, 1)
            try:
                wt = [w.t() for w in ws]
                lib_ms = time_ms(lambda i: torch._int_mm(qs[i][0], wt[i]), nv, iters, graph=True)
            except RuntimeError as exc:  # the yardstick only; the port never calls it
                log.append(f"_int_mm {name} M={m}: {exc}")
                lib_ms = None
            nbytes, ops = m * k + n * k + m * 4 + n * 4 + m * n * 2, 2.0 * m * n * k
            b_ms, b_by = bound(nbytes, ops, INT8_OPS)
            row = dict(proj=name, m=m, k=k, n=n, design=plan.design, grid=list(plan.grid), split=plan.split,
                       tile_n=plan.tile_n,
                       ms=k_ms, eager_ms=eager_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / k_ms, **achieved(nbytes, ops, k_ms, b_by), max_abs_err=0.0,
                       bytes=nbytes, ops=ops)
            rows.append(row)
            emit("kernel", kernel="qmm", **row)
            del ws, xs, qs, out, again, ref
            torch.cuda.empty_cache()
    layers = {}
    for m in QMM_TIMED_M:
        sel = [r for r in rows if r["m"] == m]
        lib = [r["library_ms"] for r in sel]
        layer = dict(ms=sum(r["ms"] for r in sel), eager_ms=sum(r["eager_ms"] for r in sel),
                     plain_ms=sum(r["plain_ms"] for r in sel),
                     library_ms=None if None in lib else sum(lib), bound_ms=sum(r["bound_ms"] for r in sel),
                     bound_by="bytes" if all(r["bound_by"] == "bytes" for r in sel) else "operations")
        layer["bound_share"] = layer["bound_ms"] / layer["ms"]
        layer.update(achieved(sum(r["bytes"] for r in sel), sum(r["ops"] for r in sel), layer["ms"],
                              layer["bound_by"]))
        emit("kernel", kernel="qmm", proj="layer (four projections)", m=m, **layer)
        layers[m] = layer
    # The summary entry: one decode step's four projections of one layer
    # at batch 32 (each is one launch; a step makes 4 per layer).
    return dict(layers[32], max_abs_err=0.0,
                shape="one layer's wqkv+wo+w_gu+w_down at M=32 (per-shape rows in the kernel lines)",
                layer_ms_by_m={m: v["ms"] for m, v in layers.items()},
                layer_library_ms_by_m={m: v["library_ms"] for m, v in layers.items()})


class QmmShapes:
    """Records the operand shapes of every K1 launch while it is entered
    (it wraps ``qmm.qmm_cuda``, which ``q_matmul`` calls), so that
    ``check_qmm_shapes`` can hold each against the plain version."""

    def __init__(self):
        from generativeaiexamples_tpu_torch.ops import qmm

        self._qmm, self._launch, self.seen = qmm, qmm.qmm_cuda, set()

    def __enter__(self):
        def recording(xq, a_scale, w, w_scale, n, out_dtype):
            self.seen.add((xq.shape[0], xq.shape[1], w.shape[0], n, out_dtype))
            return self._launch(xq, a_scale, w, w_scale, n, out_dtype)

        self._qmm.qmm_cuda = recording
        return self

    def __exit__(self, *exc):
        self._qmm.qmm_cuda = self._launch


QMM_PLAIN_ROWS = 8192  # rows of the f64 plain product at a time


def check_qmm_shapes(torch, dev, shapes, worst_m: int) -> None:
    """K1 bit for bit against its plain version at every shape the serving
    phases launched it with, and at ``worst_m`` (the largest cold batch the
    admission budget lets through: ``max_batch`` prompts bucketed to
    ``max_len``) for each projection seen at a wide M.  Operands are full
    range int8; the plain version runs on row blocks (it is row-wise)."""
    from generativeaiexamples_tpu_torch.ops import qmm

    shapes = set(shapes) | {(worst_m, k, n_pad, n, dt) for m, k, n_pad, n, dt in shapes if m > qmm.DECODE_MAX_M}
    gen = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    for m, k_pad, n_pad, n, dtype in sorted(shapes, key=lambda s: s[:4]):
        w = torch.randint(-127, 128, (n_pad, k_pad), dtype=torch.int8, device=dev, generator=gen)
        w_scale = torch.rand(n_pad, device=dev, generator=gen) * 1e-3 + 1e-4
        xq = torch.randint(-127, 128, (m, k_pad), dtype=torch.int8, device=dev, generator=gen)
        a_scale = torch.rand(m, 1, device=dev, generator=gen) * 1e-2 + 1e-3
        out = qmm.qmm_cuda(xq, a_scale, w, w_scale, n, dtype)
        for r in range(0, m, QMM_PLAIN_ROWS):
            ref = qmm.qmm_plain(xq[r:r + QMM_PLAIN_ROWS], a_scale[r:r + QMM_PLAIN_ROWS], w, w_scale, n, dtype)
            if not torch.equal(out[r:r + QMM_PLAIN_ROWS], ref):
                diff = (out[r:r + QMM_PLAIN_ROWS].float() - ref.float()).abs().max().item()
                raise AssertionError(f"qmm M={m} K={k_pad} N={n}: kernel differs from plain at rows {r}+ (max {diff})")
        del w, xq, out, ref
    torch.cuda.empty_cache()
    ms = sorted({s[0] for s in shapes})
    emit("kernel", kernel="qmm", check="every serving shape", shapes=len(shapes), m=ms, worst_m=worst_m,
         designs=sorted({qmm.qmm_plan(m, 4096, 4096).design for m in ms}), bitwise_equal=True,
         seconds=time.perf_counter() - t0)


def check_decode(torch, dev):
    from generativeaiexamples_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(2)
    L, KH, B, T, HD, G, C = 4, 8, 32, 2048, 128, 4, 8
    window, count = 1024, 5
    q = torch.randn(B, KH * G, HD, device=dev, generator=gen).to(torch.bfloat16)
    k8 = torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=gen)
    v8 = torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=gen)
    ks = (torch.rand(L, KH, B, T, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16)
    vs = (torch.rand(L, KH, B, T, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16)
    ab = (
        torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=gen),
        torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=gen),
        (torch.rand(L, KH, B, C, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
        (torch.rand(L, KH, B, C, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
    )
    lengths = torch.randint(1, window - C, (B,), device=dev, generator=gen, dtype=torch.int32)
    lengths[0] = 0  # an empty lane
    lengths[1] = T - 1  # a lane pinned at max_len - 1: read only up to window
    lengths[2] = window
    summary = None
    for with_ab in (False, True):
        append = (*ab, count) if with_ab else None
        out = da.decode_attention_cuda(q, k8, v8, ks, vs, 1, lengths, append, window)
        ref = da.decode_gqa_attention_plain(q, k8, v8, ks, vs, 1, lengths, append, window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        use = tolerance_use(out, ref, **DECODE_TOL)
        torch.testing.assert_close(out, ref, **DECODE_TOL)
        if not with_ab and out[0].any():
            raise AssertionError("decode_attention: an empty lane must give exact zeros")
        again = da.decode_attention_cuda(q, k8, v8, ks, vs, 1, lengths, append, window)
        if not torch.equal(out, again):
            raise AssertionError("decode_attention: two calls in a row differ")
        k_ms = time_ms(lambda i: da.decode_attention_cuda(q, k8, v8, ks, vs, i, lengths, append, window), L, 50,
                       graph=True)
        eager_ms = time_ms(lambda i: da.decode_attention_cuda(q, k8, v8, ks, vs, i, lengths, append, window), L, 50)
        p_ms = time_ms(lambda i: da.decode_gqa_attention_plain(q, k8, v8, ks, vs, i, lengths, append, window=window), L, 5, 1)
        slots = lengths.clamp(0, window).sum().item() + (B * count if with_ab else 0)
        nbytes = slots * KH * (2 * HD + 2 * 2) + q.numel() * 2 * 2 + B * 4
        b_ms, b_by = bound(nbytes, 4.0 * slots * G * KH * HD, BF16_FLOPS)
        row = dict(append=with_ab, b=B, t=T, window=window, splits=da.decode_plan(B, KH), ms=k_ms, eager_ms=eager_ms,
                   plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / k_ms,
                   max_abs_err=err, tolerance=DECODE_TOL, tolerance_use=use)
        if with_ab:
            row["splits_sweep_ms"] = decode_splits_sweep(torch, da, q, k8, v8, ks, vs, lengths, append, window, L)
        emit("kernel", kernel="decode_attention", **row)
        if with_ab:
            summary = dict(row, shape=f"B={B} KH={KH} G={G} T={T} window={window} append C={C} count={count}")
    del k8, v8, ks, vs, ab
    torch.cuda.empty_cache()
    return summary


def decode_splits_sweep(torch, da, q, k8, v8, ks, vs, lengths, append, window, n_layers) -> dict:
    """K2's graph-timed ms at each split count, the plan's choice replaced
    for the sweep only (``BLOCKS_PER_SM`` in ``ops/decode_attention.py``
    comes from it); each must still match the plain version."""
    planner = da.decode_plan
    out = {}
    ref = da.decode_gqa_attention_plain(q, k8, v8, ks, vs, 1, lengths, append, window=window)
    try:
        for splits in (1, 2, 4, 8):
            da.decode_plan = lambda *_a, _s=splits: _s
            torch.testing.assert_close(da.decode_attention_cuda(q, k8, v8, ks, vs, 1, lengths, append, window), ref,
                                       **DECODE_TOL)
            out[splits] = time_ms(lambda i: da.decode_attention_cuda(q, k8, v8, ks, vs, i, lengths, append, window),
                                  n_layers, 50, graph=True)
    finally:
        da.decode_plan = planner
    return out


def paged_mirror(torch, cache, own, pt, gen, share=None):
    """Pool leaves and a table holding each row's first ``own[b]`` slots
    (whole pages) of the contiguous ``cache`` on pool pages taken in a
    shuffled order; the rest of each table row is the garbage page 0.
    ``share=(src, dst, m)`` points row dst's first m entries at row src's
    pages (the contiguous rows must agree there)."""
    k8 = cache[0]
    n_layers, n_kv, b, t, _ = k8.shape
    n_slot = -(-t // pt)
    total = b * n_slot + 1
    perm = (torch.randperm(total - 1, generator=gen) + 1).tolist()
    table = torch.zeros(b, n_slot, dtype=torch.int32)
    for r in range(b):
        n_pages = -(-own[r] // pt)
        table[r, :n_pages] = torch.tensor(perm[:n_pages], dtype=torch.int32)
        del perm[:n_pages]
    if share is not None:
        src, dst, m = share
        table[dst, :m] = table[src, :m]
    leaves = [torch.zeros((n_layers, n_kv, total * pt) + tuple(c.shape[4:]), dtype=c.dtype, device=c.device)
              for c in cache]
    for r in range(b):
        n = -(-own[r] // pt) * pt
        pos = torch.arange(n)
        flat = (table[r, pos // pt].long() * pt + pos % pt).to(k8.device)
        for leaf, c in zip(leaves, cache):
            leaf[:, :, flat] = c[:, :, r, :n]
    return leaves, table.to(k8.device)


def check_paged_decode(torch, dev):
    """K3 at the serving shapes, at page sizes 16, 32, 64 and 128: within
    DECODE_TOL of its plain version, and equal bit for bit to K2 on the
    same content mirrored into a contiguous cache."""
    from generativeaiexamples_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(6)
    L, KH, B, T, HD, G, C = 4, 8, 32, 2048, 128, 4, 8
    window, count = 1024, 5
    q = torch.randn(B, KH * G, HD, device=dev, generator=gen).to(torch.bfloat16)
    cache = [
        torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=gen),
        torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=gen),
        (torch.rand(L, KH, B, T, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
        (torch.rand(L, KH, B, T, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
    ]
    ab = (
        torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=gen),
        torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=gen),
        (torch.rand(L, KH, B, C, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
        (torch.rand(L, KH, B, C, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
    )
    lengths = torch.randint(1, window - C, (B,), device=dev, generator=gen, dtype=torch.int32)
    lengths[0] = 0  # an empty lane
    lengths[1] = T - 1  # pinned at max_len - 1: owns only its window's pages
    lengths[2] = window
    lengths[3], lengths[4] = 600, 700  # rows sharing their first pages
    for c in cache:
        c[:, :, 4] = c[:, :, 3]
    own = lengths.clamp(max=window).tolist()
    shared_tokens = 384
    summary = None
    for pt in (16, 32, 64, 128):
        leaves, table = paged_mirror(torch, cache, own, pt, torch.Generator().manual_seed(pt),
                                     share=(3, 4, shared_tokens // pt))
        for with_ab in ((False, True) if pt == 64 else (True,)):
            append = (*ab, count) if with_ab else None
            out = da.paged_decode_attention_cuda(q, *leaves, 1, lengths, table, append, window, pt)
            ref = da.paged_decode_gqa_attention_plain(q, *leaves, 1, lengths, table, append,
                                                      window=window, page_tokens=pt)
            k2 = da.decode_attention_cuda(q, *cache, 1, lengths, append, window)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            use = tolerance_use(out, ref, **DECODE_TOL)
            torch.testing.assert_close(out, ref, **DECODE_TOL)
            if not torch.equal(out, k2):
                diff = (out.float() - k2.float()).abs().max().item()
                raise AssertionError(f"paged_decode_attention page {pt}: differs from K2 on mirrored content ({diff})")
            if not with_ab and out[0].any():
                raise AssertionError("paged_decode_attention: an empty lane must give exact zeros")
            k_ms = time_ms(lambda i: da.paged_decode_attention_cuda(q, *leaves, i, lengths, table, append, window, pt),
                           L, 50, graph=True)
            eager_ms = time_ms(lambda i: da.paged_decode_attention_cuda(q, *leaves, i, lengths, table, append, window,
                                                                        pt), L, 50)
            k2_ms = time_ms(lambda i: da.decode_attention_cuda(q, *cache, i, lengths, append, window), L, 50,
                            graph=True)
            p_ms = time_ms(lambda i: da.paged_decode_gqa_attention_plain(
                q, *leaves, i, lengths, table, append, window=window, page_tokens=pt), L, 5, 1)
            # Bytes: each distinct pool slot the rows read, once (rows 3 and
            # 4 share pages), each row's table entries, the append buffer,
            # q and the output.  Operations: every row's visible slots.
            visible = lengths.clamp(0, window)
            read = torch.arange(window, device=dev)[None, :] < visible[:, None]
            pool_slots = da.paged_window_index(table, window, pt)[read].unique().numel()
            ab_slots = B * count if with_ab else 0
            table_entries = ((visible + pt - 1) // pt).sum().item()
            nbytes = (pool_slots + ab_slots) * KH * (2 * HD + 2 * 2) + table_entries * 4 + q.numel() * 2 * 2 + B * 4
            b_ms, b_by = bound(nbytes, 4.0 * (visible.sum().item() + ab_slots) * G * KH * HD, BF16_FLOPS)
            row = dict(page_tokens=pt, append=with_ab, b=B, max_len=T, window=window, pool_slots_read=pool_slots,
                       row_slots_read=visible.sum().item(), splits=da.decode_plan(B, KH), ms=k_ms,
                       eager_ms=eager_ms, k2_ms=k2_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / k_ms, max_abs_err=err,
                       tolerance=DECODE_TOL, tolerance_use=use, equal_to_k2=True)
            emit("kernel", kernel="paged_decode_attention", **row)
            if pt == 64 and with_ab:
                summary = dict(row, shape=f"B={B} KH={KH} G={G} max_len={T} window={window} page {pt}, shuffled "
                                          f"pages, append C={C} count={count}")
        del leaves, table
        torch.cuda.empty_cache()
    del cache, ab
    torch.cuda.empty_cache()
    return summary


def check_flash(torch, dev, log):
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    b, s, nq, nkv, hd = 8, 256, 32, 8, 128
    nv = 4
    qs = [torch.randn(b, s, nq, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    kks = [torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    vvs = [torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    lengths = torch.tensor([256, 200, 131, 256, 180, 140, 256, 160], dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    pos[5, 140:] = -1  # padded query rows
    out = fa.flash_attention_cuda(qs[0], kks[0], vvs[0], pos, lengths)
    ref = fa.flash_gqa_attention_plain(qs[0], kks[0], vvs[0], pos, lengths)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    use = tolerance_use(out, ref, **FLASH_TOL)
    torch.testing.assert_close(out, ref, **FLASH_TOL)
    if out[5, 140:].any():
        raise AssertionError("flash_attention: padded query rows must give exact zeros")
    if not torch.equal(out, fa.flash_attention_cuda(qs[0], kks[0], vvs[0], pos, lengths)):
        raise AssertionError("flash_attention: two calls in a row differ")
    k_ms = time_ms(lambda i: fa.flash_attention_cuda(qs[i], kks[i], vvs[i], pos, lengths), nv, 20, graph=True)
    eager_ms = time_ms(lambda i: fa.flash_attention_cuda(qs[i], kks[i], vvs[i], pos, lengths), nv, 20)
    p_ms = time_ms(lambda i: fa.flash_gqa_attention_plain(qs[i], kks[i], vvs[i], pos, lengths), nv, 3, 1)
    # SDPA with a boolean mask of the same visibility (its fully masked rows
    # would be NaN where the kernel gives 0; none are fully masked here
    # except the padded rows, whose outputs are not compared).
    t_idx = torch.arange(s, device=dev)
    mask = (t_idx[None, None, :] <= pos[:, :, None]) & (t_idx[None, None, :] < lengths[:, None, None])
    mask = mask[:, None]
    qt = [x.transpose(1, 2) for x in qs]
    kt = [x.transpose(1, 2) for x in kks]
    vt = [x.transpose(1, 2) for x in vvs]
    def sdpa(i):
        return F.scaled_dot_product_attention(qt[i], kt[i], vt[i], attn_mask=mask, enable_gqa=True)

    # The yardstick as graph replays like the kernel, with its eager time
    # beside; if its backend cannot be captured, eagerly over many calls.
    lib_eager_ms = time_ms(sdpa, nv, 200)
    try:
        lib_ms, lib_timing = time_ms(sdpa, nv, 20, graph=True), "graph"
    except RuntimeError as exc:
        log.append(f"SDPA graph capture failed, timed eagerly over 200 calls: {exc}")
        torch.cuda.synchronize()
        lib_ms, lib_timing = lib_eager_ms, "eager, 200 calls"
    visible = int(mask.sum().item()) * nq  # (query, key) pairs attended, all heads
    # Bytes the function needs: q only for real rows (padded rows' outputs
    # are 0 by contract), K/V only up to min(kv_len, max position + 1) per
    # row, the whole output written once, positions and lengths.
    kv_slots = int(torch.minimum(lengths, pos.max(dim=1).values + 1).clamp_min(0).sum().item())
    q_rows = int((pos >= 0).sum().item())
    nbytes = (q_rows * nq * hd + kv_slots * 2 * nkv * hd + b * s * nq * hd) * 2 + b * s * 4 + b * 4
    b_ms, b_by = bound(nbytes, 4.0 * visible * hd, BF16_FLOPS)
    row = dict(b=b, s=s, nq=nq, nkv=nkv, ms=k_ms, eager_ms=eager_ms, plain_ms=p_ms, library_ms=lib_ms,
               library_timing=lib_timing, library_eager_ms=lib_eager_ms, beats_library=k_ms < lib_ms,
               bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / k_ms, max_abs_err=err, tolerance=FLASH_TOL,
               tolerance_use=use)
    emit("kernel", kernel="flash_attention", **row)
    return dict(row, shape=f"b={b} s={s} n_q={nq} n_kv={nkv} hd={hd}, ragged kv lengths, padded rows")


# ---------------------------------------------------------------------------
# small reference model: kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------


def check_reference(torch, dev):
    """A small bf16 model (head_dim 128) through the kernels on the card and
    through the plain versions on the CPU: cold-prefill logits, then the
    logits of one append-buffer decode step from the CPU's cache, each
    within REFERENCE_TOL element by element."""
    from generativeaiexamples_tpu_torch.engine.decode import prepare_params
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=8, n_kv_heads=2, head_dim=128,
                            d_ff=1024, max_seq_len=256, rope_theta=10000.0, kv_dtype="int8")
    gen = torch.Generator().manual_seed(4)
    params_cpu = prepare_params(cfg, None, device="cpu", generator=gen)

    def to(x, d):
        if isinstance(x, dict):
            return {k: to(v, d) for k, v in x.items()}
        if hasattr(x, "__dataclass_fields__"):
            return type(x)(**{f: to(getattr(x, f), d) for f in x.__dataclass_fields__})
        return x.to(d) if isinstance(x, torch.Tensor) else x

    params_dev = to(params_cpu, dev)
    b, s = 4, 48
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    lengths = torch.tensor([48, 30, 17, 40], dtype=torch.int32)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    prefill, caches = {}, {}
    for d, params in (("cpu", params_cpu), (dev, params_dev)):
        cache = llama.init_kv_cache(cfg, b, 128, device=d)
        hidden, caches[d] = llama.forward(params, cfg, tokens.to(d), pos.to(d), cache, lengths.to(d),
                                          cold_prefill=True)
        prefill[d] = llama.logits(params, hidden).cpu()
    first = prefill["cpu"][torch.arange(b), lengths.long() - 1].argmax(-1)
    decode = {}
    for d, params in (("cpu", params_cpu), (dev, params_dev)):
        ab_shape = (cfg.n_layers, cfg.n_kv_heads, b, 1, cfg.head_dim)
        ab = tuple(torch.zeros(shape, dtype=dt, device=d) for shape, dt in (
            (ab_shape, torch.int8), (ab_shape, torch.int8),
            (ab_shape[:-1], torch.bfloat16), (ab_shape[:-1], torch.bfloat16)))
        cache = tuple(c.to(d) for c in caches["cpu"])
        hidden, _, _ = llama.forward(params, cfg, first[:, None].to(d), lengths[:, None].to(d), cache,
                                     lengths.to(d), kv_bucket=64, append_cache=(ab, 0))
        decode[d] = llama.logits(params, hidden).cpu()
    valid = torch.arange(s)[None, :] < lengths[:, None]
    fields = {}
    for phase, out, ref in (("prefill", prefill[dev][valid], prefill["cpu"][valid]),
                            ("decode", decode[dev], decode["cpu"])):
        if not torch.isfinite(out).all():
            raise AssertionError(f"reference: non-finite {phase} logits on the card")
        torch.testing.assert_close(out, ref, **REFERENCE_TOL)
        fields[f"{phase}_logit_max_abs_err"] = (out - ref).abs().max().item()
        fields[f"{phase}_tolerance_use"] = tolerance_use(out, ref, **REFERENCE_TOL)
    fields["logit_scale"] = prefill["cpu"][valid].abs().max().item()
    emit("reference", config="d_model=512 n_layers=2 heads=8/2 head_dim=128 bf16", tolerance=REFERENCE_TOL,
         **fields)


# ---------------------------------------------------------------------------
# the retrieval side: BERT, the embedder, the exact vector store
# ---------------------------------------------------------------------------


def bert_flops(cfg, b: int, s: int) -> float:
    """One forward's multiply-adds x 2: the four projections and the MLP of
    every token, and QK^T and PV over every (query, key) pair."""
    per_layer = 2.0 * b * s * (4 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff) + 4.0 * b * s * s * cfg.d_model
    return cfg.n_layers * per_layer


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def check_bert(torch, dev) -> None:
    """BERT at arctic-embed-l's width, 2 layers, bf16, random weights from
    seed 0, on the card and on the CPU with the same weights: the pooled
    embeddings of a padded batch, and the rerank scores of the same batch
    with two segments, within BERT_TOL."""
    from generativeaiexamples_tpu_torch.models import bert

    cfg = bert.arctic_embed_l(n_layers=2)
    gen = torch.Generator().manual_seed(0)
    params, head = bert.init_params(cfg, gen, "cpu"), bert.init_rerank_head(cfg, gen, "cpu")
    lengths = [512, 300, 129, 1, 77, 512, 40, 256]
    tokens = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    mask = (torch.arange(512)[None, :] < torch.tensor(lengths)[:, None]).long()
    types = (torch.arange(512)[None, :] >= torch.tensor(lengths)[:, None] // 2).long() * mask
    out = {}
    with torch.inference_mode():
        for d, p, h in (("cpu", params, head), ("card", _to(params, dev), _to(head, dev))):
            args = (tokens.to(p["tok_embed"].device), mask.to(p["tok_embed"].device))
            out[d] = (bert.embed(p, cfg, *args).cpu(),
                      bert.rerank_score(p, h, cfg, *args, types.to(p["tok_embed"].device)).cpu())
    fields = {}
    for i, what in enumerate(("embedding", "rerank_score")):
        got, ref = out["card"][i], out["cpu"][i]
        if not torch.isfinite(got).all():
            raise AssertionError(f"bert: non-finite {what} on the card")
        torch.testing.assert_close(got, ref, **BERT_TOL)
        fields[f"{what}_max_abs_err"] = (got - ref).abs().max().item()
        fields[f"{what}_tolerance_use"] = tolerance_use(got, ref, **BERT_TOL)
    fields["rerank_score_scale"] = out["cpu"][1].abs().max().item()
    emit("bert", config="arctic-embed-l width (d 1024, 16 heads, d_ff 4096), 2 layers, bf16, seed 0",
         batch="8 x 512, lengths " + ",".join(map(str, lengths)), tolerance=BERT_TOL, **fields)


def _texts(seed: int, n: int, n_chars: int) -> list:
    import random

    rng = random.Random(seed)
    return ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz ,.") for _ in range(n_chars)) for _ in range(n)]


def _unit_rows(torch, vecs) -> bool:
    v = torch.as_tensor(vecs)
    return bool(torch.isfinite(v).all()) and bool(((v.norm(dim=1) - 1).abs() < 1e-3).all())


def embed_phase(torch, dev):
    """arctic-embed-l at full depth through the port's embedder.  Returns
    the embedder (``serve`` uses it) and its queries."""
    from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
    from generativeaiexamples_tpu_torch.models import bert

    cfg = bert.arctic_embed_l()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    embedder = GPUEmbedder(cfg, device=dev)
    n_params = sum(v.numel() for v in embedder.params.values() if torch.is_tensor(v)) + sum(
        v.numel() for v in embedder.params["layers"].values())
    params_gb = (torch.cuda.memory_allocated(dev) - mem0) / 1e9
    docs = _texts(10, 256, 510)  # the splitter's 510-token chunk: BOS + 510 bytes -> a 512 bucket
    queries = _texts(11, 32, 60)
    embedder.embed_documents(docs[:32])  # warm-up: cuBLAS handles and algorithms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    doc_vecs = embedder.embed_documents(docs)
    docs_s = time.perf_counter() - t0
    batch_vecs = embedder.embed_queries(queries)
    alone = [embedder.embed_query(q) for q in queries]
    if len(doc_vecs) != 256 or not _unit_rows(torch, doc_vecs) or not _unit_rows(torch, batch_vecs):
        raise AssertionError("embed: vectors not finite or not of unit norm to 1e-3")
    diff = (torch.tensor(alone) - torch.tensor(batch_vecs)).abs().max().item()
    torch.testing.assert_close(torch.tensor(alone), torch.tensor(batch_vecs), **EMBED_TOL)
    # One 32 x 512 forward, device time by CUDA events (median of 5).
    ids = [embedder.tokenizer.encode(t, add_bos=True) for t in docs[:32]]
    tokens = torch.tensor(ids, device=dev)
    mask = torch.ones_like(tokens)
    tokens = torch.nn.functional.pad(tokens, (0, 512 - tokens.shape[1]))
    mask = torch.nn.functional.pad(mask, (0, 512 - mask.shape[1]))
    times = []
    with torch.inference_mode():
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            bert.embed(embedder.params, cfg, tokens, mask)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    fwd_ms = sorted(times[1:])[2]
    flops = bert_flops(cfg, 32, 512)
    bound_ms = flops / BF16_FLOPS * 1e3
    emit("embed", model="arctic-embed-l", layers=cfg.n_layers, params=n_params, weights="random bf16, seed 0",
         params_device_gb=params_gb, peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         documents=len(docs), doc_tokens=512, docs_per_s=len(docs) / docs_s, embed_documents_s=docs_s,
         forward_ms_32x512=fwd_ms, forward_flops=flops, flop_bound_ms=bound_ms, bound_share=bound_ms / fwd_ms,
         forward_ms_all=times, queries=len(queries), query_alone_vs_batch_max_abs_err=diff, tolerance=EMBED_TOL,
         unit_norm=True)
    return embedder, queries


def _clustered_rows(np, rng, centres, assign, noise: float):
    """Unit rows: a unit centre plus Gaussian noise of norm ~``noise``."""
    d = centres.shape[1]
    rows = centres[assign] + rng.standard_normal((len(assign), d), dtype=np.float32) * np.float32(noise / math.sqrt(d))
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows


def _brute_top(torch, np, corpus, queries, k: int):
    """Top k+1 of an f64 scan over the bf16-rounded corpus and queries:
    (scores, rows) per query."""
    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).double().numpy()

    q = bf16(queries)
    scores = np.empty((len(q), len(corpus)), dtype=np.float64)
    for lo in range(0, len(corpus), 65536):
        scores[:, lo:lo + 65536] = q @ bf16(corpus[lo:lo + 65536]).T
    top = np.argpartition(-scores, k, axis=1)[:, : k + 1]
    order = np.argsort(-np.take_along_axis(scores, top, 1), axis=1, kind="stable")
    top = np.take_along_axis(top, order, 1)
    return np.take_along_axis(scores, top, 1), top


RETRIEVE_ROWS, RETRIEVE_DIM, RETRIEVE_QUERIES, RETRIEVE_APPEND = 1_000_000, 1024, 128, 5000


def retrieve_phase(torch, dev):
    """The exact store at 1,000,000 x 1024 bf16 rows on the card, built by
    the port's ``get_store()`` from the ``AppConfig`` defaults (the
    ``retriever`` phase's chain searches it).  Returns the store."""
    import numpy as np

    from generativeaiexamples_tpu_torch.chains import factory
    from generativeaiexamples_tpu_torch.retrieval.base import Chunk
    from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

    n, d = RETRIEVE_ROWS, RETRIEVE_DIM
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    centres = rng.standard_normal((1000, d), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    assign = rng.integers(0, 1000, n)
    corpus = np.empty((n, d), dtype=np.float32)
    for lo in range(0, n, 65536):
        corpus[lo:lo + 65536] = _clustered_rows(np, rng, centres, assign[lo:lo + 65536], 0.8)
    chunks = [Chunk(text=f"row {i}", source=f"doc{i // 1000}", id=str(i)) for i in range(n)]
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    store = factory.get_store()
    if not isinstance(store, GPUVectorStore) or store._dtype != torch.bfloat16 or store.device != dev:
        raise AssertionError(f"retrieve: get_store() gave {store!r}, not the exact bf16 store on {dev}")
    t0 = time.perf_counter()
    store.add(chunks, corpus)
    add_s = time.perf_counter() - t0
    del chunks
    corpus = store._mirror._vecs  # the same rows, held once
    # 64 planted queries (a corpus row plus small noise) and 64 fresh points.
    planted = rng.choice(n, 64, replace=False)
    queries = np.concatenate([
        _clustered_rows(np, rng, corpus, planted, 0.1),
        _clustered_rows(np, rng, centres, rng.integers(0, 1000, RETRIEVE_QUERIES - 64), 0.8),
    ])
    t0 = time.perf_counter()
    store.search_batch(queries[:1], 1)  # the first sync: the device build
    build_s = time.perf_counter() - t0
    device_gb = (torch.cuda.memory_allocated(dev) - mem0) / 1e9
    stats = store.capacity_stats()
    results = {}
    for k in (4, 10):
        hits = store.search_batch(queries, k)
        results[k] = hits
        if any(not h or h[0].chunk.id != str(int(r)) for h, r in zip(hits[:64], planted)):
            raise AssertionError(f"retrieve: a planted query's row does not rank first at top_k {k}")
    # Ids against an f64 brute force over the same bf16 values, for 16
    # queries (8 planted): equal wherever the gap below a rank exceeds RANK_EPS.
    sel = np.r_[0:8, 64:72]
    b_scores, b_rows = _brute_top(torch, np, corpus, queries[sel], 10)
    checked = 0
    score_err = 0.0
    for qi, bs, br in zip(sel, b_scores, b_rows):
        got = results[10][qi]
        score_err = max(score_err, max(abs(h.score - s) for h, s in zip(got, bs)))
        for j in range(10):
            if bs[j] - bs[j + 1] > RANK_EPS:
                checked += 1
                if {h.chunk.id for h in got[: j + 1]} != {str(int(r)) for r in br[: j + 1]}:
                    raise AssertionError(f"retrieve: query {qi} top-{j + 1} differs from the f64 brute force")
    if not checked or score_err > 1e-4:
        raise AssertionError(f"retrieve: brute-force check: {checked} ranks checked, score error {score_err}")
    timing = {k: _time_scan(torch, store, queries, k) for k in (4, 10)}
    cap, tail_cap = int(store._device_buf.shape[0]), int(store._tail_buf.shape[0])
    nbytes = (cap + tail_cap) * d * 2 + cap + tail_cap + RETRIEVE_QUERIES * d * 4
    b_ms, b_by = bound(nbytes, 2.0 * RETRIEVE_QUERIES * (cap + tail_cap) * d, BF16_FLOPS)
    # 5,000 new rows ride the tail: each found by a query planted on it.
    buf0 = store._device_buf
    new = _clustered_rows(np, rng, centres, rng.integers(0, 1000, RETRIEVE_APPEND), 0.8)
    store.add([Chunk(text=f"new {i}", source="appended", id=f"new{i}") for i in range(RETRIEVE_APPEND)], new)
    t0 = time.perf_counter()
    found = store.search_batch(_clustered_rows(np, rng, new, np.arange(RETRIEVE_APPEND), 0.1), 1)
    append_search_s = time.perf_counter() - t0
    after = store.capacity_stats()
    if [h[0].chunk.id if h else None for h in found] != [f"new{i}" for i in range(RETRIEVE_APPEND)]:
        raise AssertionError("retrieve: an appended row is not found by its planted query")
    if store._device_buf is not buf0 or after["tail_rows"] != RETRIEVE_APPEND or store._base != n:
        raise AssertionError(f"retrieve: the append rebuilt the main buffer ({after})")
    # A masked delete of one source: only the masks re-upload.
    held = (store._device_buf, store._tail_buf, store._device_valid, store._tail_valid)
    removed = store.delete_source("doc7")
    gone = store.search_batch(_clustered_rows(np, rng, corpus, np.arange(7000, 7064), 0.1), 10)
    if removed != 1000 or any(h.chunk.source == "doc7" for hits in gone for h in hits):
        raise AssertionError("retrieve: a deleted source came back")
    if store._device_buf is not held[0] or store._tail_buf is not held[1] or store._device_valid is held[2]:
        raise AssertionError("retrieve: the delete re-uploaded more than the masks")
    emit("retrieve", rows=n, dim=d, dtype="bfloat16", corpus="1000 Gaussian centres + noise, unit norm, numpy seed 0",
         generate_s=gen_s, add_s=add_s, first_sync_s=build_s, capacity=cap, tail_capacity=tail_cap,
         device_gb=device_gb, store_bytes=stats["bytes"], peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         queries=RETRIEVE_QUERIES, planted_first=True, brute_force_ranks_checked=checked,
         brute_force_max_score_err=score_err, rank_eps=RANK_EPS,
         **{f"top{k}_{key}": v for k, t in timing.items() for key, v in t.items()},
         bound_ms=b_ms, bound_by=b_by, bound_share_top4=b_ms / timing[4]["scan_ms"],
         bound_share_top10=b_ms / timing[10]["scan_ms"], appended=RETRIEVE_APPEND,
         append_found_s=append_search_s, tail_rows=after["tail_rows"], rebuilt=False,
         deleted_rows=removed, delete_uploaded="masks only", max_query_batch=store.max_query_batch)
    return store


def _time_scan(torch, store, queries, k: int) -> dict:
    """A 128-query batch: the device work (the f32 scan of main and tail,
    the masks, ``torch.topk`` of each) timed by CUDA events, median of 12,
    with the main buffer's product alone and ``torch.topk`` alone beside it;
    and ``search_batch`` whole by the host clock (median of 10), host
    selection and result assembly included."""
    from generativeaiexamples_tpu_torch.retrieval.gpu import scores_f32

    snap = store._prepared()
    Q = torch.from_numpy(queries).to(store.device)

    def device_work():
        parts = store.scan(snap, Q)
        return [torch.topk(p, k + 1, dim=1) for p in parts]

    def events(fn, n=12):
        out = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return sorted(out)[n // 2]

    device_work()
    scan_ms = events(device_work)
    Qc = Q.to(snap[0].dtype)
    product_ms = events(lambda: scores_f32(Qc, snap[0]))
    parts = store.scan(snap, Q)
    topk_ms = events(lambda: [torch.topk(p, k + 1, dim=1) for p in parts])
    del parts
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        store.search_batch(queries, k)
        host.append((time.perf_counter() - t0) * 1e3)
    return dict(scan_ms=scan_ms, product_ms=product_ms, topk_ms=topk_ms, topk_share=topk_ms / scan_ms,
                search_batch_ms=sorted(host)[5])


# ---------------------------------------------------------------------------
# the retrieval call chain built from AppConfig (Retriever, cache, ladder)
# ---------------------------------------------------------------------------

CHAIN_DOCS, CHAIN_QUERIES, CHAIN_CONCURRENT, CHAIN_LADDER, CHAIN_RERANK = 2048, 128, 32, 16, 32


class _NoFallback:
    """The store without its host fallback: the ladder's next rung is the
    stale cache."""

    def __init__(self, store):
        self._store = store

    def search_batch(self, embeddings, top_k):
        return self._store.search_batch(embeddings, top_k)

    def version(self):
        return self._store.version()


class _DeviceWork:
    """Counts BERT forwards and store scans while it is entered (each wraps
    the module-level function the path calls)."""

    def __init__(self):
        from generativeaiexamples_tpu_torch.models import bert
        from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

        self._bert, self._store_cls = bert, GPUVectorStore
        self.forwards = self.scans = 0

    def __enter__(self):
        embed, scan = self._embed, self._scan = self._bert.embed, self._store_cls.scan

        def counted_embed(*a, **k):
            self.forwards += 1
            return embed(*a, **k)

        def counted_scan(*a, **k):
            self.scans += 1
            return scan(*a, **k)

        self._bert.embed = counted_embed
        self._store_cls.scan = staticmethod(counted_scan)
        return self

    def __exit__(self, *exc):
        self._bert.embed = self._embed
        self._store_cls.scan = staticmethod(self._scan)


def _ids(hits):
    return [h.chunk.id for h in hits]


def _same_ranks(got, want, k: int, where: str) -> int:
    """``got`` (top k per query) against ``want`` (top k + 1 of the same
    candidates): equal id sets at every rank whose gap to the next score of
    ``want`` exceeds RANK_EPS, scores within 1e-4.  Returns the ranks
    checked."""
    checked = 0
    for qi, (g, w) in enumerate(zip(got, want)):
        ws = [h.score for h in w] + [-math.inf]
        if len(g) != min(k, len(w)) or any(abs(a.score - b) > 1e-4 for a, b in zip(g, ws)):
            raise AssertionError(f"retriever: {where}: query {qi} scores {[h.score for h in g]} != {ws}")
        for j in range(len(g)):
            if ws[j] - ws[j + 1] > RANK_EPS:
                checked += 1
                if set(_ids(g[: j + 1])) != set(_ids(w[: j + 1])):
                    raise AssertionError(f"retriever: {where}: query {qi} top-{j + 1} {_ids(g)} != {_ids(w)}")
    return checked


def _requests(n, route="/search"):
    from generativeaiexamples_tpu_torch.cache.log import CacheLog
    from generativeaiexamples_tpu_torch.obs.trace import RequestTrace
    from generativeaiexamples_tpu_torch.resilience.degrade import DegradeLog

    return ([DegradeLog() for _ in range(n)], [CacheLog() for _ in range(n)],
            [RequestTrace(route=route) for _ in range(n)])


def _retrieve(retriever, queries, k=None):
    """One traced ``retrieve_many``: (results, logs, cache logs, traces,
    wall ms)."""
    logs, clogs, traces = _requests(len(queries))
    t0 = time.perf_counter()
    out = retriever.retrieve_many(queries, top_k=k, degrade_logs=logs, cache_logs=clogs, traces=traces)
    return out, logs, clogs, traces, (time.perf_counter() - t0) * 1e3


def _direct(retriever, queries, fetch_k):
    """The same work by direct calls: threshold-filtered device hits."""
    vecs = retriever.embedder.embed_queries(queries)
    return [[h for h in hits if h.score >= retriever.score_threshold]
            for hits in retriever.store.search_batch(vecs, fetch_k)], vecs


def _stage_ms(traces) -> dict:
    """Each stage's ms (summed where a stage repeats) of the first trace:
    the batch's stages are shared, so every member holds the same."""
    out: dict = {}
    for s in traces[0].stages():
        key = s["stage"] + (f"_{s['attrs']['tier']}" if s.get("attrs", {}).get("tier") else "")
        out[key] = out.get(key, 0.0) + s["duration_ms"]
    return out


def _clean_logs(logs, where: str) -> None:
    marked = [log.stages() for log in logs if log]
    if marked:
        raise AssertionError(f"retriever: {where}: degraded {marked}")


def _ring_check(torch, np, dev, cfg) -> dict:
    """The semantic ring at its configured size on the card: 128 lookups
    near stored vectors (cosine ~0.99) and 128 random ones against a numpy
    f64 reference over the same f32 values."""
    from generativeaiexamples_tpu_torch.cache.core import RetrievalCache, _unit

    d, cap = cfg.embeddings.dimensions, cfg.cache.semantic_entries
    rng = np.random.default_rng(2)
    cache = RetrievalCache(d, max_entries=cfg.cache.max_entries, semantic_entries=cap,
                           similarity_threshold=cfg.cache.similarity_threshold, device=dev)
    stored = rng.standard_normal((cap + 88, d)).astype(np.float32)
    stored /= np.linalg.norm(stored, axis=1, keepdims=True)
    t0 = time.perf_counter()
    for i, v in enumerate(stored.tolist()):  # cap + 88 admits: the ring wraps
        cache.admit(f"ring {i}", 4, "rag", 0, v, [], [])
    torch.cuda.synchronize()
    admit_ms = (time.perf_counter() - t0) * 1e3 / len(stored)
    live = stored[88:]
    near = live[rng.integers(0, cap, 128)] + 0.14 / math.sqrt(d) * rng.standard_normal((128, d)).astype(np.float32)
    queries = np.concatenate([near, rng.standard_normal((128, d)).astype(np.float32)])
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    qlist = queries.tolist()
    cache.lookup_semantic_many(qlist[:8], "rag", 0)  # warm-up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cache.lookup_semantic_many(qlist, "rag", 0)
        times.append((time.perf_counter() - t0) * 1e3)
    ring = cache._ring.cpu().numpy().astype(np.float64)
    valid = cache._ring_valid.cpu().numpy()
    scored = np.stack([_unit(q) for q in qlist]).astype(np.float64)  # the vectors the cache scores
    sims = np.where(valid[None, :], scored @ ring.T, -np.inf)
    order = np.argsort(-sims, axis=1)
    checked_argmax = checked_hit = 0
    for qi, found in enumerate(got):
        best, second = sims[qi, order[qi, 0]], sims[qi, order[qi, 1]]
        slot = next(i for i, e in enumerate(cache._ring_entries) if e is found[0]) if found is not None else None
        if best - cache.similarity_threshold > RANK_EPS:
            checked_hit += 1
            if found is None:
                raise AssertionError(f"retriever: ring: query {qi} at {best:.6f} missed")
            if best - second > RANK_EPS:
                checked_argmax += 1
                if slot != order[qi, 0]:
                    raise AssertionError(f"retriever: ring: query {qi} took slot {slot}, f64 says {order[qi, 0]}")
            if abs(found[1] - best) > 1e-6:
                raise AssertionError(f"retriever: ring: query {qi} similarity {found[1]} vs f64 {best}")
        elif cache.similarity_threshold - best > RANK_EPS:
            checked_hit += 1
            if found is not None:
                raise AssertionError(f"retriever: ring: query {qi} at {best:.6f} hit")
    hits = sum(g is not None for g in got)
    if hits != 128 or checked_argmax < 128 or checked_hit != 256:
        raise AssertionError(f"retriever: ring: {hits} hits, {checked_argmax} argmaxes, {checked_hit} hit tests")
    ms = sorted(times)[2]
    return dict(ring_shape=[cap, d], ring_admit_ms_per_entry=admit_ms, ring_lookups=len(qlist), ring_hits=hits,
                ring_argmax_checked=checked_argmax,
                ring_hit_tests_checked=checked_hit, ring_lookup_ms_256=ms, ring_lookup_ms_per_query=ms / len(qlist))


def _concurrent_retrievals(np, factory, queries) -> dict:
    """``CHAIN_CONCURRENT`` requests at once through the process-wide
    micro-batcher, each with its own 2 s deadline, logs and trace."""
    from generativeaiexamples_tpu_torch.resilience.deadline import Deadline

    batcher = factory.get_retrieval_batcher()
    before = batcher.stats.snapshot()
    logs, clogs, traces = _requests(len(queries))
    lat, errors = [0.0] * len(queries), []
    start = threading.Barrier(len(queries))

    def one(i):
        start.wait()
        t0 = time.perf_counter()
        try:
            batcher.call((queries[i], 4, logs[i], clogs[i], traces[i]), deadline=Deadline.after_ms(2000),
                         trace=traces[i])
        except Exception as exc:  # reported below: the gate fails
            errors.append(f"{type(exc).__name__}: {exc}")
        lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"retriever: concurrent: {errors[:3]}")
    _clean_logs(logs, "concurrent")
    after = batcher.stats.snapshot()
    batches = after["batches_total"] - before["batches_total"]
    tiers = [c.tier or "miss" for c in clogs]
    waits = [s["duration_ms"] for tr in traces for s in tr.stages() if s["stage"] == "queue_wait"]
    if len(waits) != len(queries):
        raise AssertionError(f"retriever: concurrent: {len(waits)} queue_wait stages for {len(queries)} requests")
    return dict(concurrent_requests=len(queries), concurrent_batches=batches,
                concurrent_mean_batch=(after["batch_size_sum"] - before["batch_size_sum"]) / batches,
                concurrent_p50_ms=float(np.percentile(lat, 50)), concurrent_p95_ms=float(np.percentile(lat, 95)),
                concurrent_queue_wait_ms_p50=float(np.percentile(waits, 50)),
                concurrent_tiers={t: tiers.count(t) for t in sorted(set(tiers))})


def retriever_phase(torch, dev, store) -> None:
    """The retrieval chain as ``chains/factory.py`` builds it from the
    ``AppConfig`` defaults, over the 1M-row store of ``retrieve``: cold,
    warm, the semantic ring at full size, concurrent requests through the
    micro-batcher, the degradation ladder, and the reranker on."""
    import dataclasses

    import numpy as np

    from generativeaiexamples_tpu_torch.cache.metrics import cache_snapshot
    from generativeaiexamples_tpu_torch.chains import factory
    from generativeaiexamples_tpu_torch.core.configuration import get_config, reset_config_cache
    from generativeaiexamples_tpu_torch.resilience.faults import get_fault_injector, reset_faults
    from generativeaiexamples_tpu_torch.resilience.metrics import reset_resilience
    from generativeaiexamples_tpu_torch.retrieval.base import Chunk

    cfg = get_config()
    t_phase = time.perf_counter()
    retriever = factory.get_retriever()
    embedder, cache, k = retriever.embedder, retriever.cache, retriever.top_k
    if retriever.store is not store or retriever.reranker is not None or cache is None:
        raise AssertionError("retriever: the factory's chain is not the default one over the retrieve store")
    fields = dict(config="AppConfig defaults", embedder=f"arctic-embed-l, {embedder.cfg.n_layers} layers, "
                  f"random bf16, seed 0", top_k=k, score_threshold=retriever.score_threshold,
                  fetch_k_multiplier=retriever.fetch_k_multiplier, cache_exact_entries=cache.max_entries,
                  cache_semantic_entries=cfg.cache.semantic_entries, similarity_threshold=cache.similarity_threshold,
                  store_rows=len(store), rank_eps=RANK_EPS)

    # 2,048 documents of 510 byte tokens: rows a query finds above the
    # threshold (the 1M clustered rows score near 0 against BERT vectors).
    docs = _texts(12, CHAIN_DOCS, 510)
    t0 = time.perf_counter()
    store.add([Chunk(text=t, source=f"rag{i // 64}", id=f"rag{i}") for i, t in enumerate(docs)],
              embedder.embed_documents(docs))
    fields["docs_embed_add_s"] = time.perf_counter() - t0

    # 1. Cold: one embed, one search for 128 distinct queries.  The direct
    # calls run first (they also warm cuBLAS at these shapes).
    queries = _texts(13, CHAIN_QUERIES, 60)
    t0 = time.perf_counter()
    direct, qvecs = _direct(retriever, queries, k + 1)
    direct_ms = (time.perf_counter() - t0) * 1e3
    # How far apart random-weight embeddings lie: cosines between the
    # queries, and each query's gap between its first and second score.
    qv = np.asarray(qvecs)
    cos = (qv @ qv.T)[~np.eye(len(qv), dtype=bool)]
    gaps = np.array([h[0].score - h[1].score for h in direct if len(h) > 1])
    fields.update(query_cosine_min_max=[float(cos.min()), float(cos.max())],
                  top1_gap_min_median=[float(gaps.min()), float(np.median(gaps))])
    reset_resilience()
    with _DeviceWork() as work:
        cold, logs, _, traces, cold_ms = _retrieve(retriever, queries)
    _clean_logs(logs, "cold")
    cold_checked = _same_ranks(cold, direct, k, "cold vs direct")
    # The same arithmetic on the same inputs: the very same hits and scores.
    if [[(h.chunk.id, h.score) for h in r] for r in cold] != [[(h.chunk.id, h.score) for h in r[:k]] for r in direct]:
        raise AssertionError("retriever: cold: results are not the direct calls' hits and scores")
    stages = _stage_ms(traces)
    t0 = time.perf_counter()
    _direct(retriever, queries, k + 1)
    direct2_ms = (time.perf_counter() - t0) * 1e3
    fields.update(cold_ms=cold_ms, cold_stage_ms=stages, cold_host_ms=cold_ms - sum(stages.values()),
                  cold_forwards=work.forwards, cold_scans=work.scans, cold_ranks_checked=cold_checked,
                  cold_identical_to_direct=True,
                  direct_ms=[direct_ms, direct2_ms], retriever_overhead_ms=cold_ms - direct2_ms,
                  cold_hits_per_query=[min(len(h) for h in cold), max(len(h) for h in cold)])
    if not all(cold):
        raise AssertionError("retriever: cold: a query found nothing above the threshold")

    # 2. Warm: the same queries are exact-tier hits with no device work.
    scans0 = cache_snapshot()["semantic_scan_count"]
    with _DeviceWork() as work:
        warm, logs, clogs, traces, warm_ms = _retrieve(retriever, queries)
    _clean_logs(logs, "warm")
    ring_scans = cache_snapshot()["semantic_scan_count"] - scans0
    if [c.tier for c in clogs] != ["exact"] * len(queries) or work.forwards or work.scans or ring_scans:
        raise AssertionError(f"retriever: warm: tiers {sorted(set(c.tier for c in clogs))}, {work.forwards} "
                             f"forwards, {work.scans} scans, {ring_scans} ring scans")
    if [[(h.chunk.id, h.score) for h in r] for r in warm] != [[(h.chunk.id, h.score) for h in r] for r in cold]:
        raise AssertionError("retriever: warm: results differ from the cold pass")
    fields.update(warm_ms=warm_ms, warm_stage_ms=_stage_ms(traces), warm_forwards=0, warm_scans=0)

    # 3. The semantic ring at its configured size, against f64.
    fields.update(_ring_check(torch, np, dev, cfg))

    # 4. Concurrent requests through the process-wide micro-batcher (a
    # cleared cache: the first batch pays embed and search).
    cache.clear()
    reset_resilience()
    fields.update(_concurrent_retrievals(np, factory, _texts(14, CHAIN_CONCURRENT, 60)))

    # 5. The ladder: a store fault with the host fallback, then without it
    # over a warm cache.
    lq = _texts(15, CHAIN_LADDER, 60)
    cache.clear()
    reset_resilience()
    get_fault_injector().configure("store:error=1")
    fb, logs, _, traces, fb_ms = _retrieve(retriever, lq)
    reset_faults()
    if [log.stages() for log in logs] != [["index_fallback"]] * len(lq):
        raise AssertionError(f"retriever: store fault: marks {[log.stages() for log in logs]}")
    want, _ = _direct(retriever, lq, k + 1)
    fb_checked = _same_ranks(fb, want, k, "index_fallback vs device search")
    # The fallback alone at 1M rows, on 16 queries planted near corpus rows
    # (the BERT vectors' top scores lie closer together than RANK_EPS).
    rng = np.random.default_rng(3)
    rows = store._mirror._vecs[rng.integers(0, RETRIEVE_ROWS, CHAIN_LADDER)]
    planted = rows + 0.3 / math.sqrt(rows.shape[1]) * rng.standard_normal(rows.shape).astype(np.float32)
    planted /= np.linalg.norm(planted, axis=1, keepdims=True)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fallback = store.search_fallback(planted, 10)
        times.append((time.perf_counter() - t0) * 1e3)
    planted_checked = _same_ranks(fallback, store.search_batch(planted, 11), 10, "search_fallback vs device search")
    if planted_checked < 16:
        raise AssertionError(f"retriever: search_fallback: only {planted_checked} ranks checked")
    fields.update(fallback_ranks_checked=fb_checked, fallback_call_ms=fb_ms, fallback_stage_ms=_stage_ms(traces),
                  search_fallback_ms=sorted(times)[1], search_fallback_queries=CHAIN_LADDER, search_fallback_k=10,
                  search_fallback_ranks_checked=planted_checked, admitted_after_fallback=len(cache))
    if len(cache):
        raise AssertionError("retriever: a degraded result was admitted to the cache")
    reset_resilience()
    clean, logs, _, _, _ = _retrieve(retriever, lq)  # warm the cache at k
    _clean_logs(logs, "stale warm-up")
    get_fault_injector().configure("store:error=1")
    stale, logs, clogs, _, _ = _retrieve(dataclasses.replace(retriever, store=_NoFallback(store)), lq, 2 * k)
    reset_faults()
    if [log.stages() for log in logs] != [["cache_stale"]] * len(lq) or {c.tier for c in clogs} != {"stale"}:
        raise AssertionError(f"retriever: stale rung: marks {[log.stages() for log in logs][:2]}")
    if [_ids(h) for h in stale] != [_ids(h) for h in clean]:
        raise AssertionError("retriever: stale rung: not the cached results")
    fields.update(stale_served=len(lq))

    # 6. The reranker on (ranking.model_engine "tpu": the 24-layer arctic
    # cross-encoder, random, seeds 1 and 2) over the same store and embedder.
    os.environ["APP_RANKING_MODELENGINE"] = "tpu"
    reset_config_cache()
    factory.reset_factories(keep=("store", "embedder"))
    try:
        rr = factory.get_retriever()
        fetch_k = k * rr.fetch_k_multiplier
        rq = _texts(16, CHAIN_RERANK, 60)
        got, logs, _, traces, rr_ms = _retrieve(rr, rq)
        _clean_logs(logs, "rerank")
        cands, _ = _direct(rr, rq, fetch_k)
        pairs = [(q, h.chunk.text) for q, hs in zip(rq, cands) for h in hs]
        flat, at, want = rr.reranker.score_pairs(pairs), 0, []
        for hs in cands:
            scored = sorted(zip([flat[at + i] for i in range(len(hs))], range(len(hs))), key=lambda t: -t[0])
            want.append([hs[i].chunk.id for _, i in scored[:k]])
            at += len(hs)
        if [_ids(h) for h in got] != want:
            raise AssertionError("retriever: rerank: order differs from a direct score_pairs")
        fields.update(rerank_pairs=len(pairs), rerank_fetch_k=fetch_k, rerank_call_ms=rr_ms,
                      rerank_stage_ms=_stage_ms(traces))
        # The reranker rung: a fault serves vector-search order.
        rr.cache.clear()
        get_fault_injector().configure("reranker:error=1")
        vec, logs, _, _, _ = _retrieve(rr, lq)
        reset_faults()
        if [log.stages() for log in logs] != [["rerank"]] * len(lq):
            raise AssertionError(f"retriever: reranker fault: marks {[log.stages() for log in logs][:2]}")
        order, _ = _direct(rr, lq, fetch_k)
        if [_ids(h) for h in vec] != [_ids(h[:k]) for h in order]:
            raise AssertionError("retriever: reranker fault: not vector-search order")
        fields.update(rerank_fault_vector_order=True)
    finally:
        del os.environ["APP_RANKING_MODELENGINE"]
        reset_config_cache()
    fields["phase_s"] = time.perf_counter() - t_phase
    emit("retriever", **fields)


# ---------------------------------------------------------------------------
# serve Llama-3-8B through the port's HTTP front
# ---------------------------------------------------------------------------


def _http(method, url, body=None, headers=None, timeout=600):
    """(status, headers, body bytes) of one request, error statuses included."""
    data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def _post(url, body, timeout=600):
    status, _, raw = _http("POST", url, body, timeout=timeout)
    return status, raw.decode()


def _get(url, timeout=60):
    status, _, raw = _http("GET", url, timeout=timeout)
    return status, raw.decode()


def serve_kw(kv_layout: str) -> dict:
    """The engine server's serving settings for one KV layout."""
    from generativeaiexamples_tpu_torch.engine.scheduler import SERVING_DEFAULTS

    paged = dict(kv_layout="paged", kv_page_size=64) if kv_layout == "paged" else {}
    return dict(SERVING_DEFAULTS, **paged)


# Kernels each serving path must launch, and the decode kernel of the other
# layout, which it must not.
PATH_KERNELS = {
    "contiguous": (("qmm", "decode_attention", "flash_attention"), "paged_decode_attention"),
    "paged": (("qmm", "paged_decode_attention", "flash_attention"), "decode_attention"),
}


def make_prompts() -> dict:
    """The serve phases' prompts, the same for both layouts (byte
    tokenizer: BOS + one token per ASCII byte)."""
    import random

    rng = random.Random(0)

    def prompt(n_tokens):
        return "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ,.") for _ in range(n_tokens - 1))

    lengths = [20, 48, 140, 180, 220, 250, 450, 650]
    out = dict(warmup=prompt(24), lengths=lengths)
    out["completions"] = [prompt(n) for n in lengths]
    out["chat"] = prompt(60)
    # A 300-token prompt and four extensions by distinct 20-token suffixes:
    # 300 is not a multiple of the page size, so the boundary page is
    # shared and every extension's first write copies it.
    out["shared"] = prompt(300)
    out["extensions"] = [out["shared"] + prompt(21) for _ in range(4)]
    return out


def _complete(base, prompt, max_tokens=32):
    status, body = _post(base + "/v1/completions", {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0})
    out = json.loads(body)
    if status != 200 or not out["choices"][0]["text"]:
        raise AssertionError(f"completion of a {len(prompt) + 1}-token prompt failed: {status} {body[:300]}")
    return out


def _concurrent(base, prompts):
    results: dict[int, dict] = {}

    def one(i):
        results[i] = _complete(base, prompts[i])

    workers = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for w in workers:
        w.start()
    return workers, results


def serve_rag(torch, base: str, rag) -> dict:
    """``/v1/embeddings`` and ``/v1/ranking`` on the serving front: 32
    concurrent single queries (they must coalesce in the micro-batcher),
    one 64-passage request and one 16-passage ranking, each against a
    direct call.  Returns the phase's fields."""
    batched, reranker, queries = rag
    inner = batched._inner
    snap0 = batched.batcher.stats.snapshot()
    vectors, latency_ms, errors = {}, {}, {}

    def one(i):
        t0 = time.perf_counter()
        try:
            _, body = _post(base + "/v1/embeddings", {"input": queries[i], "input_type": "query"})
        except OSError as exc:  # reported below: the phase fails
            errors[i] = repr(exc)
            return
        latency_ms[i] = (time.perf_counter() - t0) * 1e3
        vectors[i] = json.loads(body)["data"][0]["embedding"]

    workers = [threading.Thread(target=one, args=(i,)) for i in range(len(queries))]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    if len(vectors) != len(queries):
        raise AssertionError(f"/v1/embeddings: {len(queries) - len(vectors)} query requests failed: {errors}")
    direct = torch.tensor([inner.embed_query(q) for q in queries])
    served = torch.tensor([vectors[i] for i in range(len(queries))])
    torch.testing.assert_close(served, direct, **EMBED_TOL)
    passages = _texts(12, 64, 400)
    status, body = _post(base + "/v1/embeddings", {"input": passages, "input_type": "passage"})
    docs = torch.tensor([d["embedding"] for d in json.loads(body)["data"]])
    docs_direct = torch.tensor(inner.embed_documents(passages))
    torch.testing.assert_close(docs, docs_direct, **EMBED_TOL)
    ranked = passages[:16]
    status, body = _post(base + "/v1/ranking", {"query": {"text": queries[0]}, "passages": [{"text": p} for p in ranked]})
    got = [r["index"] for r in json.loads(body)["rankings"]]
    scores = reranker.score(queries[0], ranked)
    want = sorted(range(len(ranked)), key=lambda i: -scores[i])
    # The reranker's order; two passages whose scores differ by less than
    # the card's run-to-run noise may swap.
    if sorted(got) != list(range(len(ranked))) or any(abs(scores[g] - scores[w]) > 1e-3 for g, w in zip(got, want)):
        raise AssertionError(f"/v1/ranking order {got} is not the reranker's {want}")
    _, metrics = _get(base + "/metrics")
    series = {line.split()[0]: float(line.split()[1]) for line in metrics.splitlines()
              if line.startswith("rag_") and not line.startswith("#")}
    n_req = series["rag_requests_total"] - snap0["requests_total"]
    n_batches = series["rag_batches_total"] - snap0["batches_total"]
    if n_req != len(queries) or not n_batches < len(queries):
        raise AssertionError(f"rag series: {n_req} requests in {n_batches} batches; the queries did not coalesce")
    lat = sorted(latency_ms.values())
    return dict(embed_requests=len(queries), embed_latency_p50_ms=lat[len(lat) // 2],
                embed_latency_p95_ms=lat[int(0.95 * (len(lat) - 1))], rag_batches=n_batches,
                mean_batch_size=(series["rag_embed_batch_size_sum"] - snap0["batch_size_sum"]) / n_batches,
                embed_max_abs_err=(served - direct).abs().max().item(),
                passage_max_abs_err=(docs - docs_direct).abs().max().item(),
                ranking_passages=len(ranked), ranking_equal_to_direct=True)


def make_scheduler(cfg, params, dev, kv_layout):
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler

    return Scheduler(cfg, params, device=dev, **serve_kw(kv_layout))


def serve(torch, dev, _cuda, cfg, params, prompts, kv_layout, expect=None, rag=None):
    """Serve Llama-3-8B through the port's HTTP front on one KV layout.

    Launch counts are zeroed just before the requests and read just after:
    eight concurrent completions with a streaming chat beside them, then
    the 20- and 650-token prompts each sent alone (their greedy text must
    equal ``expect``, the other layout's, when given), and on the paged
    layout a shared-prefix group.  With ``rag`` (a ``BatchedEmbedder``, a
    reranker and 32 queries) the front also serves ``/v1/embeddings`` and
    ``/v1/ranking`` (:func:`serve_rag`).  Then the engine stops and one
    decode chunk is timed, untraced.  Returns (launches, texts of the
    prompts sent alone, the chunk's timing)."""
    from generativeaiexamples_tpu_torch.engine.paged_kv import PAGE_EVENTS
    from generativeaiexamples_tpu_torch.engine.server import create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer

    paged = kv_layout == "paged"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sched = make_scheduler(cfg, params, dev, kv_layout)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built_gb = torch.cuda.memory_allocated(dev) / 1e9
    server = create_engine_app(sched, get_tokenizer("llama3-8b"), "llama3-8b", "127.0.0.1", 0,
                               embedder=rag[0] if rag else None, reranker=rag[1] if rag else None)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    sched.start()
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    phase = "serve_paged" if paged else "serve"
    try:
        _complete(base, prompts["warmup"], 4)  # first CUDA allocations, cuBLAS handles
        n_ttft0 = len(sched.stats.ttft_recent)
        snap0 = sched.stats.snapshot()
        events0 = dict(PAGE_EVENTS)
        _cuda.reset_launch_counts()
        t_wall = time.perf_counter()
        workers, results = _concurrent(base, prompts["completions"])
        status, body = _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompts["chat"]}], "max_tokens": 32,
            "temperature": 0, "stream": True})
        for w in workers:
            w.join(timeout=900)
        wall = time.perf_counter() - t_wall
        events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
        chat_text = "".join(json.loads(e)["choices"][0]["delta"].get("content", "") for e in events[:-1])
        if status != 200 or events[-1] != "[DONE]" or not chat_text:
            raise AssertionError(f"streaming chat failed: {status} {body[:300]}")
        if len(results) != len(prompts["completions"]):
            raise AssertionError("a completion did not return")
        snap1 = sched.stats.snapshot()
        n_tokens = sum(out["usage"]["completion_tokens"] for out in results.values())
        ttfts = sorted(list(sched.stats.ttft_recent)[n_ttft0:])
        # Sent alone, so the batch shapes are the same on both layouts.  The
        # shortest prompt (below the shared-prefix minimum) must also give
        # the text it gave in the batch.
        alone = {n: _complete(base, prompts["completions"][prompts["lengths"].index(n)])["choices"][0]["text"]
                 for n in (20, 650)}
        if alone[20] != results[0]["choices"][0]["text"]:
            raise AssertionError(f"re-sent prompt diverged:\n{results[0]['choices'][0]['text']!r}\n{alone[20]!r}")
        if expect is not None and alone != expect:
            raise AssertionError(f"{kv_layout} greedy text differs from the other layout's:\n{alone}\n{expect}")
        shared_fields = {}
        if paged:
            hits0 = sched.stats.snapshot()["shared_prefix_hits"]
            _complete(base, prompts["shared"])
            workers, ext = _concurrent(base, prompts["extensions"])
            for w in workers:
                w.join(timeout=900)
            if len(ext) != len(prompts["extensions"]):
                raise AssertionError("a shared-prefix completion did not return")
            shared_fields["shared_prefix_hits"] = sched.stats.snapshot()["shared_prefix_hits"] - hits0
        for path in ("/v1/models", "/health", "/metrics"):
            st, txt = _get(base + path)
            if st != 200 or not txt:
                raise AssertionError(f"{path} returned {st}")
        launches = dict(_cuda.LAUNCHES)
        designs = dict(_cuda.QMM_DESIGN_LAUNCHES)
        want, other = PATH_KERNELS[kv_layout]
        missing = [k for k in want if launches[k] == 0] + [f"qmm {d}" for d, n in designs.items() if n == 0]
        if missing or launches[other]:
            raise AssertionError(f"{kv_layout} path launches: {launches} {designs} (missing {missing}, "
                                 f"{other} must be 0)")
        rag_fields = serve_rag(torch, base, rag) if rag else {}
        snap2 = sched.stats.snapshot()
        page_events = {k: PAGE_EVENTS[k] - events0[k] for k in PAGE_EVENTS}
        if paged:
            if page_events["device_graft_dispatch"] or not page_events["host_grafts"]:
                raise AssertionError(f"paged grafts must be host-only: {page_events}")
            if not page_events["cow_copies"]:
                raise AssertionError(f"no copy-on-write on the shared boundary page: {page_events}")
            if shared_fields["shared_prefix_hits"] < 4:
                raise AssertionError(f"shared-prefix hits {shared_fields['shared_prefix_hits']} < 4")
        decode_tokens = (snap1["tokens_total"] - snap0["tokens_total"]) - (snap1["requests_total"] - snap0["requests_total"])
        decode_s = snap1["decode_s"] - snap0["decode_s"]
        sched.stop()
        pool_fields = {}
        if paged:
            # Every request has finished: dropping the parked segments must
            # leave every page but the garbage page free.
            pool = sched._pool
            pool_fields = {k: snap2[k] for k in ("kv_pages_total", "kv_pages_free", "kv_pages_parked",
                                                  "kv_pages_shared", "kv_cow_breaks", "kv_page_evictions")}
            for seg in list(sched._prefix_index.segments()):
                sched._drop_segment(seg)
            if pool.pages_free != pool.total_pages - 1 or int(pool._refcount.sum()) != 1:
                raise AssertionError(f"pages leaked: {pool.pages_free} free of {pool.total_pages}")
            pool_fields["all_free_after_drain"] = True
        emit(
            phase, model="llama3-8b", layers=cfg.n_layers, d_model=cfg.d_model, weights="random int8, seed 0",
            kv=f"int8 {kv_layout}" + (", page 64" if paged else ""), **serve_kw(kv_layout), cache_build_s=build_s,
            device_gb_after_build=built_gb, requests=len(prompts["completions"]) + 1,
            prompt_tokens=prompts["lengths"], completion_tokens=n_tokens, wall_s=wall,
            ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3 if ttfts else None,
            ttft_max_ms=ttfts[-1] * 1e3 if ttfts else None,
            tokens_per_s=n_tokens / wall, decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
            decode_chunks=snap1["decode_chunks"] - snap0["decode_chunks"],
            prefill_chunks=snap1["prefill_chunks"] - snap0["prefill_chunks"],
            launches=launches, qmm_design_launches=designs, alone_equal_to_other_layout=True if expect is not None else None,
            resend_equal=True, page_events=page_events if paged else None, **shared_fields, **pool_fields,
            **rag_fields,
            peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        )
        return launches, alone, time_chunk(torch, decode_chunk(torch, dev, sched))
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=30)
        sched._cache = sched._pool = None  # free the KV memory for the next phase


PROFILE_STEPS, PROFILE_LENGTH, PROFILE_WINDOW = 8, 512, 1024
# Device-side names of the port's kernel functions (torch.profiler keys).
PORT_KERNEL_NAMES = ("qmm_decode", "qmm_wide", "decode_kernel", "flash_kernel")


def decode_chunk(torch, dev, sched):
    """One decode chunk of PROFILE_STEPS steps with every lane live at
    PROFILE_LENGTH, as a closure over fixed inputs.  On the paged layout
    every lane first takes private pages for its window."""
    b = sched.max_batch
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, sched.cfg.vocab_size, (b,), device=dev, generator=gen, dtype=torch.int32)
    lengths = torch.full((b,), PROFILE_LENGTH, dtype=torch.int32, device=dev)
    temp = torch.zeros(b, device=dev)
    top_p = torch.ones(b, device=dev)
    top_k = torch.zeros(b, dtype=torch.int32, device=dev)
    cache_args: tuple = (sched._cache,)
    if sched._pool is not None:
        for i in range(b):
            sched._pool.make_writable(i, 0, PROFILE_LENGTH + PROFILE_STEPS + 1)
        cache_args = (sched._cache, sched._pool.device_table())

    def chunk():
        with torch.inference_mode():
            return sched._decode_chunk(sched.params, *cache_args, tokens, lengths, gen, temp, top_p, top_k,
                                       PROFILE_STEPS, PROFILE_WINDOW)

    return chunk


def time_chunk(torch, chunk) -> dict:
    """One warm-up call, then one call timed by host clock (dispatch, and
    wall to the end of its device work) and by CUDA events."""
    chunk()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    chunk()
    host_ms = (time.perf_counter() - t0) * 1e3  # dispatch time: the host's share
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    span_ms = start.elapsed_time(end)
    return dict(host_dispatch_ms=host_ms, wall_ms=wall_ms, event_span_ms=span_ms,
                ms_per_step=span_ms / PROFILE_STEPS)


def device_ms_by_name(prof) -> dict:
    """Device ms by kernel name from a torch.profiler trace (kernel-level
    events only: an operator's device time is its kernels')."""
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dt / 1e3
    return by_name


def profile_embed(torch, dev, embedder) -> None:
    """Where a 32 x 512 arctic-embed-l forward's time goes: one forward
    traced with torch.profiler, device ms by kernel name (top ten) and the
    busy share of the traced call's CUDA-event span."""
    from torch.profiler import ProfilerActivity, profile

    from generativeaiexamples_tpu_torch.models import bert

    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, 256, (32, 512), device=dev, generator=gen)
    mask = torch.ones_like(tokens)
    with torch.inference_mode():
        bert.embed(embedder.params, embedder.cfg, tokens, mask)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            bert.embed(embedder.params, embedder.cfg, tokens, mask)
            end.record()
            end.synchronize()
    span_ms = start.elapsed_time(end)
    by_name = device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit("profile_embed", what="one arctic-embed-l forward, 32 x 512, bf16, 24 layers", traced_device_ms=device_ms,
         traced_event_span_ms=span_ms, device_busy_share=device_ms / span_ms if span_ms else None,
         top_kernels_ms={k[:80]: v for k, v in top})


def profile_decode(torch, dev, cfg, params, kv_layout: str, timing: dict) -> None:
    """Where a decode chunk's time goes, on a fresh scheduler of one layout:
    the chunk traced with torch.profiler (device time by kernel name), with
    the busy share taken as the traced call's device time over that same
    call's CUDA-event span.  ``timing`` is the chunk timed untraced after
    the serve, before any trace of the run: a trace leaves the process's
    later host work slower (``PERF.md``, PR 2 run 5)."""
    from torch.profiler import ProfilerActivity, profile

    sched = make_scheduler(cfg, params, dev, kv_layout)
    try:
        chunk = decode_chunk(torch, dev, sched)
        chunk()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            chunk()
            end.record()
            end.synchronize()
    finally:
        sched._cache = sched._pool = None
    traced_span_ms = start.elapsed_time(end)
    by_name = device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # The port's own kernels, by name, whether or not they are in the top ten.
    port = {k[:80]: v for k, v in by_name.items() if any(n in k for n in PORT_KERNEL_NAMES)}
    emit(
        "profile_paged" if kv_layout == "paged" else "profile",
        what=f"one decode chunk, {PROFILE_STEPS} steps, batch {sched.max_batch} all live at {PROFILE_LENGTH}, "
             f"window {PROFILE_WINDOW}",
        **timing, traced_device_ms=device_ms, traced_event_span_ms=traced_span_ms,
        device_busy_share=device_ms / traced_span_ms if traced_span_ms else None,
        top_kernels_ms={k[:80]: v for k, v in top}, port_kernels_ms=port,
        decode_attention_ms_per_step=sum(v for k, v in port.items() if "decode_kernel" in k) / PROFILE_STEPS,
    )


# ---------------------------------------------------------------------------
# the chain server: /documents -> /search -> /generate over Llama-3-8B
# ---------------------------------------------------------------------------

CHAIN_SHORT_DOCS, CHAIN_LONG_DOCS, CHAIN_SEARCHES, CHAIN_CONCURRENT_GEN = 64, 4, 16, 8
# Short documents stay under 350 bytes, so a prompt of the RAG template
# and four of them fits the engine's 2,039-token bound (byte tokens).
CHAIN_SHORT_BYTES, CHAIN_LONG_BYTES, CHAIN_GEN_TOKENS = (200, 350), 6000, 32
CHAIN_WORDS = ("cache", "vector", "search", "engine", "token", "layer", "kernel", "batch", "store", "query",
               "answer", "prompt", "device", "memory", "stream", "server", "index", "rank", "score", "model")


def _chain_text(rng, n_bytes: int) -> str:
    out = ""
    while len(out) < n_bytes:
        out += " ".join(rng.choice(CHAIN_WORDS, int(rng.integers(4, 12)))) + ". "
    return out[:n_bytes].strip()


def _upload(base, name: str, text: str) -> float:
    """POST one text document as multipart/form-data; returns its ms."""
    boundary = "chainSmokeBoundary"
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="{name}"\r\n'
            f"Content-Type: text/plain\r\n\r\n{text}\r\n--{boundary}--\r\n").encode()
    t0 = time.perf_counter()
    status, _, raw = _http("POST", base + "/documents", body,
                           {"Content-Type": f"multipart/form-data; boundary={boundary}"})
    if status != 200:
        raise AssertionError(f"chain: upload of {name} failed: {status} {raw[:300]!r}")
    return (time.perf_counter() - t0) * 1e3


def _generate(base, query: str, kb: bool = True, max_tokens: int = CHAIN_GEN_TOKENS, headers=None) -> dict:
    """One streamed /generate: status, text, ms to the first ``data:`` line
    and to the end, ms between successive ``data:`` lines, the [DONE]
    chunk and the response headers."""
    body = {"messages": [{"role": "user", "content": query}], "use_knowledge_base": kb, "temperature": 0,
            "max_tokens": max_tokens}
    req = urllib.request.Request(base + "/generate", json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        resp = urllib.request.urlopen(req, timeout=600)
    except urllib.error.HTTPError as exc:
        return dict(status=exc.code, body=exc.read(), headers=exc.headers)
    chunks, arrivals = [], []
    with resp:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("data: "):
                arrivals.append(time.perf_counter())
                chunks.append(json.loads(line[6:]))
    wall_ms = (time.perf_counter() - t0) * 1e3
    if not chunks or chunks[-1]["choices"][0]["finish_reason"] != "[DONE]" or not chunks[-1]["id"]:
        raise AssertionError(f"chain: /generate did not end with a [DONE] chunk of this stream: {chunks[-1:]}")
    pieces = [c["choices"][0]["message"]["content"] for c in chunks[:-1]]
    return dict(status=resp.status, text="".join(pieces), pieces=pieces, done=chunks[-1],
                ttft_ms=(arrivals[0] - t0) * 1e3, wall_ms=wall_ms, headers=resp.headers,
                gaps_ms=[(b - a) * 1e3 for a, b in zip(arrivals, arrivals[1:])])


def _search(base, query: str, top_k: int) -> list:
    """One /search: its chunks.  Fails unless it is a 200 that no rung of
    the degradation ladder served."""
    status, _, raw = _http("POST", base + "/search", {"query": query, "top_k": top_k})
    body = json.loads(raw) if status == 200 else {}
    if status != 200 or body["degraded"]:
        raise AssertionError(f"chain: /search {query!r}: {status} {raw[:300]!r}")
    return body["chunks"]


def _server_timing(header: str) -> dict:
    """Server-Timing ``name;dur=ms`` entries, summed by name."""
    out: dict = {}
    for part in (header or "").split(","):
        name, _, dur = part.strip().partition(";dur=")
        if name and dur:
            out[name] = out.get(name, 0.0) + float(dur)
    return out


def _pct(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]


def check_flash_long(torch, dev) -> dict:
    """K4 at the chain's prefill shape (RAG prompts of ~2k tokens, whole and
    cold) against its plain version within FLASH_TOL."""
    from generativeaiexamples_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(9)
    b, s, nq, nkv, hd = 2, 2048, 32, 8, 128
    q = torch.randn(b, s, nq, hd, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([1931, 1702], dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    out = fa.flash_attention_cuda(q, k, v, pos, lengths)
    ref = fa.flash_gqa_attention_plain(q, k, v, pos, lengths)
    valid = pos < lengths[:, None]
    torch.testing.assert_close(out[valid], ref[valid], **FLASH_TOL)
    return dict(flash_s2048_max_abs_err=(out[valid].float() - ref[valid].float()).abs().max().item(),
                flash_s2048_tolerance_use=tolerance_use(out[valid], ref[valid], **FLASH_TOL))


def chain_phase(torch, dev, _cuda, smi: str) -> dict:
    """The chain server from ``APP_*`` defaults through ``create_app()``:
    Llama-3-8B W8A8 (random, seed 0) behind ``GPUChatLLM``, arctic-embed-l,
    the exact store, the result cache, no reranker.  Documents in over
    HTTP, searches against direct calls, /generate against the engine's
    own greedy text, concurrent streams, the other routes.  Returns the
    launches of the phase."""
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.chains import factory
    from generativeaiexamples_tpu_torch.chains.developer_rag import QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import GPUChatLLM
    from generativeaiexamples_tpu_torch.core.configuration import get_config, reset_config_cache
    from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
    from generativeaiexamples_tpu_torch.engine.scheduler import Request
    from generativeaiexamples_tpu_torch.engine.tokenizer import decode_stream
    from generativeaiexamples_tpu_torch.obs.slo import slo_health
    from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk
    from generativeaiexamples_tpu_torch.server.app import UPLOAD_DIR_ENV, create_app
    from generativeaiexamples_tpu_torch.server.schema import sanitize

    t_phase = time.perf_counter()
    fields = dict(nvidia_smi=smi, **check_flash_long(torch, dev))
    reset_config_cache()
    factory.reset_factories()
    cfg = get_config()
    os.environ[UPLOAD_DIR_ENV] = tempfile.mkdtemp(prefix="chain_uploads_")
    t0 = time.perf_counter()
    server = create_app()
    torch.cuda.synchronize()
    fields["build_s"] = time.perf_counter() - t0
    llm, retriever, store = factory.peek_chat_llm(), factory.get_retriever(), factory.get_store()
    cache, batcher, splitter = factory.get_retrieval_cache(), factory.get_retrieval_batcher(), factory.get_splitter()
    sched = llm.scheduler
    if (not isinstance(llm, GPUChatLLM) or sched.device.type != "cuda" or retriever.reranker is not None
            or cache is None or batcher is None or type(store).__name__ != "GPUVectorStore"):
        raise AssertionError("chain: create_app() did not build the default chain on the card")
    fields.update(config="APP_* defaults", llm=f"{cfg.llm.model_name} -> llama3-8b W8A8, "
                  f"{sched.cfg.n_layers} layers, random int8, seed 0",
                  engine=dict(max_batch=sched.max_batch, max_len=sched.max_len,
                              decode_chunk_size=sched.decode_chunk_size,
                              prefill_chunk_tokens=sched.prefill_chunk_tokens, prefix_cache=sched.prefix_cache,
                              kv_layout=sched.kv_layout, max_prompt_len=sched.max_prompt_len),
                  embedder=f"arctic-embed-l, {retriever.embedder.cfg.n_layers} layers, random bf16, seed 0",
                  top_k=retriever.top_k, score_threshold=retriever.score_threshold,
                  device_gb_after_build=torch.cuda.memory_allocated(dev) / 1e9)
    # What GPUChatLLM.stream receives, recorded by wrapping the class's
    # method for this phase (the server has no hook of its own).
    received: list = []
    stream = GPUChatLLM.stream

    def recording_stream(self, messages, **kw):
        received.append(list(messages))
        return stream(self, messages, **kw)

    GPUChatLLM.stream = recording_stream
    # The token ids each request receives, by request id: the server's
    # streams and the direct submission go through the scheduler's submit.
    ids_by_request: dict = {}
    submit = sched.submit

    def recording_submit(req):
        on_token, got = req.on_token, ids_by_request.setdefault(req.id, [])
        req.on_token = lambda t: (got.append(int(t)), on_token(t))
        submit(req)

    sched.submit = recording_submit
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(0)
    try:
        _cuda.reset_launch_counts()
        # 1. Ingest: 64 one-chunk documents and 4 of ~6 KB (token splitter
        # at 510/200: 508-token windows every 308 tokens).
        short = [_chain_text(rng, int(rng.integers(*CHAIN_SHORT_BYTES))) for _ in range(CHAIN_SHORT_DOCS)]
        long = [_chain_text(rng, CHAIN_LONG_BYTES) for _ in range(CHAIN_LONG_DOCS)]
        short_ms = [_upload(base, f"short{i}.txt", t) for i, t in enumerate(short)]
        long_ms = [_upload(base, f"long{i}.txt", t) for i, t in enumerate(long)]
        long_chunks = [len(splitter.split(t)) for t in long]
        rows = store.capacity_stats()["rows"]
        if rows != CHAIN_SHORT_DOCS + sum(long_chunks) or min(long_chunks) < 2:
            raise AssertionError(f"chain: {rows} rows after ingest, want {CHAIN_SHORT_DOCS} + {long_chunks}")
        fields.update(ingest_docs=len(short) + len(long), ingest_short_ms_per_doc=sum(short_ms) / len(short),
                      ingest_long_ms_per_doc=sum(long_ms) / len(long), long_doc_chunks=long_chunks,
                      store_rows_after_ingest=rows)

        # 2. /search, one query at a time, each on a cleared cache (random
        # embeddings lie within the semantic tier's 0.98 of each other),
        # against QAChatbot().document_search on a cleared cache and the
        # store's own threshold-filtered search.
        queries = [_chain_text(rng, int(rng.integers(30, 60))) for _ in range(CHAIN_SEARCHES)]
        k = retriever.top_k
        search_ms = []
        for q in queries:
            cache.clear()
            t0 = time.perf_counter()
            found = _search(base, q, k)
            search_ms.append((time.perf_counter() - t0) * 1e3)
            got = [(c["content"], c["filename"], c["score"]) for c in found]
            cache.clear()
            direct = [(h["content"], h["source"], h["score"]) for h in QAChatbot().document_search(q, k)]
            hits = store.search_batch(retriever.embedder.embed_queries([q]), k)[0]
            want = [(h.chunk.text, h.chunk.source, h.score) for h in hits if h.score >= retriever.score_threshold]
            if not got or got != direct or got != want:
                raise AssertionError(f"chain: /search {q!r}:\n{got}\n{direct}\n{want}")
        fields.update(searches=len(queries), search_ms_p50=_pct(search_ms, 0.5), search_ms_p95=_pct(search_ms, 0.95),
                      search_equal_to_direct_and_store=True)

        # 3. Deletes: the long documents go (their chunks would not fit a
        # prompt beside the template: 4 x 508 tokens), and are no longer
        # searched.
        probe = None
        for q in queries:  # a query whose top 25 holds long-document chunks
            cache.clear()
            if any(c["filename"].startswith("long") for c in _search(base, q, 25)):
                probe = q
                break
        for i in range(CHAIN_LONG_DOCS):
            status, _, raw = _http("DELETE", base + f"/documents?filename=long{i}.txt")
            if status != 200:
                raise AssertionError(f"chain: DELETE long{i}.txt: {status} {raw[:200]!r}")
        _, _, raw = _http("GET", base + "/documents")
        listed = json.loads(raw)["documents"]
        cache.clear()
        after = _search(base, probe or queries[0], 25)
        if any(n.startswith("long") for n in listed) or len(listed) != CHAIN_SHORT_DOCS or probe is None or any(
                c["filename"].startswith("long") for c in after):
            raise AssertionError(f"chain: deletes not honoured (probe {probe is not None}, listed {len(listed)})")
        fields.update(deleted_docs=CHAIN_LONG_DOCS, store_rows_after_delete=store.capacity_stats()["rows"])

        # 4. /generate, knowledge base on, greedy, 32 tokens.  Gate 1: the
        # system turn is the RAG template over the hits /search gave.  Gate
        # 2: the token ids the server's stream received are the engine's
        # for the same chat-templated ids submitted directly, and so is the
        # streamed text.  The prefix cache is off for the gate, so both go
        # through the same cold prefill.
        q = _chain_text(rng, 50)
        cache.clear()
        hits = _search(base, q, k)
        sched.prefix_cache = "off"
        received.clear()
        ids_by_request.clear()
        res = _generate(base, q)
        streamed_ids = list(ids_by_request.values())
        messages = received[-1]
        context = retriever.build_context(
            [ScoredChunk(Chunk(text=h["content"], source=h["filename"]), h["score"]) for h in hits])
        if res["status"] != 200 or messages[0] != ("system", cfg.prompts.rag_template.format(context=context)) or (
                messages[-1] != ("user", q)) or res["done"]["cache_tier"] != "exact" or res["done"]["degraded"]:
            raise AssertionError(f"chain: gate 1: the retrieved context did not reach the prompt ({res['done']})")
        ids = llm.tokenizer.apply_chat_template(messages)
        tokens, done = [], []
        sched.submit(Request(token_ids=list(ids), sampling=SamplingParams(temperature=0.0, top_p=0.7,
                             max_tokens=CHAIN_GEN_TOKENS), on_token=tokens.append, on_done=done.append,
                             eos_id=llm.tokenizer.eos_id, id="chain-direct"))
        t0 = time.perf_counter()
        while not done and time.perf_counter() - t0 < 300:
            time.sleep(0.01)
        sched.prefix_cache = "shared"
        if not done or done[0] not in ("stop", "length") or len(streamed_ids) != 1 or streamed_ids[0] != tokens:
            raise AssertionError(f"chain: gate 2: the stream's ids {streamed_ids} != the engine's {tokens} ({done})")
        # The engine's text as the server streams it: one chunk per
        # non-empty decoded piece, each sanitized as the reference's
        # Message is (a piece "<|id|>" of an id past the byte vocabulary
        # becomes an empty chunk).
        piece = decode_stream(llm.tokenizer)
        direct = [p for p in [piece(t) for t in tokens] + [piece(0, final=True)] if p]
        if [sanitize(p) for p in direct] != res["pieces"]:
            raise AssertionError(f"chain: gate 2: streamed {res['pieces']} != engine's {direct}")
        fields.update(gate_prompt_tokens=len(ids), gate_hits=len(hits), gate_context_chars=len(context),
                      gate_ttft_ms=res["ttft_ms"], gate_wall_ms=res["wall_ms"], gate_tokens=len(tokens),
                      gate_text=res["text"], gate_byte_tokens=sum(t < llm.tokenizer.vocab_size for t in tokens),
                      context_in_prompt=True, answer_ids_equal_to_engine=True, answer_equal_to_engine=True)

        # 5. Concurrent streams: 8 with the knowledge base on (fresh
        # queries, a cleared cache), then one with it off.
        cache.clear()
        snap0, rag0 = sched.stats.snapshot(), batcher.stats.snapshot()
        gen_queries = [_chain_text(rng, int(rng.integers(30, 60))) for _ in range(CHAIN_CONCURRENT_GEN)]
        results: dict = {}
        received.clear()

        def one(i):
            results[i] = _generate(base, gen_queries[i])

        workers = [threading.Thread(target=one, args=(i,)) for i in range(CHAIN_CONCURRENT_GEN)]
        t_wall = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
        wall = time.perf_counter() - t_wall
        snap1, rag1 = sched.stats.snapshot(), batcher.stats.snapshot()
        if len(results) != CHAIN_CONCURRENT_GEN or any(
                r["status"] != 200 or not r["pieces"] or r["done"]["degraded"] for r in results.values()):
            raise AssertionError(f"chain: a concurrent /generate failed or degraded: "
                                 f"{[(r['status'], r['done']['degraded']) for r in results.values()]}")
        prompt_tokens = [len(llm.tokenizer.apply_chat_template(m)) for m in received]
        off = _generate(base, gen_queries[0], kb=False)
        if off["status"] != 200 or not off["pieces"] or off["done"]["cache_tier"] or off["done"]["degraded"]:
            raise AssertionError(f"chain: /generate with the knowledge base off failed: {off}")
        ttfts = [r["ttft_ms"] for r in results.values()]
        # The stream admitted first is decoding when the others' cold batch
        # is prefilled whole: its longest gap between SSE lines, beside the
        # longest gaps of the others (a decode chunk's tokens come out
        # together), is what that prefill costs a running stream.
        first = min(results.values(), key=lambda r: r["ttft_ms"])
        later_gaps = sorted(max(r["gaps_ms"]) for r in results.values() if r is not first)
        stages = [_server_timing(r["headers"].get("Server-Timing")) for r in results.values()]
        decode_tokens = (snap1["tokens_total"] - snap0["tokens_total"]) - (snap1["requests_total"] - snap0["requests_total"])
        decode_s = snap1["decode_s"] - snap0["decode_s"]
        fields.update(
            concurrent=CHAIN_CONCURRENT_GEN, concurrent_wall_s=wall, ttft_ms_p50=_pct(ttfts, 0.5),
            ttft_ms_p95=_pct(ttfts, 0.95), ttft_ms=sorted(ttfts), stream_wall_ms=sorted(r["wall_ms"] for r in results.values()),
            first_stream_gaps_ms_top=sorted(first["gaps_ms"])[-4:],
            later_streams_max_gap_ms=[later_gaps[0], _pct(later_gaps, 0.5), later_gaps[-1]],
            decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
            tokens_per_s=(snap1["tokens_total"] - snap0["tokens_total"]) / wall,
            rag_prompt_tokens=[min(prompt_tokens), max(prompt_tokens)],
            retrieval_stage_ms={name: [_pct([s.get(name, 0.0) for s in stages], 0.5),
                                       max(s.get(name, 0.0) for s in stages)]
                                for name in ("cache_lookup", "queue_wait", "embed", "search")},
            # Random embeddings lie within the semantic tier's 0.98 of each
            # other: a batch after the first may be served from the ring.
            concurrent_cache_tiers=sorted(r["done"]["cache_tier"] for r in results.values()),
            microbatch_requests=rag1["requests_total"] - rag0["requests_total"],
            microbatch_batches=rag1["batches_total"] - rag0["batches_total"],
            kb_off_ttft_ms=off["ttft_ms"], kb_off_wall_ms=off["wall_ms"],
            kb_off_prompt_tokens=len(llm.tokenizer.apply_chat_template(received[-1])))

        # 6. The other routes.
        status, _, raw = _http("GET", base + "/health")
        health = json.loads(raw)
        status_m, _, raw = _http("GET", base + "/metrics")
        series = {line.split(" ")[0]: float(line.split(" ")[1]) for line in raw.decode().splitlines()
                  if line and not line.startswith("#")}
        # /health is "degraded" exactly while the SLO engine's fast-burn
        # rule fires (streams past /generate's 2,500 ms latency objective
        # burn its budget); every breaker must be closed.
        slo = slo_health()
        if status != 200 or health["slo"] != slo or health["status"] != ("degraded" if slo["degraded"] else "ok") or (
                set(health["breakers"].values()) != {"closed"}) or status_m != 200 or (
                series["rag_requests_total"] != batcher.stats.snapshot()["requests_total"]) or (
                series["rag_store_rows"] != store.capacity_stats()["rows"]):
            raise AssertionError(f"chain: /health {status} {health} or /metrics {status_m} disagree")
        # No rung of the degradation ladder (the LLM-only answer, the host
        # scan, ...) served a request of the phase, and no breaker opened
        # (the counters are reset at the phase's start).
        ladder = {name: v for name, v in series.items()
                  if name.startswith(("rag_degraded_total", "rag_breaker_open_total"))}
        if not ladder or any(ladder.values()):
            raise AssertionError(f"chain: the ladder served requests: {ladder}")
        late = _generate(base, _chain_text(rng, 40), headers={"X-Request-Deadline-Ms": "1"})
        unlimited = _generate(base, _chain_text(rng, 40), max_tokens=4, headers={"X-Request-Deadline-Ms": "0"})
        if late["status"] != 504 or unlimited["status"] != 200:
            raise AssertionError(f"chain: deadline 1 ms gave {late['status']}, 0 gave {unlimited['status']}")
        fields.update(health=health["status"], health_slo_firing=health["slo"]["firing"],
                      metrics_rag_requests_total=series["rag_requests_total"],
                      metrics_rag_store_rows=series["rag_store_rows"], ladder_counters_zero=len(ladder),
                      deadline_1ms_status=504,
                      deadline_0_status=200)

        # 7. Every kernel of the path launched in this phase (counts zeroed
        # after the build, before the first request).
        launches = dict(_cuda.LAUNCHES)
        if not all(launches[n] for n in ("qmm", "decode_attention", "flash_attention")) or (
                launches["paged_decode_attention"]):
            raise AssertionError(f"chain: path launches {launches}")
        fields.update(launches=launches, qmm_design_launches=dict(_cuda.QMM_DESIGN_LAUNCHES))
    finally:
        GPUChatLLM.stream = stream
        sched.submit = submit
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        factory.reset_factories()  # stops the engine's tick thread, frees the chain
        reset_config_cache()
        del os.environ[UPLOAD_DIR_ENV]
    fields["phase_s"] = time.perf_counter() - t_phase
    emit("chain", **fields)
    return launches


def main() -> int:
    # The run uses one card: only the first visible one is exposed, so the
    # device count in the last line is 1 whatever else the machine holds.
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "generativeaiexamples_tpu_torch", "csrc")):
        print("chip_smoke: the generativeaiexamples_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from generativeaiexamples_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    took = _cuda.build()
    from generativeaiexamples_tpu_torch.ops import qmm

    # Dynamic shared memory per block of each K1 design (ptxas reports
    # only static shared memory).
    qmm_smem = {f"{p.design} M={m} tile {p.tile_n}": p.smem_bytes
                for m in (1, 32, 64, 256, 2048) for p in [qmm.qmm_plan(m, 4096, 4096)]}
    emit("build", seconds=time.perf_counter() - t0, per_kernel_s=took,
         ptxas={name: ptxas_summary(log) for name, (_, log) in _cuda.BUILD_LOG.items()},
         qmm_dynamic_smem_bytes=qmm_smem)

    log: list[str] = []
    summary = {
        "qmm": check_qmm(torch, dev, log),
        "decode_attention": check_decode(torch, dev),
        "paged_decode_attention": check_paged_decode(torch, dev),
        "flash_attention": check_flash(torch, dev, log),
    }
    if log:
        emit("notes", notes=log)
    check_reference(torch, dev)
    torch.cuda.empty_cache()

    # The retrieval side, before the Llama params: BERT on card vs CPU,
    # arctic-embed-l through the embedder (kept with a reranker for
    # ``serve``), the exact store at 1M rows, and the retrieval chain over
    # it (both freed after).
    from generativeaiexamples_tpu_torch.engine.microbatch import BatchedEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker
    from generativeaiexamples_tpu_torch.models import bert

    check_bert(torch, dev)
    embedder, queries = embed_phase(torch, dev)
    store = retrieve_phase(torch, dev)
    retriever_phase(torch, dev, store)
    from generativeaiexamples_tpu_torch.chains.factory import reset_factories

    reset_factories()  # frees the chain: the 1M-row store, its embedder, the reranker
    del store
    gc.collect()
    torch.cuda.empty_cache()
    rag = (BatchedEmbedder(embedder, max_batch=32, max_wait_ms=3.0), GPUReranker(bert.arctic_embed_l(), device=dev),
           queries)

    from generativeaiexamples_tpu_torch.engine.decode import prepare_params
    from generativeaiexamples_tpu_torch.models import llama

    # Llama-3-8B at full width and depth, random int8 weights from a seed,
    # shared by both serving layouts.
    cfg = llama.llama3_8b(kv_dtype="int8")
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = prepare_params(cfg, None, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit("params", model="llama3-8b", seconds=time.perf_counter() - t0,
         device_gb=torch.cuda.memory_allocated(dev) / 1e9)
    prompts = make_prompts()
    # Every K1 shape the serving phases launch is held bit for bit against
    # the plain version after them.
    with QmmShapes() as k1_shapes:
        try:
            launches, alone, timing = serve(torch, dev, _cuda, cfg, params, prompts, "contiguous", rag=rag)
        finally:
            rag[0].close()
        del rag
        gc.collect()
        torch.cuda.empty_cache()
        paged_launches, _, paged_timing = serve(torch, dev, _cuda, cfg, params, prompts, "paged", expect=alone)
        # Each kernel's launches come from the path that runs it.
        launches["paged_decode_attention"] = paged_launches["paged_decode_attention"]
        for kv_layout, t in (("contiguous", timing), ("paged", paged_timing)):
            gc.collect()
            torch.cuda.empty_cache()
            profile_decode(torch, dev, cfg, params, kv_layout, t)
        profile_embed(torch, dev, embedder)
        del embedder, params
        gc.collect()
        torch.cuda.empty_cache()
        # The chain server builds its own engine and embedder from APP_*.
        chain_launches = chain_phase(torch, dev, _cuda, smi)
    gc.collect()
    torch.cuda.empty_cache()
    kw = serve_kw("contiguous")
    check_qmm_shapes(torch, dev, k1_shapes.seen, worst_m=kw["max_batch"] * kw["max_len"])

    kernels = []
    for name, s in summary.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"generativeaiexamples_tpu_torch/csrc/{_cuda.SOURCES[name]}",
            "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "eager_ms": s["eager_ms"], "shape": s["shape"],
            "chain_launches": chain_launches[name],
            **{k: s[k] for k in ("layer_ms_by_m", "layer_library_ms_by_m") if k in s},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
