#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. ``build``: nvcc builds the three kernels from ``csrc/`` in parallel.
3. ``kernel``: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (W8A8 matmul bitwise; the attention kernels
   within stated bf16 tolerances), with kernel, plain and library times
   and the least time the card could take (its bound).
4. ``reference``: a small bf16 model (head_dim 128) run through the
   kernels on the card and through the plain versions on the CPU: the
   cold-prefill logits and one append-buffer decode step's logits agree
   element by element within a stated tolerance.
5. ``serve``: Llama-3-8B at full width and depth (random int8 weights from
   a seed, int8 KV), served by the port's Scheduler and HTTP front on
   127.0.0.1: eight concurrent completions, a streaming chat, models,
   health and metrics.  Launch counts are zeroed just before and read just
   after; every kernel must have launched.  Then ``profile``: one decode
   chunk at batch 32 traced with torch.profiler (device time by kernel,
   the device's busy share).

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
It needs one CUDA card and the repository's ``generativeaiexamples_tpu_torch``
package beside it; without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
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

REPLACES = {
    "qmm": "generativeaiexamples_tpu/ops/qmm.py:264",
    "decode_attention": "generativeaiexamples_tpu/ops/decode_attention.py:689",
    "flash_attention": "generativeaiexamples_tpu/ops/flash_attention.py:125",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n_variants: int, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` launches, cycling over
    ``n_variants`` input copies so the inputs do not sit in the 50 MB L2."""
    import torch

    for i in range(warmup):
        fn(i % n_variants)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_variants)
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


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def check_qmm(torch, dev, log):
    from generativeaiexamples_tpu_torch.ops import qmm

    gen = torch.Generator(device=dev).manual_seed(1)
    projections = [("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w_gu", 4096, 28672), ("w_down", 14336, 4096)]
    rows = []
    for m in (32, 2048):
        for name, k, n in projections:
            wbytes = n * k
            nv = copies_for(wbytes + m * k)
            ws = [torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gen) for _ in range(nv)]
            wscale = torch.rand(n, device=dev, generator=gen) * 1e-3 + 1e-4
            xs = [torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
            qs = [qmm.quantize_activations(x) for x in xs]
            out = qmm.qmm_cuda(qs[0][0], qs[0][1], ws[0], wscale, n, torch.bfloat16)
            ref = qmm.qmm_plain(qs[0][0], qs[0][1], ws[0], wscale, n, torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                diff = (out.float() - ref.float()).abs().max().item()
                raise AssertionError(f"qmm {name} M={m}: kernel differs from plain (max {diff})")
            iters = 20 if m == 32 else 5
            k_ms = time_ms(lambda i: qmm.qmm_cuda(qs[i][0], qs[i][1], ws[i], wscale, n, torch.bfloat16), nv, iters)
            p_ms = time_ms(lambda i: qmm.qmm_plain(qs[i][0], qs[i][1], ws[i], wscale, n, torch.bfloat16), nv, 3, 1)
            try:
                wt = [w.t() for w in ws]
                lib_ms = time_ms(lambda i: torch._int_mm(qs[i][0], wt[i]), nv, iters)
            except RuntimeError as exc:  # the yardstick only; the port never calls it
                log.append(f"_int_mm {name} M={m}: {exc}")
                lib_ms = None
            b_ms, b_by = bound(m * k + n * k + m * 4 + n * 4 + m * n * 2, 2.0 * m * n * k, INT8_OPS)
            row = dict(proj=name, m=m, k=k, n=n, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)
            rows.append(row)
            emit("kernel", kernel="qmm", **row)
            del ws, xs, qs, out, ref
            torch.cuda.empty_cache()
    # The summary entry: one decode step's four projections of one layer
    # at batch 32 (each is one launch; a step makes 4 per layer).
    dec = [r for r in rows if r["m"] == 32]
    lib = [r["library_ms"] for r in dec]
    return dict(
        ms=sum(r["ms"] for r in dec), plain_ms=sum(r["plain_ms"] for r in dec),
        library_ms=None if None in lib else sum(lib), bound_ms=sum(r["bound_ms"] for r in dec),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in dec) else "operations",
        max_abs_err=0.0, shape="one layer's wqkv+wo+w_gu+w_down at M=32 (per-shape rows in the kernel lines)",
    )


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
        k_ms = time_ms(lambda i: da.decode_attention_cuda(q, k8, v8, ks, vs, i, lengths, append, window), L, 50)
        p_ms = time_ms(lambda i: da.decode_gqa_attention_plain(q, k8, v8, ks, vs, i, lengths, append, window=window), L, 5, 1)
        slots = lengths.clamp(0, window).sum().item() + (B * count if with_ab else 0)
        nbytes = slots * KH * (2 * HD + 2 * 2) + q.numel() * 2 * 2 + B * 4
        b_ms, b_by = bound(nbytes, 4.0 * slots * G * KH * HD, BF16_FLOPS)
        row = dict(append=with_ab, b=B, t=T, window=window, ms=k_ms, plain_ms=p_ms, library_ms=None,
                   bound_ms=b_ms, bound_by=b_by, max_abs_err=err, tolerance=DECODE_TOL, tolerance_use=use)
        emit("kernel", kernel="decode_attention", **row)
        if with_ab:
            summary = dict(row, shape=f"B={B} KH={KH} G={G} T={T} window={window} append C={C} count={count}")
    del k8, v8, ks, vs, ab
    torch.cuda.empty_cache()
    return summary


def check_flash(torch, dev):
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
    k_ms = time_ms(lambda i: fa.flash_attention_cuda(qs[i], kks[i], vvs[i], pos, lengths), nv, 20)
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
    lib_ms = time_ms(lambda i: F.scaled_dot_product_attention(qt[i], kt[i], vt[i], attn_mask=mask, enable_gqa=True), nv, 20)
    visible = int(mask.sum().item()) * nq  # (query, key) pairs attended, all heads
    # Bytes the function needs: q only for real rows (padded rows' outputs
    # are 0 by contract), K/V only up to min(kv_len, max position + 1) per
    # row, the whole output written once, positions and lengths.
    kv_slots = int(torch.minimum(lengths, pos.max(dim=1).values + 1).clamp_min(0).sum().item())
    q_rows = int((pos >= 0).sum().item())
    nbytes = (q_rows * nq * hd + kv_slots * 2 * nkv * hd + b * s * nq * hd) * 2 + b * s * 4 + b * 4
    b_ms, b_by = bound(nbytes, 4.0 * visible * hd, BF16_FLOPS)
    row = dict(b=b, s=s, nq=nq, nkv=nkv, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=err, tolerance=FLASH_TOL, tolerance_use=use)
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
# serve Llama-3-8B through the port's HTTP front
# ---------------------------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, json.dumps(body).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def serve(torch, dev, _cuda):
    import random

    from generativeaiexamples_tpu_torch.engine.decode import prepare_params
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.llama3_8b(kv_dtype="int8")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = prepare_params(cfg, None, device=dev, generator=gen)
    sched = Scheduler(cfg, params, device=dev, max_batch=32, max_len=2048, decode_chunk_size=8,
                      prefill_chunk_tokens=256, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weight_gb = torch.cuda.memory_allocated(dev) / 1e9
    server = create_engine_app(sched, get_tokenizer("llama3-8b"), "llama3-8b", "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    sched.start()
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = random.Random(0)

    def prompt(n_tokens):  # byte tokenizer: BOS + one token per ASCII byte
        return "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ,.") for _ in range(n_tokens - 1))

    try:
        # Warm-up request (first CUDA allocations, cuBLAS handles).
        status, _ = _post(base + "/v1/completions", {"prompt": prompt(24), "max_tokens": 4, "temperature": 0})
        assert status == 200
        lengths = [20, 48, 140, 180, 220, 250, 450, 650]
        prompts = [prompt(n) for n in lengths]
        n_ttft0 = len(sched.stats.ttft_recent)
        snap0 = sched.stats.snapshot()
        _cuda.reset_launch_counts()
        results: dict[int, tuple] = {}

        def one(i):
            t = time.perf_counter()
            status, body = _post(base + "/v1/completions", {"prompt": prompts[i], "max_tokens": 32, "temperature": 0})
            results[i] = (status, json.loads(body), time.perf_counter() - t)

        t_wall = time.perf_counter()
        workers = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for w in workers:
            w.start()
        # One streaming chat while the completions run.
        status, body = _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompt(60)}], "max_tokens": 32,
            "temperature": 0, "stream": True})
        for w in workers:
            w.join(timeout=900)
        wall = time.perf_counter() - t_wall
        events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
        chat_text = "".join(json.loads(e)["choices"][0]["delta"].get("content", "") for e in events[:-1])
        if status != 200 or events[-1] != "[DONE]" or not chat_text:
            raise AssertionError(f"streaming chat failed: {status} {body[:300]}")
        for path in ("/v1/models", "/health", "/metrics"):
            st, txt = _get(base + path)
            if st != 200 or not txt:
                raise AssertionError(f"{path} returned {st}")
        launches = dict(_cuda.LAUNCHES)
        snap1 = sched.stats.snapshot()
        if len(results) != len(prompts):
            raise AssertionError("a completion did not return")
        texts = {}
        n_tokens = 0
        for i, (st, out, _) in results.items():
            text = out["choices"][0]["text"]
            if st != 200 or not text:
                raise AssertionError(f"completion {i} ({lengths[i]} tokens) failed: {st} {out}")
            texts[i] = (text, out["usage"]["completion_tokens"])
            n_tokens += out["usage"]["completion_tokens"]
        ttfts = sorted(list(sched.stats.ttft_recent)[n_ttft0:])
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched while serving: {missing} ({launches})")
        # The shortest prompt (below the shared-prefix minimum, so it cannot
        # graft its own parked history) re-sent alone: same greedy tokens.
        st, body2 = _post(base + "/v1/completions", {"prompt": prompts[0], "max_tokens": 32, "temperature": 0})
        again = json.loads(body2)["choices"][0]["text"]
        if again != texts[0][0]:
            raise AssertionError(f"re-sent prompt diverged:\n{texts[0][0]!r}\n{again!r}")
        decode_tokens = (snap1["tokens_total"] - snap0["tokens_total"]) - (snap1["requests_total"] - snap0["requests_total"])
        decode_s = snap1["decode_s"] - snap0["decode_s"]
        emit(
            "serve", model="llama3-8b", layers=cfg.n_layers, d_model=cfg.d_model, weights="random int8, seed 0",
            kv="int8 contiguous", max_batch=32, max_len=2048, decode_chunk_size=8, prefill_chunk_tokens=256,
            build_s=build_s, device_gb_after_build=weight_gb, requests=len(prompts) + 1,
            prompt_tokens=lengths, completion_tokens=n_tokens, wall_s=wall,
            ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3 if ttfts else None,
            ttft_max_ms=ttfts[-1] * 1e3 if ttfts else None,
            tokens_per_s=n_tokens / wall, decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
            decode_chunks=snap1["decode_chunks"] - snap0["decode_chunks"],
            prefill_chunks=snap1["prefill_chunks"] - snap0["prefill_chunks"],
            launches=launches, resend_equal=True,
            peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        )
        sched.stop()
        profile_decode(torch, dev, sched)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=30)


def profile_decode(torch, dev, sched, steps: int = 8, length: int = 512, window: int = 1024) -> None:
    """Where a decode chunk's time goes: one chunk of ``steps`` steps with
    every lane live at ``length``, timed by host clock and CUDA events,
    then traced with torch.profiler (device time by kernel name, and the
    device's busy share of the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = sched.max_batch
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, sched.cfg.vocab_size, (b,), device=dev, generator=gen, dtype=torch.int32)
    lengths = torch.full((b,), length, dtype=torch.int32, device=dev)
    temp = torch.zeros(b, device=dev)
    top_p = torch.ones(b, device=dev)
    top_k = torch.zeros(b, dtype=torch.int32, device=dev)

    def chunk():
        return sched._decode_chunk(sched.params, sched._cache, tokens, lengths, gen, temp, top_p, top_k, steps, window)

    with torch.inference_mode():
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chunk()
            torch.cuda.synchronize()
    # Kernel-level events only: an operator's device time is its kernels'.
    by_name: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dt / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit(
        "profile", what=f"one decode chunk, {steps} steps, batch {b} all live at {length}, window {window}",
        host_dispatch_ms=host_ms, wall_ms=wall_ms, event_span_ms=span_ms,
        ms_per_step=span_ms / steps, traced_device_ms=device_ms,
        device_busy_share=device_ms / span_ms if span_ms else None,
        top_kernels_ms={k[:80]: v for k, v in top},
    )


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
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln][-2:]
        for name, (_, log) in _cuda.BUILD_LOG.items()
    }
    emit("build", seconds=time.perf_counter() - t0, per_kernel_s=took, ptxas=ptxas)

    log: list[str] = []
    summary = {
        "qmm": check_qmm(torch, dev, log),
        "decode_attention": check_decode(torch, dev),
        "flash_attention": check_flash(torch, dev),
    }
    if log:
        emit("notes", notes=log)
    check_reference(torch, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    launches = serve(torch, dev, _cuda)

    kernels = []
    for name, s in summary.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"generativeaiexamples_tpu_torch/csrc/{_cuda.SOURCES[name]}",
            "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "shape": s["shape"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
