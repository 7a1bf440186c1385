"""Kernel K4's two Hopper designs side by side on one card.

Times the port's prefill flash attention (``csrc/flash_attention.cu``, bf16
wgmma, 4 blocks an SM) beside its earlier mma.sync design
(``perf_torch/flash_mma_sync.cu``) and SDPA, at ``chip_smoke.py``'s
``check_flash`` shape (b=8, s=256, 32/8 heads, ragged lengths, padded rows),
each as CUDA-graph replays in the order A B B A three times, after checking
both kernels against the plain version.  Prints one JSON line per result
and the card's name and power limit.  On a machine with one H100:

    python3 perf_torch/probe_flash_designs.py
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from generativeaiexamples_tpu_torch.ops import _cuda
    from generativeaiexamples_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    _cuda.SOURCES["flash_mma_sync"] = os.path.relpath(os.path.join(ROOT, "perf_torch", "flash_mma_sync.cu"), _cuda.CSRC)
    _cuda.build(["flash_attention", "flash_mma_sync"])
    for name, (_, log) in _cuda.BUILD_LOG.items():
        print(json.dumps(dict(build=name, ptxas=[ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln])))

    def launch(name, q, k, v, pos, lengths):
        b, s, n_q, hd = q.shape
        out = torch.empty_like(q)
        fn = _cuda.function(name, "flash_attention_launch", fa._FLASH_ARGS)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 b, s, k.shape[1], n_q, k.shape[2], hd**-0.5, _cuda.stream_ptr(q))
        _cuda.check(name, err)
        return out

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    b, s, nq, nkv, hd, nv = 8, 256, 32, 8, 128, 4
    qs = [torch.randn(b, s, nq, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    ks = [torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    vs = [torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    lengths = torch.tensor([256, 200, 131, 256, 180, 140, 256, 160], dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    pos[5, 140:] = -1
    ref = fa.flash_gqa_attention_plain(qs[0], ks[0], vs[0], pos, lengths)
    designs = ("flash_attention", "flash_mma_sync")
    for name in designs:
        out = launch(name, qs[0], ks[0], vs[0], pos, lengths)
        torch.testing.assert_close(out, ref, **cs.FLASH_TOL)
        if out[5, 140:].any():
            raise AssertionError(f"{name}: padded query rows must give exact zeros")
        print(json.dumps(dict(check=name, max_abs_err=(out.float() - ref.float()).abs().max().item())))

    t_idx = torch.arange(s, device=dev)
    mask = ((t_idx[None, None, :] <= pos[:, :, None]) & (t_idx[None, None, :] < lengths[:, None, None]))[:, None]
    qt, kt, vt = ([x.transpose(1, 2) for x in xs] for xs in (qs, ks, vs))
    fns = {name: (lambda i, _n=name: launch(_n, qs[i], ks[i], vs[i], pos, lengths)) for name in designs}
    fns["sdpa"] = lambda i: F.scaled_dot_product_attention(qt[i], kt[i], vt[i], attn_mask=mask, enable_gqa=True)
    times = {name: [] for name in fns}
    for _ in range(3):
        for name in ("flash_attention", "flash_mma_sync", "sdpa", "sdpa", "flash_mma_sync", "flash_attention"):
            times[name].append(cs.time_ms(fns[name], nv, 50, graph=True))
    median = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    print(json.dumps(dict(ms=times, median_ms=median,
                          mma_sync_over_wgmma=median["flash_mma_sync"] / median["flash_attention"])))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
