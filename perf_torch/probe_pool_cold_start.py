"""The replica pool's stall monitor against a cold start, on one card.

A replica whose tick counter does not move for the pool's
``stall_timeout`` (30 s) is failed over.  The kernels build with ``nvcc``
at first use, and a cold prefill batch makes one long tick, so both could
freeze a counter.  Two cold starts of a 2-replica Llama-3-8B W8A8 pool
(full width and depth, random int8 from seed 0, the engine server's
serving settings), each with a thread reading every replica's tick counter
every 10 ms:

1. ``in_tick_build``: every kernel built into an empty directory at first
   use, inside the replicas' first ticks, with the pool's monitor running
   (what a pool would see without the engine server's prebuild);
2. ``prebuilt``: ``build_server(["--replicas", "2", ...])`` over another
   empty directory, which builds every kernel before it returns, then a
   cold batch of 32 prompts of 512 tokens (16,384 prompt tokens, 8 tokens
   each) through the started pool.

Each prints one JSON line: each replica's longest counter freeze, the
pool's failovers, the build and first-token seconds; then the card's name
and power limit.  On a machine with one H100:

    python3 perf_torch/probe_pool_cold_start.py
"""

import json
import os
import queue
import shutil
import sys
import threading
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COLD_BATCH, COLD_PROMPT, COLD_TOKENS = 32, 512, 8


class FreezeSampler:
    """Each replica's longest stretch without a new tick."""

    def __init__(self, pool):
        self.pool, self.longest, self._stop = pool, {}, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last = {}
        while not self._stop.is_set():
            now = time.monotonic()
            for r in list(self.pool.replicas):
                count = r.scheduler.stats.tick_count
                seen = last.get(r.idx)
                if seen is None or seen[0] != count:
                    last[r.idx] = (count, now)
                else:
                    self.longest[r.idx] = max(self.longest.get(r.idx, 0.0), now - seen[1])
            time.sleep(0.01)

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        return {i: round(s, 3) for i, s in sorted(self.longest.items())}


def _run_batch(pool, prompts, max_tokens) -> tuple:
    """Submit every prompt at once; (seconds until all finished, their
    finish reasons)."""
    from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
    from generativeaiexamples_tpu_torch.engine.scheduler import Request

    t0 = time.perf_counter()
    dones = []
    for i, prompt in enumerate(prompts):
        done: "queue.Queue[str]" = queue.Queue()
        assert pool.submit(Request(token_ids=prompt, sampling=SamplingParams(temperature=0.0, max_tokens=max_tokens),
                                   on_token=lambda t: None, on_done=done.put, id=f"cold-{i}"))
        dones.append(done)
    reasons = [d.get(timeout=600) for d in dones]
    return time.perf_counter() - t0, reasons


def main() -> int:
    import torch

    import chip_smoke as cs
    from generativeaiexamples_tpu_torch.engine.decode import w8a8_params
    from generativeaiexamples_tpu_torch.engine.replica import EnginePool
    from generativeaiexamples_tpu_torch.engine.scheduler import SERVING_DEFAULTS, Scheduler
    from generativeaiexamples_tpu_torch.engine.server import build_server
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    scratch = [Path(ROOT, "build", "torch_kernels", f"probe-{os.getpid()}-{part}") for part in ("a", "b")]
    g = torch.Generator().manual_seed(1)
    cold = [[1] + torch.randint(3, 255, (COLD_PROMPT - 1,), generator=g).tolist() for _ in range(COLD_BATCH)]
    try:
        # 1. The kernels build inside the first ticks.
        _cuda.BUILD_DIR = scratch[0]
        cfg = llama.llama3_8b(kv_dtype="int8")
        with torch.inference_mode():
            params = w8a8_params(cfg, None, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        pool = EnginePool([Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **SERVING_DEFAULTS)
                           for _ in range(2)], policy="prefix")
        sampler = FreezeSampler(pool)
        pool.start()
        first_s, reasons = _run_batch(pool, [cold[0][:64], cold[1][:64]], 2)
        freezes = sampler.stop()
        print(json.dumps(dict(probe="in_tick_build", nvidia_smi=smi, built=sorted(_cuda.BUILD_LOG),
                              first_requests_s=first_s, finish_reasons=reasons, longest_freeze_s=freezes,
                              stall_timeout_s=pool.stall_timeout,
                              failovers=pool.failovers_total, states=pool.replica_states())), flush=True)
        pool.stop()
        del pool, params
        torch.cuda.empty_cache()

        # 2. build_server prebuilds, then a cold batch.
        _cuda.BUILD_DIR = scratch[1]
        t0 = time.perf_counter()
        server = build_server(["--model", "llama3-8b", "--replicas", "2", "--matmul-kernel", "pallas_w8a8",
                               "--embedder", "none", "--host", "127.0.0.1", "--port", "0"])
        build_server_s = time.perf_counter() - t0
        pool = server.scheduler
        prebuilt = sorted(p.name.split("-")[0] for p in scratch[1].glob("*.so"))
        sampler = FreezeSampler(pool)
        pool.start()
        batch_s, reasons = _run_batch(pool, cold, COLD_TOKENS)
        freezes = sampler.stop()
        if reasons != ["length"] * COLD_BATCH:
            raise AssertionError(f"a cold request failed: {reasons}")
        snap = pool.snapshot()
        print(json.dumps(dict(probe="prebuilt", nvidia_smi=smi, build_server_s=build_server_s, prebuilt=prebuilt,
                              cold_batch=f"{COLD_BATCH} x {COLD_PROMPT} tokens, {COLD_TOKENS} out",
                              batch_s=batch_s, longest_freeze_s=freezes, stall_timeout_s=pool.stall_timeout,
                              failovers=pool.failovers_total, placed=[r["requests_total"] for r in snap["replicas"]],
                              states=pool.replica_states())), flush=True)
        server.server_close()
        pool.stop()
    finally:
        for d in scratch:
            shutil.rmtree(d, ignore_errors=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
