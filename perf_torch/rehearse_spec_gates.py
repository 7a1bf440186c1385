"""Rehearse chip_smoke.py's speculative gates against planted verify faults,
on one CUDA card.

Each case copies ``chip_smoke.py`` and the port's package into a temporary
directory, plants one fault in the copy's verify attention
(``generativeaiexamples_tpu_torch/ops/decode_attention.py``), and runs
there, in a fresh process, what the ``spec`` phase's gates read on
Llama-3-8B W8A8 (random, seed 0): a plain scheduler's greedy streams over
``serve``'s 8 completions and streaming chat (the reference), the
prompt-lookup scheduler's over the same requests and the quoting prompt
(``chip_smoke.check_spec_streams``), and the full-width accepting round
(``chip_smoke.spec_accept_round``).  Cases:

* ``none``: the code as it is;
* ``mask_shift``: each fresh query also sees the next fresh slot (the
  verify block's causal mask shifted by one);
* ``prefix_drop``: the verify pass misses the last cached token.

Prints one JSON line per case: the readings and the gate failures they
raise (none for ``none``; a fault the gates cannot see prints none too).

    python3 perf_torch/rehearse_spec_gates.py [case ...]
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join("generativeaiexamples_tpu_torch", "ops", "decode_attention.py")
_BLOCK = "        (k_ab[layer], v_ab[layer], ks_ab[layer], vs_ab[layer]),\n"
# Each fault: (text in both verify functions, its replacement).
FAULTS = {
    "none": None,
    "mask_shift": (_BLOCK + "        0,\n    )", _BLOCK + "        1,\n    )"),
    "prefix_drop": ("        kv_lengths,\n" + _BLOCK, "        kv_lengths - 1,\n" + _BLOCK),
}

CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from generativeaiexamples_tpu_torch.engine.decode import w8a8_params
from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import _cuda

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
t0 = time.perf_counter()
_cuda.build()
cfg = llama.llama3_8b(kv_dtype="int8")
with torch.inference_mode():
    params = w8a8_params(cfg, None, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
prompts = cs.make_prompts()
serve = dict(decode_tokens_per_s=None, wall_s=None, ttft_p50_ms=None)
plain = Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **cs.serve_kw("contiguous"))
records, _ = cs.spec_step(torch, dev, _cuda, "plain", plain, cfg, params, prompts, serve, ("batch",))
plain._cache = None
streams = {prompt: ids for prompt, _, ids in records}
ngram = Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **cs.serve_kw("contiguous"), spec_mode="ngram",
                  gamma=cs.SPEC_GAMMA)
records, _ = cs.spec_step(torch, dev, _cuda, "ngram", ngram, cfg, params, prompts, serve, ("batch", "quote"))
ngram._cache = ngram._dhist = None
gates = cs.check_spec_streams(torch, cfg, params, records, streams)
accept = cs.spec_accept_round(torch, dev, cfg, params, get_tokenizer("llama3-8b").encode(prompts["chat"]))
failures = gates.pop("failures") + ["spec_accept: " + f for f in accept.pop("failures")]
print(json.dumps(dict(streams=gates, accept=accept, failures=failures, seconds=time.perf_counter() - t0)))
"""


def plant(case: str, dst: str) -> None:
    """Copy the script and the package into ``dst`` with ``case``'s fault."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    shutil.copytree(os.path.join(ROOT, "generativeaiexamples_tpu_torch"),
                    os.path.join(dst, "generativeaiexamples_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    if FAULTS[case] is None:
        return
    old, new = FAULTS[case]
    path = os.path.join(dst, TARGET)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 2:
        raise SystemExit(f"{case}: expected the text twice in {TARGET}, found it {text.count(old)} times")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def main(argv) -> int:
    cases = argv or list(FAULTS)
    for case in cases:
        with tempfile.TemporaryDirectory() as dst:
            plant(case, dst)
            proc = subprocess.run([sys.executable, "-c", CHILD], cwd=dst, capture_output=True, text=True,
                                  timeout=900)
        lines = [line for line in proc.stdout.splitlines() if line.startswith('{"streams"')]
        if proc.returncode or not lines:
            print(proc.stderr[-4000:], file=sys.stderr)
            print(json.dumps(dict(case=case, returncode=proc.returncode)), flush=True)
            return 1
        print(json.dumps(dict(case=case, **json.loads(lines[-1]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
