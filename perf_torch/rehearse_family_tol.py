"""Rehearse chip_smoke.py's card-vs-CPU gate of the ``families`` phase
(``FAMILY_TOL`` and the routed-elsewhere allowance) against planted
faults, on one CUDA card.

Each case copies ``chip_smoke.py`` and the port's package into a temporary
directory, plants one fault on the card's side of the comparison in the
copy, and runs there, in a fresh process, ``chip_smoke.card_vs_cpu`` as
``families`` runs it (full width, ``FAMILY_REF_LAYERS`` layers, bf16,
random W8A8 params from seed 5, two prompts of 32 and 19 tokens, the
cacheless forward too) on the case's presets.  Cases:

* ``none``: the code as it is, on all four families;
* ``float_dot_bf16``: the card's float products (the MoE router and
  experts) sum their 128-wide K chunks in bf16 instead of f32 (Mixtral);
* ``router_tie_high``: the card's top-k sends router ties to the higher
  expert instead of the lower (Mixtral);
* ``second_tile``: the decode kernels' second 8-head tile of O^T (query
  heads 8..15 of a kv head, the (128, 16) instance only) multiplies the
  first tile's probabilities (StarCoder2-3B: 12 heads a kv head).

For the MoE preset it also runs ``chip_smoke.moe_products_vs_cpu`` (the
router's and experts' float products and the top-k on planted ties, held
directly).  Prints one JSON line per (case, preset): every comparison's
readings and the gates' failure messages (null where the gates held; a
fault the gates cannot see prints null too).

    python3 perf_torch/rehearse_family_tol.py [case ...]
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "generativeaiexamples_tpu_torch"
# case -> (file in the package, its text, the replacement, presets); the
# text must appear once.
FAULTS = {
    "none": (None, None, None, ("gemma-2b", "gemma-7b", "starcoder2-3b", "mixtral-8x7b")),
    "float_dot_bf16": (
        "ops/quant.py",
        "    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:\n",
        "    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:\n"
        "        return sum(torch.matmul(x[..., k:k + 128], w[..., k:k + 128, :]) for k in range(0, x.shape[-1], 128))\n",
        ("mixtral-8x7b",),
    ),
    "router_tie_high": (
        "models/llama.py",
        "    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)\n",
        "    values, idx = torch.sort(probs.flip(-1) if probs.is_cuda else probs, dim=-1, descending=True, stable=True)\n"
        "    idx = probs.shape[-1] - 1 - idx if probs.is_cuda else idx\n",
        ("mixtral-8x7b",),
    ),
    "second_tile": (
        "csrc/decode_tile.cuh",
        "      mma_bf16_16x8x16(acc[i][hb], a, b0[hb], b1[hb]);\n",
        "      mma_bf16_16x8x16(acc[i][hb], a, b0[0], b1[0]);\n",
        ("starcoder2-3b",),
    ),
}

CHILD = r"""
import gc, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import _cuda

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
_cuda.build()
for preset in sys.argv[1:]:
    t0 = time.perf_counter()
    cfg = llama.PRESETS[preset](kv_dtype="int8", n_layers=cs.FAMILY_REF_LAYERS)
    try:
        with torch.inference_mode():
            fields = cs.card_vs_cpu(torch, dev, cfg, 5, 32, [32, 19], cs.FAMILY_TOL, cacheless=True,
                                    built_on="card")
        failure = None
    except cs.ToleranceError as e:
        fields, failure = e.fields, str(e)
    except AssertionError as e:
        fields, failure = {}, str(e)
    if cfg.n_experts > 1:
        try:
            fields["moe_products"] = cs.moe_products_vs_cpu(torch, dev, cfg, 6)
        except cs.ToleranceError as e:
            fields["moe_products"] = e.fields
            failure = "; ".join(x for x in (failure, str(e)) if x)
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps(dict(preset=preset, failure=failure, seconds=time.perf_counter() - t0, **fields)), flush=True)
"""


def plant(case: str, dst: str) -> tuple:
    """Copy the script and the package into ``dst`` with ``case``'s fault;
    returns the case's presets."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    target, old, new, presets = FAULTS[case]
    if target is None:
        return presets
    path = os.path.join(dst, PKG, target)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{case}: expected the text once in {target}, found it {text.count(old)} times")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    return presets


def main(argv) -> int:
    for case in argv or list(FAULTS):
        with tempfile.TemporaryDirectory() as dst:
            presets = plant(case, dst)
            proc = subprocess.run([sys.executable, "-c", CHILD, *presets], cwd=dst, capture_output=True, text=True,
                                  timeout=900)
        lines = [line for line in proc.stdout.splitlines() if line.startswith('{"preset"')]
        for line in lines:
            print(json.dumps(dict(case=case, **json.loads(line))), flush=True)
        if proc.returncode or len(lines) != len(presets):
            print(proc.stderr[-4000:], file=sys.stderr)
            print(json.dumps(dict(case=case, returncode=proc.returncode)), flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
