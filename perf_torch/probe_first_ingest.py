"""One chain-server process's first bulk ingest against its second, on one card.

A fresh ``python -m generativeaiexamples_tpu_torch.server`` (durability
on, the echo LLM, arctic-embed-l random on the card, the exact store, as
``chip_smoke.py``'s ``durable`` phase starts it) ingests 32 documents of
6,000 bytes through ``/documents/bulk``, then the same 32 texts again
under other names.  Anything the first ingest pays once per process (an
import, a tokenizer lookup) shows as the gap between the two.  Before
that, each of ``torch``, ``transformers``, ``tokenizers`` and
``huggingface_hub`` is imported cold in a process of its own.

Prints one JSON line (the import seconds, the server's start to its first
``/health``, both ingests' seconds), the server's log without its
per-file lines, and the card's name and power limit.  On a machine with
one H100:

    python3 perf_torch/probe_first_ingest.py
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    imports = {}
    for mod in ("torch", "transformers", "tokenizers", "huggingface_hub"):
        t0 = time.perf_counter()
        found = subprocess.run([sys.executable, "-c", f"import {mod}"], capture_output=True).returncode == 0
        imports[mod] = time.perf_counter() - t0 if found else None
    root = tempfile.mkdtemp(prefix="first_ingest_")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("APP_", "GAIE_"))}
    env.update(APP_DURABILITY_ENABLED="true", GAIE_DURABILITY_DIR=os.path.join(root, "durability"),
               APP_LLM_MODELENGINE="echo", APP_CACHE_SEMANTICENABLED="false",
               GAIE_UPLOAD_DIR=os.path.join(root, "uploads"))
    rng = np.random.default_rng(0)
    texts = [cs._chain_text(rng, cs.CHAIN_LONG_BYTES) for _ in range(32)]
    srv = cs._ServerProcess(env, os.path.join(root, "server.log"), (), "first_ingest")
    try:
        ready_s = srv.wait_ready()
        ingests = []
        for prefix in ("first", "second"):
            t0 = time.perf_counter()
            job = cs._wait_job(srv.base, cs._bulk(srv.base, [(f"{prefix}{i}.txt", t) for i, t in enumerate(texts)]))
            if job["status"] != "done" or job["files_done"] != len(texts):
                raise AssertionError(f"probe_first_ingest: {prefix} ingest {job}")
            ingests.append(time.perf_counter() - t0)
        srv.term()
        with open(os.path.join(root, "server.log"), encoding="utf-8") as fh:
            log = [line for line in fh.read().splitlines() if "staged" not in line and "loaded upload" not in line]
    finally:
        srv.close()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"import_s": imports, "ready_s": ready_s, "first_ingest_s": ingests[0],
                      "second_ingest_s": ingests[1], "documents": len(texts)}), flush=True)
    print("\n".join(log[-40:]))
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
