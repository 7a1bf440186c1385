"""The port imports neither JAX nor anything of the JAX package, nor the
packages the card machine lacks (aiohttp, pydantic, httpx, PyYAML,
requests, and the external stores' client libraries and sentence-transformers,
which load only when such a store or embedder is built), not even when it
builds an ``HFTokenizer`` (which imports ``transformers``).

Checked in a subprocess: the test process itself has JAX loaded by
``tests/conftest.py``.  Note the prefix: ``generativeaiexamples_tpu_torch``
itself starts with ``generativeaiexamples_tpu``.
"""

import os
import pkgutil
import subprocess
import sys

import generativeaiexamples_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, os, pkgutil, sys
import generativeaiexamples_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
ABSENT = ("jax", "generativeaiexamples_tpu", "aiohttp", "pydantic", "httpx", "yaml", "requests", "pymilvus",
          "psycopg2", "sentence_transformers")
bad = [m for m in sys.modules if m.split(".")[0] in ABSENT]
# transformers itself pulls in PyYAML; JAX and the JAX package stay out.
from generativeaiexamples_tpu_torch.engine.tokenizer import HFTokenizer
assert HFTokenizer(os.environ["PROBE_TOKENIZER_DIR"]).encode("the quick fox")
bad_after = [m for m in sys.modules if m.split(".")[0] in ("jax", "generativeaiexamples_tpu")]
print(",".join(names))
print(",".join(sorted(bad)))
print(",".join(sorted(bad_after)))
"""


def _bpe_tokenizer_dir(path) -> str:
    """A small byte-level BPE tokenizer saved as local HF files."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=300, special_tokens=["<unk>", "<s>", "</s>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["the quick brown fox jumps over the lazy dog"] * 20, trainer)
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(str(path))
    return str(path)


def test_port_imports_no_jax_and_no_reference_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PROBE_TOKENIZER_DIR"] = _bpe_tokenizer_dir(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    names, bad, bad_after = out.stdout.split("\n")[:3]
    names = names.split(",")
    expected = len(list(pkgutil.walk_packages(
        generativeaiexamples_tpu_torch.__path__, "generativeaiexamples_tpu_torch.")))
    assert len(names) == expected >= 120
    for module in ("engine.paged_kv", "models.bert", "engine.embedder", "engine.reranker", "engine.microbatch",
                   "retrieval.base", "retrieval.memory", "retrieval.gpu", "retrieval.retriever", "retrieval.factory",
                   "core.config", "core.configuration", "core.tracing", "obs.metrics", "obs.trace", "obs.recorder",
                   "resilience.deadline", "resilience.breaker", "resilience.retry", "resilience.degrade",
                   "resilience.faults", "resilience.metrics", "cache.log", "cache.metrics", "cache.core",
                   "chains.factory", "chains.base", "chains.llm", "chains.developer_rag", "ingest.loaders",
                   "ingest.splitters", "engine.embedder_client", "core.httpclient", "resilience.admission",
                   "obs.tsdb", "obs.slo", "server.schema", "server.plugins", "server.app", "server.__main__",
                   "durability.wal", "durability.metrics", "durability.journal", "durability.store",
                   "retrieval.fabric.collections", "retrieval.fabric.metrics", "ingest.pipeline", "obs.profiler",
                   "obs.exposition", "chains.multi_turn", "chains.query_decomposition", "chains.api_catalog",
                   "engine.spec_decode", "engine.weights", "engine.tokenizer", "engine.native_tokenizer",
                   "utils.native_build", "engine.generator", "engine.speculative", "retrieval.fabric.sharded",
                   "retrieval.fabric.coldtier", "retrieval.native", "retrieval.milvus_compat",
                   "retrieval.elastic_compat", "retrieval.pgvector_compat", "ingest.pdf", "ingest.pptx",
                   "ingest.multimodal_pdf", "models.vision", "models.speech", "ops.f32", "engine.vision_service",
                   "engine.speech_service", "chains.multimodal", "engine.training", "engine.lora", "streaming",
                   "streaming.accumulator", "streaming.timestamps", "streaming.dsp", "streaming.graph",
                   "streaming.replay", "streaming.asr", "streaming.chains", "streaming.server"):
        assert f"generativeaiexamples_tpu_torch.{module}" in names
    assert bad == "", f"port pulled in: {bad}"
    assert bad_after == "", f"building an HFTokenizer pulled in: {bad_after}"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports nothing of JAX, nor the packages the card
    machine lacks (its import is cheap: the work runs under ``main``)."""
    probe = (
        "import sys, runpy; sys.argv=['chip_smoke.py']; "
        "import importlib.util as u; s=u.spec_from_file_location('chip_smoke','chip_smoke.py'); "
        "m=u.module_from_spec(s); s.loader.exec_module(m); "
        "print(','.join(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'generativeaiexamples_tpu', 'aiohttp', 'pydantic', 'httpx', 'yaml')))"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
