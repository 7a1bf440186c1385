"""The port imports neither JAX nor anything of the JAX package, nor the
packages the card machine lacks (aiohttp, pydantic, httpx, PyYAML).

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
import importlib, pkgutil, sys
import generativeaiexamples_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
ABSENT = ("jax", "generativeaiexamples_tpu", "aiohttp", "pydantic", "httpx", "yaml")
bad = [m for m in sys.modules if m.split(".")[0] in ABSENT]
print(",".join(names))
print(",".join(sorted(bad)))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.split("\n")[:2]
    names = names.split(",")
    expected = len(list(pkgutil.walk_packages(
        generativeaiexamples_tpu_torch.__path__, "generativeaiexamples_tpu_torch.")))
    assert len(names) == expected >= 70
    for module in ("engine.paged_kv", "models.bert", "engine.embedder", "engine.reranker", "engine.microbatch",
                   "retrieval.base", "retrieval.memory", "retrieval.gpu", "retrieval.retriever", "retrieval.factory",
                   "core.config", "core.configuration", "core.tracing", "obs.metrics", "obs.trace", "obs.recorder",
                   "resilience.deadline", "resilience.breaker", "resilience.retry", "resilience.degrade",
                   "resilience.faults", "resilience.metrics", "cache.log", "cache.metrics", "cache.core",
                   "chains.factory", "chains.base", "chains.llm", "chains.developer_rag", "ingest.loaders",
                   "ingest.splitters", "engine.embedder_client", "core.httpclient", "resilience.admission",
                   "obs.tsdb", "obs.slo", "server.schema", "server.plugins", "server.app", "server.__main__"):
        assert f"generativeaiexamples_tpu_torch.{module}" in names
    assert bad == "", f"port pulled in: {bad}"


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
