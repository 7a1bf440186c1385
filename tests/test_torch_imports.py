"""The port imports neither JAX nor anything of the JAX package.

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
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "generativeaiexamples_tpu" or m.startswith("generativeaiexamples_tpu.")]
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
    assert len(names) == expected >= 22
    for module in ("engine.paged_kv", "models.bert", "engine.embedder", "engine.reranker", "engine.microbatch",
                   "retrieval.base", "retrieval.memory", "retrieval.gpu"):
        assert f"generativeaiexamples_tpu_torch.{module}" in names
    assert bad == "", f"port pulled in: {bad}"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports nothing of JAX (its import is cheap: the
    work runs under ``main``)."""
    probe = (
        "import sys, runpy; sys.argv=['chip_smoke.py']; "
        "import importlib.util as u; s=u.spec_from_file_location('chip_smoke','chip_smoke.py'); "
        "m=u.module_from_spec(s); s.loader.exec_module(m); "
        "print(','.join(k for k in sys.modules if k=='jax' or k.startswith('jax.') "
        "or k=='generativeaiexamples_tpu' or k.startswith('generativeaiexamples_tpu.')))"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
