"""Pipeline plugin discovery (port of the JAX package's ``server/plugins.py``).

Parity with the reference's startup reflection (``common/server.py:143-173``):
scan a directory of Python files (or import a named module) and pick the
first class exposing the three plugin methods ``ingest_docs`` /
``llm_chain`` / ``rag_chain``.  Swapping pipelines = swapping one directory
or one env var.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import os
from typing import Optional, Type

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

EXAMPLE_PATH_ENV = "GAIE_EXAMPLE_PATH"  # directory of .py files
EXAMPLE_MODULE_ENV = "GAIE_EXAMPLE_MODULE"  # importable module name
DEFAULT_EXAMPLE_MODULE = "generativeaiexamples_tpu_torch.chains.developer_rag"

_REQUIRED = ("ingest_docs", "llm_chain", "rag_chain")


def _has_plugin_methods(cls: type) -> bool:
    return all(callable(getattr(cls, m, None)) for m in _REQUIRED)


def _scan_module(module) -> Optional[Type]:
    for _, cls in inspect.getmembers(module, inspect.isclass):
        if inspect.isabstract(cls):
            continue
        if cls.__name__ == "BaseExample":
            continue
        if _has_plugin_methods(cls):
            return cls
    return None


def discover_example() -> Type:
    """Locate the pipeline class to serve."""
    path = os.environ.get(EXAMPLE_PATH_ENV, "")
    if path:
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".py"):
                continue
            spec = importlib.util.spec_from_file_location(
                f"gaie_example_{fname[:-3]}", os.path.join(path, fname)
            )
            assert spec and spec.loader
            module = importlib.util.module_from_spec(spec)
            try:
                spec.loader.exec_module(module)
            except Exception:
                logger.exception("failed to import example file %s", fname)
                continue
            cls = _scan_module(module)
            if cls is not None:
                logger.info("serving example %s from %s", cls.__name__, fname)
                return cls
        raise RuntimeError(f"no plugin class found under {path}")

    module_name = os.environ.get(EXAMPLE_MODULE_ENV, DEFAULT_EXAMPLE_MODULE)
    module = importlib.import_module(module_name)
    cls = _scan_module(module)
    if cls is None:
        raise RuntimeError(f"no plugin class found in module {module_name}")
    logger.info("serving example %s from %s", cls.__name__, module_name)
    return cls
