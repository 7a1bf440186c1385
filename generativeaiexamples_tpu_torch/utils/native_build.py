"""Build-on-first-use loader for the repository's C++ host libraries
(port of the JAX package's ``utils/native_build.py``).

``native/<name>.cpp`` compiles with ``g++`` into
``build/torch_native/lib<name>.so`` at the checkout root (the port's own
build directory; ``native/build/`` is the JAX package's) when the library
is missing or older than its source, and loads with ``ctypes``.  Nothing
is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from generativeaiexamples_tpu_torch.core.logging import get_logger

logger = get_logger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL] = {}


def load_native_library(src_name: str) -> ctypes.CDLL:
    """Load ``native/<src_name>.cpp`` as ``build/torch_native/lib<src_name>.so``,
    compiling when the library is missing or older than the source."""
    with _lock:
        if src_name in _cache:
            return _cache[src_name]
        src = os.path.join(_REPO_ROOT, "native", f"{src_name}.cpp")
        lib_path = os.path.join(BUILD_DIR, f"lib{src_name}.so")
        if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # Built beside its final name and renamed: a process that finds
            # the library never loads a half-written file.
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src]
            logger.info("building native %s: %s", src_name, " ".join(cmd))
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        _cache[src_name] = lib
        return lib
