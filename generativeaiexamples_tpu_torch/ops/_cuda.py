"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface (no
PyTorch headers, so a build takes seconds) and loaded with ``ctypes``.
Libraries live in ``build/torch_kernels/`` at the checkout root, named
by a hash of their sources: an edited kernel rebuilds, an unchanged one
loads as built.  Nothing is built when this module is imported; the
first launch of a kernel (or :func:`build`) builds it.

``LAUNCHES`` counts launches per kernel.  Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

SMS = 132  # streaming multiprocessors of an H100 SXM, for the launch planners

# kernel name -> source file under csrc/
SOURCES = {
    "qmm": "qmm.cu",
    "decode_attention": "decode_attention.cu",
    "flash_attention": "flash_attention.cu",
    "paged_decode_attention": "paged_decode_attention.cu",
}
# Headers every library hashes with its source: an edited header rebuilds.
_COMMON = ("common.cuh", "decode_tile.cuh", "sm90.cuh")

LAUNCHES = {name: 0 for name in SOURCES}
# Launches of each of the W8A8 kernel's two designs (ops/qmm.py), beside
# its one count in LAUNCHES.
QMM_DESIGN_LAUNCHES = {"decode": 0, "wide": 0}
# Launches of the prefill flash kernel at each head_dim it is built for.
FLASH_HD_LAUNCHES = {64: 0, 128: 0, 256: 0}
# The decode kernels' (head_dim, most query heads a kv head) instances, as
# csrc/decode_tile.cuh's with_instance dispatches them: Llama-3 and Mixtral
# (128, G 4), StarCoder2-3B (128, G 12), Gemma-2B (256, G 8) and Gemma-7B
# (256, G 1).  Any other shape raises on the card.
DECODE_INSTANCES = ((128, 8), (128, 16), (256, 8))
# Launches of each decode kernel at each instance, as "128x8" and so on.
DECODE_INSTANCE_LAUNCHES = {
    name: {"%dx%d" % inst: 0 for inst in DECODE_INSTANCES} for name in ("decode_attention", "paged_decode_attention")
}

# name -> (seconds, ptxas report) of builds made by this process
BUILD_LOG: dict[str, tuple[float, str]] = {}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, QMM_DESIGN_LAUNCHES, FLASH_HD_LAUNCHES, *DECODE_INSTANCE_LAUNCHES.values()):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for fname in (SOURCES[name],) + _COMMON:
        digest.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, float]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes at once; returns seconds per kernel built here.  A failed
    build raises with the compiler's output."""
    names = list(SOURCES if names is None else names)
    with _lock:
        return _build_locked(names)


def _build_locked(names: list[str]) -> dict[str, float]:
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # libcuda (cuTensorMapEncodeTiled) links against the toolkit's stub; the
    # installed libcuda.so.1 is loaded at run time.
    cuda_root = Path(nvcc).resolve().parent.parent
    stubs = [f"-L{d}" for d in (cuda_root / "lib64" / "stubs", cuda_root / "targets" / "x86_64-linux" / "lib" / "stubs")
             if d.is_dir()]
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-I", str(CSRC), "-o", str(tmp), str(CSRC / SOURCES[name]), *stubs, "-lcuda",
        ]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    took: dict[str, float] = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = (took[name], log)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return took


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of kernel library ``name`` (built on
    first use), returning an int CUDA error code."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.gaie_error_string.restype = ctypes.c_char_p
            lib.gaie_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[key] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = _libs[name].gaie_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def on_cuda(tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if tensor.is_cuda:
        return True
    if tensor.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {tensor.device}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_float = ctypes.c_float
