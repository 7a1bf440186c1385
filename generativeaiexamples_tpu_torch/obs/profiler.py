"""``/debug/profiler/{start,stop}`` on ``torch.profiler`` (port of the JAX
package's ``obs/profiler.py``, which runs ``jax.profiler``).

Opt-in, as in the reference: the routes exist only when
``GAIE_ENABLE_PROFILER=1``, and the trace directory is server-configured
(``GAIE_PROFILER_DIR``), never client-supplied.  A second ``start`` is
409, a ``stop`` with nothing running is 409, a profiler that cannot start
is 501.  ``stop`` writes a Chrome trace (``chrome://tracing``, Perfetto)
into that directory, the card's counterpart of the reference's
TensorBoard trace, and names the file in its answer.

``start`` and ``stop`` arrive on different request threads, and
``torch.profiler`` binds its session to the thread that starts it.  So one
owner thread holds the session from start to stop; the CUDA activity it
records (CUPTI) is process-wide, so kernels launched by any thread, the
scheduler's tick included, land in the trace.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Optional

PROFILER_ENV = "GAIE_ENABLE_PROFILER"
PROFILER_DIR_ENV = "GAIE_PROFILER_DIR"
DEFAULT_PROFILER_DIR = os.path.join(tempfile.gettempdir(), "gaie-profile")
# torch.profiler is process-global, so the busy state must be too.
_PROFILER_STATE: dict = {"session": None}
_PROFILER_LOCK = threading.Lock()


def profiler_enabled() -> bool:
    """The ``GAIE_ENABLE_PROFILER`` gate."""
    return os.environ.get(PROFILER_ENV, "").strip().lower() in ("1", "true", "yes", "on")


class _Session:
    """One profiling session on its own owner thread."""

    def __init__(self, trace_dir: str) -> None:
        self.trace_dir = trace_dir
        self.trace_path = ""
        self.export_s = 0.0
        self.error: Optional[BaseException] = None
        self._started = threading.Event()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, name="gaie-profiler", daemon=True)

    def start(self) -> None:
        self._thread.start()
        self._started.wait()
        if self.error is not None:
            self._thread.join()
            raise self.error

    def _run(self) -> None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception as exc:  # backend may not support tracing
            self.error = exc
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir, f"chain-{os.getpid()}-{time.time_ns()}.pt.trace.json")
            t0 = time.perf_counter()
            prof.export_chrome_trace(path)
            self.export_s = time.perf_counter() - t0
            self.trace_path = path
        except Exception as exc:
            self.error = exc
        finally:
            self._done.set()

    def stop(self) -> None:
        self._stop.set()
        self._done.wait()
        self._thread.join()
        if self.error is not None:
            raise self.error


def profiler_start() -> tuple[int, dict]:
    """``POST /debug/profiler/start``: begin a ``torch.profiler`` trace of
    the CPU and (with a card) CUDA activity; (status, body)."""
    trace_dir = os.environ.get(PROFILER_DIR_ENV, DEFAULT_PROFILER_DIR)
    with _PROFILER_LOCK:
        if _PROFILER_STATE["session"] is not None:
            return 409, {"error": {"message": "profiler already running"}}
        session = _Session(trace_dir)
        try:
            session.start()
        except Exception as exc:
            return 501, {"error": {"message": f"profiler unavailable: {exc}"}}
        _PROFILER_STATE["session"] = session
    return 200, {"status": "profiling", "dir": trace_dir}


def profiler_stop() -> tuple[int, dict]:
    """``POST /debug/profiler/stop``: end the running trace and write it;
    (status, body), the body naming the trace file and its export time."""
    with _PROFILER_LOCK:
        session = _PROFILER_STATE["session"]
        if session is None:
            return 409, {"error": {"message": "profiler not running"}}
        try:
            session.stop()
        finally:
            _PROFILER_STATE["session"] = None
    return 200, {"status": "stopped", "dir": session.trace_dir, "trace": session.trace_path,
                 "export_s": session.export_s}
