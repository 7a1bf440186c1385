"""Per-request, per-stage telemetry for the RAG hot path (port of the JAX
package's ``obs/``: the request trace, the latency histograms and the
flight recorder).

  * :class:`~.trace.RequestTrace`: request-scoped stage timings and
    attributes, carried by contextvar on the request thread and explicitly
    through the micro-batcher's queue entries.
  * :mod:`~.metrics`: fixed-bucket Prometheus histograms
    (``rag_stage_latency_ms`` / ``rag_request_latency_ms``).
  * :class:`~.recorder.FlightRecorder`: bounded ring of the last N
    completed traces (errors and degraded requests pinned).

The reference's ``tsdb``, ``slo``, ``exposition`` and ``profiler`` come
with the chain server (``ROADMAP.md``, Queue 1 item 2).
"""

from generativeaiexamples_tpu_torch.obs.metrics import (
    REQUEST_BUCKETS_MS,
    STAGE_BUCKETS_MS,
    STAGES,
    obs_metrics_lines,
    obs_snapshot,
    observe_request,
    observe_stage,
    reset_obs_metrics,
)
from generativeaiexamples_tpu_torch.obs.recorder import (
    FlightRecorder,
    get_flight_recorder,
    reset_flight_recorder,
)
from generativeaiexamples_tpu_torch.obs.trace import (
    RequestTrace,
    bind_request_trace,
    current_request_trace,
    trace_scope,
    traced_stream,
)

__all__ = [
    "REQUEST_BUCKETS_MS",
    "STAGE_BUCKETS_MS",
    "STAGES",
    "FlightRecorder",
    "RequestTrace",
    "bind_request_trace",
    "current_request_trace",
    "get_flight_recorder",
    "obs_metrics_lines",
    "obs_snapshot",
    "observe_request",
    "observe_stage",
    "reset_flight_recorder",
    "reset_obs",
    "reset_obs_metrics",
    "trace_scope",
    "traced_stream",
]


def reset_obs() -> None:
    """Testing hook: zero the histograms and drop the flight recorder."""
    reset_obs_metrics()
    reset_flight_recorder()
