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
  * :mod:`~.tsdb`: fixed-memory step-downsampled time-series rings (the
    chain server's QPS, latency and error feeds).
  * :mod:`~.slo`: config-defined objectives evaluated as multi-window
    burn-rate rules over the TSDB (``rag_slo_*`` metrics, ``/health``
    degradation, alert transitions pinned into the flight recorder).

The reference's ``exposition`` and ``profiler`` are not ported
(``ROADMAP.md``, Queue 1 item 7).
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
from generativeaiexamples_tpu_torch.obs.slo import (
    SloEngine,
    get_slo_engine,
    reset_slo,
    slo_health,
    slo_metrics_lines,
    slo_note_request,
)
from generativeaiexamples_tpu_torch.obs.tsdb import (
    Tsdb,
    get_tsdb,
    parse_window,
    reset_tsdb,
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
    "SloEngine",
    "Tsdb",
    "bind_request_trace",
    "current_request_trace",
    "get_flight_recorder",
    "get_slo_engine",
    "get_tsdb",
    "obs_metrics_lines",
    "obs_snapshot",
    "observe_request",
    "observe_stage",
    "parse_window",
    "reset_flight_recorder",
    "reset_obs",
    "reset_obs_metrics",
    "reset_slo",
    "reset_tsdb",
    "slo_health",
    "slo_metrics_lines",
    "slo_note_request",
    "trace_scope",
    "traced_stream",
]


def reset_obs() -> None:
    """Testing hook: zero the histograms, drop the flight recorder, and
    drop the TSDB and SLO engine singletons."""
    reset_obs_metrics()
    reset_flight_recorder()
    reset_tsdb()
    reset_slo()
