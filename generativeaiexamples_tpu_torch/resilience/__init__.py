"""Resilience layer: deadlines, retries, breakers, degradation, faults
(port of the JAX package's ``resilience/``).

* :mod:`.deadline`: per-request time budgets, propagated end to end.
* :mod:`.retry`: jittered exponential backoff with retry budgets.
* :mod:`.breaker`: per-dependency closed/open/half-open breakers.
* :mod:`.degrade`: the graceful-degradation ladder's request log.
* :mod:`.faults`: named fault points for chaos testing.
* :mod:`.metrics`: counters and Prometheus export for all of the above.

The reference's ``admission`` (traffic classes and shedding) comes with
the chain server (``ROADMAP.md``, Queue 1 item 2).
"""

from generativeaiexamples_tpu_torch.resilience.breaker import (
    CircuitBreaker,
    CircuitOpenError,
    STANDARD_DEPS,
    all_breakers,
    get_breaker,
    reset_breakers,
)
from generativeaiexamples_tpu_torch.resilience.deadline import (
    Deadline,
    DeadlineExceeded,
    bind_deadline,
    current_deadline,
    deadline_scope,
)
from generativeaiexamples_tpu_torch.resilience.degrade import (
    DegradeLog,
    bind_degrade_log,
    current_degrade_log,
    degrade_scope,
    mark_degraded,
)
from generativeaiexamples_tpu_torch.resilience.faults import (
    FaultInjected,
    FaultInjector,
    get_fault_injector,
    inject,
    reset_faults,
)
from generativeaiexamples_tpu_torch.resilience.metrics import (
    record_degraded,
    record_deadline_expired,
    record_retry,
    reset_resilience,
    resilience_metrics_lines,
    resilience_snapshot,
)
from generativeaiexamples_tpu_torch.resilience.retry import (
    RetryBudget,
    RetryPolicy,
    policy_from_config,
)

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "STANDARD_DEPS",
    "all_breakers",
    "get_breaker",
    "reset_breakers",
    "Deadline",
    "DeadlineExceeded",
    "bind_deadline",
    "current_deadline",
    "deadline_scope",
    "DegradeLog",
    "bind_degrade_log",
    "current_degrade_log",
    "degrade_scope",
    "mark_degraded",
    "FaultInjected",
    "FaultInjector",
    "get_fault_injector",
    "inject",
    "reset_faults",
    "record_degraded",
    "record_deadline_expired",
    "record_retry",
    "reset_resilience",
    "resilience_metrics_lines",
    "resilience_snapshot",
    "RetryBudget",
    "RetryPolicy",
    "policy_from_config",
]
