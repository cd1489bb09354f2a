"""``paddle_tpu.distributed.resilience`` for the port: the fault plan and
the step watchdog that serving recovery consults, and the ``retry_call``
policy with its stats registry (which the serving engine's ``finished()``
and ``observability.retry_collector`` read). The trainer, the numeric
watchdog and the wire/numeric fault hooks are later slices."""

from .faults import (  # noqa: F401
    ComposedFaultPlan,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    active_plan,
    corrupt,
    device_loss,
    maybe_inject,
    resource_hold,
)
from .retry import (  # noqa: F401
    DEFAULT_POLICY,
    RetryError,
    RetryPolicy,
    backoff_delays,
    reset_retry_stats,
    retries_disabled,
    retry_call,
    retry_stats,
)
from .watchdog import StepWatchdog  # noqa: F401

__all__ = [
    "ComposedFaultPlan", "FaultInjected", "FaultPlan", "FaultSpec",
    "active_plan", "corrupt", "device_loss", "maybe_inject", "resource_hold",
    "DEFAULT_POLICY", "RetryError", "RetryPolicy", "backoff_delays",
    "retries_disabled", "retry_call", "retry_stats", "reset_retry_stats",
    "StepWatchdog",
]
