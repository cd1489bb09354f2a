"""``paddle_tpu.distributed.resilience`` for the port: the fault plan and
the step watchdog that serving recovery consults (the serving slice of
the JAX package's resilience layer; retry, the trainer, the numeric
watchdog and the wire/numeric fault hooks are later slices)."""

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
from .watchdog import StepWatchdog  # noqa: F401

__all__ = [
    "ComposedFaultPlan", "FaultInjected", "FaultPlan", "FaultSpec",
    "active_plan", "corrupt", "device_loss", "maybe_inject", "resource_hold",
    "StepWatchdog",
]
