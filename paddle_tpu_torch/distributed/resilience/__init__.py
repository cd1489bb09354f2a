"""``paddle_tpu.distributed.resilience`` for the port: the fault plan and
its hooks (serving, checkpoint and numeric sites), the ``retry_call``
policy with its stats registry, the step and numeric watchdogs, the
resilient trainer (``trainer.py``, ``elastic=None``), the checkpoint
lifecycle (``lifecycle.py``) and the bad-batch replay (``replay.py``).

The trainer and the lifecycle sit above ``distributed.checkpoint``, which
imports ``faults`` at load, so they (and the names beside them) load
lazily, as in the JAX package.
"""

from .faults import (  # noqa: F401
    ComposedFaultPlan,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    active_plan,
    corrupt,
    device_loss,
    maybe_inject,
    numeric_inject_code,
    poison_arrays,
    resource_hold,
    wire_faults,
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
from .watchdog import NumericWatchdog, StepWatchdog  # noqa: F401

__all__ = [
    "ComposedFaultPlan", "FaultInjected", "FaultPlan", "FaultSpec",
    "active_plan", "corrupt", "device_loss", "maybe_inject",
    "numeric_inject_code", "poison_arrays", "resource_hold", "wire_faults",
    "DEFAULT_POLICY", "RetryError", "RetryPolicy", "backoff_delays",
    "retries_disabled", "retry_call", "retry_stats", "reset_retry_stats",
    "ResilientTrainer", "NumericWatchdog", "StepWatchdog",
    "CheckpointCorruptionError", "EngineSaturated",
    "CheckpointPublisher", "StaleGenerationError", "lifecycle_stats",
    "reset_lifecycle_stats", "set_lifecycle_phase",
]


def __getattr__(name):
    if name == "ResilientTrainer":
        from .trainer import ResilientTrainer

        return ResilientTrainer
    if name == "CheckpointCorruptionError":
        from ..checkpoint.integrity import CheckpointCorruptionError

        return CheckpointCorruptionError
    if name == "StaleGenerationError":
        from ..checkpoint.latest import StaleGenerationError

        return StaleGenerationError
    if name == "EngineSaturated":
        from ...inference.serving import EngineSaturated

        return EngineSaturated
    if name in ("CheckpointPublisher", "lifecycle_stats",
                "reset_lifecycle_stats", "set_lifecycle_phase"):
        from . import lifecycle

        return getattr(lifecycle, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
