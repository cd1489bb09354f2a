"""``paddle_tpu.observability`` for the port — telemetry for the serving
stack, with the JAX package's names and ``__all__``.

Three pillars:

1. **Metrics** — :class:`MetricsRegistry` with typed
   :class:`Counter`/:class:`Gauge`/:class:`Histogram` (fixed buckets, no
   unbounded state) and a pull-based collector protocol; the port's
   telemetry dicts (``engine.stats``, the ``retry_call`` registry,
   pool/radix occupancy, ``FleetRouter`` replica load) adapt in via
   :func:`engine_collector` / :func:`retry_collector` /
   :func:`supervisor_collector` / :func:`fleet_collector`.
   :class:`MetricsServer` serves the registry in Prometheus text format
   from a stdlib ``http.server`` thread; ``registry.dump()`` is the
   one-shot scrape, byte for byte the JAX package's text for the same
   operations.
2. **Tracing** — :class:`TraceRecorder` stamps host-side spans across the
   request lifecycle (submit → admit → prefill chunks → first token →
   decode → finish/evict/shed/failover/migrate), threaded through the
   engine, the supervisor (spans survive crash replay tagged
   ``recovered=true``, streamed tokens deduped against the journal
   high-water mark), the fleet (replica ids + failover edges) and the
   tiers (migration spans); exports chrome-trace JSON readable in
   Perfetto.
3. **SLO observatory** — open-loop seeded traffic
   (:func:`generate_schedule`, :class:`ReplayDriver`,
   :class:`VirtualClock`), windowed attainment and goodput
   (:class:`SLOMonitor`), and the SLO autoscaler
   (``paddle_tpu_torch.inference.autoscale``).

All recording is host-side and buffered: no stamp synchronizes the device
or runs inside a captured CUDA graph. ``procfleet_collector`` aggregates
the process fleet's workers' own registries; ``guard_collector`` and
``checkpoint_collector`` are later slices and raise
``NotImplementedError``.
"""

from .collectors import (checkpoint_collector, engine_collector,  # noqa: F401
                         fleet_collector, guard_collector,
                         procfleet_collector, retry_collector,
                         slo_collector, supervisor_collector,
                         tracer_collector)
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricFamily, MetricsRegistry,
                      parse_prometheus_text)
from .server import MetricsServer  # noqa: F401
from .slo import SLOConfig, SLOMonitor  # noqa: F401
from .tracing import TraceRecorder  # noqa: F401
from .workload import (ReplayDriver, ScheduledArrival,  # noqa: F401
                       TenantSpec, VirtualClock, WorkloadConfig,
                       decode_schedule, encode_schedule,
                       generate_schedule, schedule_digest)

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily",
           "MetricsRegistry", "MetricsServer", "ReplayDriver",
           "SLOConfig", "SLOMonitor", "ScheduledArrival", "TenantSpec",
           "TraceRecorder", "VirtualClock", "WorkloadConfig",
           "checkpoint_collector",
           "decode_schedule", "encode_schedule", "engine_collector",
           "fleet_collector", "generate_schedule", "guard_collector",
           "parse_prometheus_text", "procfleet_collector",
           "retry_collector", "schedule_digest", "slo_collector",
           "supervisor_collector", "tracer_collector"]
