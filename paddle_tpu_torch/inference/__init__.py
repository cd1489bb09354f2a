"""Serving for the port: the continuous-batching engine with its prefix
cache and fused mega-step, the crash-recoverable supervisor over it, the
fleet router over supervisors, the disaggregated prefill/decode tiers with
KV-chain migration and the SLO autoscaler over the fleet
(``AutoscaleConfig``, ``SLOAutoscaler``: loaded on first use, so importing
the serving modules never pulls the control loop in). Every layer takes
``tracer=`` (a ``paddle_tpu_torch.observability.TraceRecorder``)."""

from .disagg import KVChainCodec, KVChainCorrupt, TieredRouter  # noqa: F401
from .fleet import FleetConfig, FleetRouter, ReplicaState  # noqa: F401
from .recovery import (JournalCorrupt, RequestJournal,  # noqa: F401
                       ServingSupervisor)
from .serving import (ContinuousBatchingEngine, EngineSaturated,  # noqa: F401
                      MeshDegraded, PrefixCacheConfig, Request, RequestShed)

__all__ = ["AutoscaleConfig", "ContinuousBatchingEngine", "EngineSaturated",
           "FleetConfig", "FleetRouter", "JournalCorrupt", "KVChainCodec",
           "KVChainCorrupt", "MeshDegraded", "PrefixCacheConfig",
           "ReplicaState", "Request", "RequestJournal", "RequestShed",
           "SLOAutoscaler", "ServingSupervisor", "TieredRouter"]


def __getattr__(name):
    if name in ("AutoscaleConfig", "SLOAutoscaler"):
        from . import autoscale

        return getattr(autoscale, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
