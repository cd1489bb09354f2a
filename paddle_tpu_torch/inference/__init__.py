"""Serving for the port: the continuous-batching engine with its prefix
cache and fused mega-step, the crash-recoverable supervisor over it and
the fleet router over supervisors."""

from .fleet import FleetConfig, FleetRouter, ReplicaState  # noqa: F401
from .recovery import (JournalCorrupt, RequestJournal,  # noqa: F401
                       ServingSupervisor)
from .serving import (ContinuousBatchingEngine, EngineSaturated,  # noqa: F401
                      MeshDegraded, PrefixCacheConfig, Request, RequestShed)
