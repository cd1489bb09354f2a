"""Serving for the port: the continuous-batching engine with its prefix
cache and fused mega-step, the crash-recoverable supervisor over it, the
fleet router over supervisors and the disaggregated prefill/decode tiers
with KV-chain migration."""

from .disagg import KVChainCodec, KVChainCorrupt, TieredRouter  # noqa: F401
from .fleet import FleetConfig, FleetRouter, ReplicaState  # noqa: F401
from .recovery import (JournalCorrupt, RequestJournal,  # noqa: F401
                       ServingSupervisor)
from .serving import (ContinuousBatchingEngine, EngineSaturated,  # noqa: F401
                      MeshDegraded, PrefixCacheConfig, Request, RequestShed)
