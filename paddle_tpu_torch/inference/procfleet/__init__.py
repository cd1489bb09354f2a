"""paddle_tpu_torch.inference.procfleet — process-per-replica serving —
port of ``paddle_tpu/inference/procfleet``.

The fleet and tiered routers and the SLO autoscaler gain REAL replica
isolation: each replica is a spawned worker process owning its own engine,
CUDA context, device memory and journal, driven over a crc-framed
localhost wire protocol. Replica death is process death: a SIGKILLed
worker's unfinished work re-admits on survivors byte-identically from its
on-disk journal, and a CUDA fault in one worker leaves the others and the
driver running.

Modules:

- :mod:`~.wire` — the PT-PROC framed message protocol
  (:class:`WireCorrupt` = PT-PROC-001), byte for byte the JAX package's.
- :mod:`~.transport` — the pluggable frame transport seam
  (:class:`TcpTransport`, :class:`LoopbackTransport` for in-process
  thread workers, and the fault-injecting :class:`ChaosTransport` driven
  by the ``net.*`` fault-plan sites).
- :mod:`~.worker` — the spawned replica process (:class:`WorkerSpec`,
  ``worker_main``) and its loopback thread twin (``worker_thread_main``).
- :mod:`~.proxy` — the driver-side replica proxy (:class:`ProcReplica`,
  :class:`WorkerDead` = PT-PROC-002/003, the per-peer
  :class:`CircuitBreaker` raising :class:`BreakerOpen` = PT-PROC-004).
- :mod:`~.router` — :class:`ProcFleetRouter` / :class:`ProcTieredRouter`
  over :class:`ProcFleetConfig`.
- :mod:`~.presets` — picklable worker engine factories.

The wire/transport/proxy layer is host control plane (stdlib only);
workers import torch in their OWN process.
"""

from .proxy import (BreakerOpen, CircuitBreaker, MeshMismatch,  # noqa: F401
                    ProcReplica, WorkerDead)
from .router import (ProcFleetConfig, ProcFleetRouter,  # noqa: F401
                     ProcTieredRouter)
from .transport import (ChaosTransport, LoopbackTransport,  # noqa: F401
                        TcpTransport, Transport, loopback_pair)
from .wire import Message, WireClosed, WireCorrupt  # noqa: F401
from .worker import WorkerSpec, worker_main, worker_thread_main  # noqa: F401

__all__ = ["BreakerOpen", "ChaosTransport", "CircuitBreaker",
           "LoopbackTransport", "Message", "MeshMismatch", "ProcFleetConfig",
           "ProcFleetRouter", "ProcReplica", "ProcTieredRouter",
           "TcpTransport", "Transport", "WireClosed", "WireCorrupt",
           "WorkerDead", "WorkerSpec", "loopback_pair", "worker_main",
           "worker_thread_main"]
