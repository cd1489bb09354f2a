"""``paddle_tpu.distributed.fleet`` for the port: the tensor-parallel
layers (``meta_parallel``) and Megatron sequence parallelism
(``utils.sequence_parallel_utils``) on DTensor over the active mesh's
"tp" axis. ``fleet.init`` with its hybrid topology, the distributed model
and optimizer wrappers, ``meta_optimizers`` and fleet's recompute are
item 6's fleet part, ``elastic`` its store part: later slices, and they
raise."""

from .._refuse import FLEET, STORE, refuse
from . import meta_parallel, utils  # noqa: F401

#: name -> the part of item 6 that brings it
_LATER = {n: FLEET for n in (
    "init", "distributed_model", "distributed_optimizer",
    "get_hybrid_communicate_group", "DistributedStrategy",
    "CommunicateTopology", "HybridCommunicateGroup", "ParallelMode",
    "base", "fleet", "recompute", "recompute_sequential",
    "meta_optimizers")}
_LATER["elastic"] = STORE


def __getattr__(name):
    if name in _LATER:
        raise refuse(f"distributed.fleet.{name}", _LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
