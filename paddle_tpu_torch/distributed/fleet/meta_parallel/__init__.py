"""``distributed.fleet.meta_parallel``: the tensor-parallel layers. The
pipeline layers and engines, the rng tracker, segment parallelism and
fleet's sharding and tensor-parallel wrappers are later parts of item 6
and raise."""

from ..._refuse import FLEET, PP, RING, refuse
from .parallel_layers.mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)

#: name -> the part of item 6 that brings it
_LATER = {n: PP for n in (
    "LayerDesc", "PipelineLayer", "SharedLayerDesc", "RNGStatesTracker",
    "get_rng_state_tracker", "model_parallel_random_seed",
    "PipelineParallel", "pipeline_parallel", "gpipe_spmd")}
_LATER.update({"SegmentParallel": RING, "segment_parallel": RING})
_LATER.update({n: FLEET for n in (
    "ShardingParallel", "sharding_parallel", "TensorParallel",
    "tensor_parallel", "sharding")})


def __getattr__(name):
    if name in _LATER:
        raise refuse(f"fleet.meta_parallel.{name}", _LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
