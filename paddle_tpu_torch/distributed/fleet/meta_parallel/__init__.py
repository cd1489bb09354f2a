"""``distributed.fleet.meta_parallel``: the tensor-parallel layers, the
pipeline layers and engine (``PipelineLayer``, ``PipelineParallel``,
``gpipe_spmd``), the model-parallel RNG tracker and ``SegmentParallel``.
fleet's sharding and tensor-parallel wrappers are a later part of item 6
and raise."""

from ..._refuse import FLEET, refuse
from .parallel_layers.mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .parallel_layers.pp_layers import (  # noqa: F401
    LayerDesc,
    PipelineLayer,
    SharedLayerDesc,
)
from .parallel_layers.random import (  # noqa: F401
    RNGStatesTracker,
    get_rng_state_tracker,
    model_parallel_random_seed,
)
from . import pipeline_parallel, segment_parallel  # noqa: F401
from .pipeline_parallel import PipelineParallel, gpipe_spmd  # noqa: F401
from .segment_parallel import SegmentParallel  # noqa: F401

#: name -> the part of item 6 that brings it
_LATER = {n: FLEET for n in (
    "ShardingParallel", "sharding_parallel", "TensorParallel",
    "tensor_parallel", "sharding")}


def __getattr__(name):
    if name in _LATER:
        raise refuse(f"fleet.meta_parallel.{name}", _LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
