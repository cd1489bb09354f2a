"""``paddle_tpu.distributed.auto_parallel`` on DTensor: placements,
process meshes, the logical-axis rules, the semi-automatic API, the
``Engine`` and the pipeline schedules (``pipeline``)."""

from .api import (  # noqa: F401
    ShardingStage1,
    ShardingStage2,
    ShardingStage3,
    Strategy,
    dtensor_from_local,
    dtensor_to_local,
    get_mesh,
    reshard,
    set_mesh,
    shard_dataloader,
    shard_layer,
    shard_optimizer,
    shard_tensor,
    to_static,
    unshard_dtensor,
)
from . import pipeline  # noqa: F401
from .engine import Engine  # noqa: F401
from .logical_sharding import (  # noqa: F401
    DEFAULT_RULES,
    annotate,
    axis_rules,
    constrain,
    current_mesh,
    logical_to_spec,
    make_mesh,
    param_sharding,
    shard_params,
)
from .placement import Partial, Placement, Replicate, Shard  # noqa: F401
from .process_mesh import ProcessMesh, auto_mesh, get_current_mesh  # noqa: F401

ShardedTrainer = Engine

# the collective-cost programs of the static gates (item 9)
_GATES = {"comm_programs": "comm_programs", "train_step_comm":
          "comm_programs.train_step_comm", "moe_combine_comm":
          "comm_programs.moe_combine_comm"}


def __getattr__(name):
    from ..._later import later_slice

    if name in _GATES:
        raise later_slice(f"auto_parallel.{_GATES[name]} (the collective "
                          "gate's programs)", "static-gates", "9")
    if name == "serving_sharding":
        raise later_slice("auto_parallel.serving_sharding (the serving "
                          "mesh's rules)", "tp-sharded serving", "7")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
