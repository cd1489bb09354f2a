"""``paddle_tpu.distributed`` for the port, on ``torch.distributed``.

One process per rank (``init_parallel_env``, ``spawn``): the collectives
of ``communication``, the process meshes, placements and logical-axis
rules of ``auto_parallel`` on DTensor, the ``Engine`` over dp/fsdp/tp
meshes with Megatron sequence parallelism, over sep (ring attention) and
over pp (``auto_parallel.pipeline``: GPipe, VPP, zero-bubble), the
tensor- and sequence-parallel layers, the pipeline layers and
``SegmentParallel`` of ``fleet``, the differentiable ``ppermute``, and
the sharded checkpoints of ``checkpoint``, which reshard on load, with
the generation-fenced ``LATEST`` pointer, and the numeric guard with its
resilience trainer and checkpoint publisher (``resilience``). What is
left of item 6 raises ``later_slice`` naming its part: the store (with
the collective watchdog ``CommTaskManager``), ``ps``/``rpc``,
``sharding`` (group_sharded) and the MoE ``utils``.
"""

from . import auto_parallel, checkpoint, communication, fleet  # noqa: F401
from . import parallel, resilience  # noqa: F401
from ..framework.numeric_guard import (  # noqa: F401
    BadBatchRecorder,
    GuardPolicy,
    NumericAnomalyError,
)
from ._refuse import EP, FLEET, PS, STORE, refuse
from .auto_parallel import (  # noqa: F401
    Engine,
    Partial,
    Placement,
    ProcessMesh,
    Replicate,
    Shard,
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
from .checkpoint import (  # noqa: F401
    CheckpointCorruptionError,
    StaleGenerationError,
    load_state_dict,
    save_state_dict,
    wait_async_save,
)
from .communication.functional import (  # noqa: F401
    P2POp,
    all_gather,
    all_gather_into_tensor,
    all_gather_object,
    all_reduce,
    all_to_all,
    all_to_all_single,
    alltoall,
    alltoall_single,
    barrier,
    batch_isend_irecv,
    broadcast,
    broadcast_object_list,
    irecv,
    isend,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    scatter_object_list,
    send,
)
from .communication.group import (  # noqa: F401
    Group,
    ReduceOp,
    destroy_process_group,
    get_group,
    new_group,
)
from .parallel import (  # noqa: F401
    DataParallel,
    ParallelEnv,
    get_rank,
    get_world_size,
    init_parallel_env,
    is_initialized,
    spawn,
)

from .resilience import NumericWatchdog  # noqa: F401
from .resilience.lifecycle import CheckpointPublisher  # noqa: F401
from .resilience.trainer import ResilientTrainer  # noqa: F401

#: JAX names a later part of item 6 brings: name -> part
_LATER = {
    "CommTaskManager": STORE, "get_comm_task_manager": STORE,
    "TCPStore": STORE, "launch": STORE, "ps": PS, "rpc": PS,
    "auto_tuner": PS, "sharding": FLEET, "utils": EP,
}


def __getattr__(name):
    if name in _LATER:
        raise refuse(f"paddle_tpu_torch.distributed.{name}", _LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
