"""``paddle_tpu.distributed.communication`` on ``torch.distributed``."""

from .functional import *  # noqa: F401,F403
from .group import (Group, ReduceOp, destroy_process_group,  # noqa: F401
                    get_group, is_initialized, new_group)
from .._refuse import STORE, refuse

#: the TCP store and the collective watchdog over it (a later part of
#: item 6: the store, launch and elastic)
_LATER = {"store": STORE, "TCPStore": STORE, "watchdog": STORE,
          "CommTaskManager": STORE, "get_comm_task_manager": STORE}


def __getattr__(name):
    if name in _LATER:
        raise refuse(f"distributed.communication.{name}", _LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
