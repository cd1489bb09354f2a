"""The refusals of what is left of item 6 (distributed training), each
naming its part, so a caller learns which later slice brings it."""

from __future__ import annotations

from .._later import later_slice

#: the parts of item 6 that later slices bring, in ROADMAP order
EP = "MoE over an ep mesh"
PP_ZB_SELECTIVE = ("pipeline parallelism (pp): the zero-bubble schedule's "
                   "selective remat regime")
FLEET = "fleet and ZeRO (topology, meta_optimizers, group_sharded)"
STORE = "the store, launch and elastic"
PS = "ps, rpc and auto_tuner"


def refuse(what: str, part: str) -> NotImplementedError:
    """``what`` is not ported: the error names item 6 and ``part``."""
    return later_slice(what, "distributed-training", "6",
                       f"; it is item 6's part: {part}")
