"""Process groups — port of ``paddle_tpu/distributed/communication/
group.py`` on ``torch.distributed`` process groups.

The JAX package's ``Group`` is a handle onto a mesh axis; the port's wraps
a ``torch.distributed`` process group over its ranks (``pg``), made by
``new_group`` (a collective call: every rank of the world calls it, in
the same order, as ``torch.distributed.new_group`` requires). The default
group is the world that ``init_parallel_env`` started.
"""

from __future__ import annotations

from typing import List, Optional

import torch.distributed as dist


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    def __init__(self, ranks: List[int], gid: int = 0, pg=None):
        self.ranks = list(ranks)
        self.id = gid
        # the torch.distributed process group
        self.pg = pg

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def rank(self):
        return self.get_group_rank(dist.get_rank())

    def is_member(self):
        return dist.is_initialized() and dist.get_rank() in self.ranks

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_group_counter = [0]
_groups = {}
_default_group: Optional[Group] = None


def _require_init():
    if not dist.is_initialized():
        raise RuntimeError("the process group is not initialized: call "
                           "paddle_tpu_torch.distributed.init_parallel_env() "
                           "(or spawn) first")


def get_default_group() -> Group:
    global _default_group
    _require_init()
    if _default_group is None:
        _default_group = Group(list(range(dist.get_world_size())), 0,
                               pg=dist.group.WORLD)
        _groups[0] = _default_group
    return _default_group


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group over ``ranks`` (default: the world). Every rank of the world
    calls it, members or not."""
    _require_init()
    _group_counter[0] += 1
    gid = _group_counter[0]
    ranks = (list(range(dist.get_world_size())) if ranks is None
             else sorted(int(r) for r in ranks))
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks=ranks, backend=backend, **kw)
    g = Group(ranks, gid, pg=pg)
    _groups[gid] = g
    return g


def get_group(gid: int = 0) -> Optional[Group]:
    if gid == 0:
        return get_default_group()
    return _groups.get(gid)


def destroy_process_group(group=None):
    """Destroy ``group``'s process group, or with None every group and the
    world."""
    global _default_group
    if group is None:
        if dist.is_initialized():
            dist.destroy_process_group()
        _groups.clear()
        _default_group = None
    else:
        if group.pg is not None and group.pg is not dist.group.WORLD \
                and group.is_member():
            dist.destroy_process_group(group.pg)
        _groups.pop(group.id, None)


def is_initialized():
    return dist.is_initialized()
