"""Functional collectives — port of ``paddle_tpu/distributed/
communication/functional.py`` on ``torch.distributed``.

The JAX package runs one controller over every device and so has three
regimes (traced under ``shard_map``, eager single-controller, eager
multi-process). The port is SPMD: one process per rank, each holding its
own data, so every call here is the JAX package's third regime, the
per-rank semantics of Paddle's collectives: ``all_reduce`` sums the ranks'
tensors in place, ``all_gather`` fills a list with each rank's tensor, and
so on. Ranks are global ranks (``src``, ``dst``, ``peer``), as in Paddle.
A call with ``sync_op=False`` returns the ``torch.distributed`` work
handle; otherwise a finished task.

gloo (the CPU backend) has no ``AVG``: the sum is divided by the group's
size. ``alltoall`` over a list runs one ``all_to_all_single`` of the
stacked list, which gloo takes. ``ppermute`` and ``axis_index`` are the
JAX package's traced forms inside ``shard_map``; their one user is ring
attention, a later part of item 6, and they raise.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .._refuse import RING, refuse
from .group import _TORCH_OPS, Group, ReduceOp, get_default_group


class _Done:
    def wait(self):
        return None

    def is_completed(self):
        return True


def _pg(group: Optional[Group]):
    g = group if group is not None else get_default_group()
    return g, g.pg


def _task(work, sync_op):
    if sync_op or work is None:
        if work is not None:
            work.wait()
        return _Done()
    return work


def _op(op):
    try:
        return _TORCH_OPS[ReduceOp.SUM if op == ReduceOp.AVG else op]
    except KeyError:
        raise ValueError(f"unknown reduce op {op!r}") from None


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    g, pg = _pg(group)
    work = dist.all_reduce(tensor, op=_op(op), group=pg, async_op=True)
    if op == ReduceOp.AVG:
        work.wait()
        tensor.div_(g.nranks)
        return _Done()
    return _task(work, sync_op)


def all_gather(tensor_list: Optional[List], tensor, group=None,
               sync_op=True, axis=0):
    """Each rank's ``tensor``, in rank order, into ``tensor_list`` (cleared
    first); with ``tensor_list`` None, returned."""
    g, pg = _pg(group)
    parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
    dist.all_gather(parts, tensor.contiguous(), group=pg)
    if tensor_list is not None:
        tensor_list.clear()
        tensor_list.extend(parts)
        return _Done()
    return parts


def all_gather_into_tensor(out_tensor, tensor, group=None, sync_op=True):
    g, pg = _pg(group)
    if out_tensor is None:
        out_tensor = tensor.new_empty((tensor.shape[0] * g.nranks,)
                                      + tuple(tensor.shape[1:]))
        dist.all_gather_into_tensor(out_tensor, tensor.contiguous(),
                                    group=pg)
        return out_tensor
    work = dist.all_gather_into_tensor(out_tensor, tensor.contiguous(),
                                       group=pg, async_op=True)
    return _task(work, sync_op)


def all_gather_object(object_list, obj, group=None):
    g, pg = _pg(group)
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=pg)
    object_list.clear()
    object_list.extend(out)


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """``tensor`` := this rank's chunk (dim 0) of the ranks' reduced input
    (a tensor, or a list of one chunk per rank)."""
    g, pg = _pg(group)
    if isinstance(tensor_or_tensor_list, (list, tuple)):
        x = torch.cat([t.contiguous() for t in tensor_or_tensor_list])
    else:
        x = tensor_or_tensor_list.contiguous()
    dist.reduce_scatter_tensor(tensor, x, op=_op(op), group=pg)
    if op == ReduceOp.AVG:
        tensor.div_(g.nranks)
    return _Done()


def broadcast(tensor, src=0, group=None, sync_op=True):
    _, pg = _pg(group)
    return _task(dist.broadcast(tensor, src=src, group=pg, async_op=True),
                 sync_op)


def broadcast_object_list(object_list, src=0, group=None):
    _, pg = _pg(group)
    dist.broadcast_object_list(object_list, src=src, group=pg)
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    g, pg = _pg(group)
    dist.reduce(tensor, dst=dst, op=_op(op), group=pg)
    if op == ReduceOp.AVG and dist.get_rank() == dst:
        tensor.div_(g.nranks)
    return _Done()


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    _, pg = _pg(group)
    parts = ([t.contiguous() for t in tensor_list]
             if dist.get_rank() == src else None)
    dist.scatter(tensor, parts, src=src, group=pg)
    return _Done()


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    _, pg = _pg(group)
    out = [None]
    dist.scatter_object_list(out, in_object_list
                             if dist.get_rank() == src else None,
                             src=src, group=pg)
    out_object_list.clear()
    out_object_list.append(out[0])


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank i's j-th input goes to rank j's i-th output (equal shapes)."""
    _, pg = _pg(group)
    x = (torch.stack([t for t in in_tensor_list])
         if isinstance(in_tensor_list, (list, tuple)) else in_tensor_list)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=pg)
    parts = list(out.unbind(0))
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(parts)
        return _Done()
    return parts


all_to_all = alltoall


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    _, pg = _pg(group)
    if out_tensor is None:
        if out_split_sizes:
            shape = (sum(out_split_sizes),) + tuple(in_tensor.shape[1:])
            out_tensor = in_tensor.new_empty(shape)
        else:
            out_tensor = torch.empty_like(in_tensor)
        dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                               out_split_sizes, in_split_sizes, group=pg)
        return out_tensor
    work = dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                                  out_split_sizes, in_split_sizes, group=pg,
                                  async_op=True)
    return _task(work, sync_op)


all_to_all_single = alltoall_single


def send(tensor, dst=0, group=None, sync_op=True):
    _, pg = _pg(group)
    if sync_op:
        dist.send(tensor.contiguous(), dst=dst, group=pg)
        return _Done()
    return dist.isend(tensor.contiguous(), dst=dst, group=pg)


def recv(tensor, src=0, group=None, sync_op=True):
    _, pg = _pg(group)
    if sync_op:
        dist.recv(tensor, src=src, group=pg)
        return _Done()
    return dist.irecv(tensor, src=src, group=pg)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """``isend`` or ``irecv`` of ``tensor`` with ``peer``, for
    :func:`batch_isend_irecv`."""

    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    ops = []
    for p in p2p_op_list:
        fn = dist.isend if p.op in (isend, dist.isend, send) else dist.irecv
        _, pg = _pg(p.group)
        ops.append(dist.P2POp(fn, p.tensor, p.peer, group=pg))
    return dist.batch_isend_irecv(ops)


def barrier(group=None):
    from ..resilience import faults as _faults

    # fault site: a delayed collective (the watchdog and retry drills)
    _faults.maybe_inject("collective", "barrier")
    _, pg = _pg(group)
    dist.barrier(group=pg)
    return _Done()


def ppermute(x, axis_name, perm):
    raise refuse("ppermute (a traced ring step)", RING)


def axis_index(axis_name):
    raise refuse("axis_index (a traced ring step)", RING)
