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
stacked list, which gloo takes.

``ppermute`` and ``axis_index`` are the JAX package's ``shard_map`` forms
(``lax.ppermute``, ``lax.axis_index``) over a named dim of a
``DeviceMesh`` (the active one of ``axis_rules`` unless ``mesh=`` names
another): ``ppermute`` sends this rank's tensor along (src, dst) pairs of
coordinates on that dim, a rank that is no pair's destination gets
zeros, and its gradient is the same exchange along the inverted pairs.
Ring attention rotates K/V with it and the pipelines move activations
with it. Its transport is chosen by the dim's backend, once: NCCL takes
CUDA tensors as they are; gloo's point-to-point calls get host copies of
CUDA tensors (its collectives take CUDA tensors, its send/recv are not
relied on for them), and CPU tensors as they are.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

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


class MeshAxis:
    """One named dim of a ``DeviceMesh`` as this rank sees it: its process
    group, the global ranks along it in coordinate order, this rank's
    coordinate, and whether point-to-point calls stage CUDA tensors
    through host memory (gloo)."""

    def __init__(self, mesh, name):
        names = tuple(mesh.mesh_dim_names or ())
        if name not in names:
            raise ValueError(f"mesh axes {names} have no {name!r}")
        dim = names.index(name)
        coord = mesh.get_coordinate()
        if coord is None:
            raise RuntimeError("this rank is not on the mesh")
        # the ranks along `dim` with every other coordinate this rank's
        idx = list(coord)
        self.ranks = []
        for j in range(mesh.size(dim)):
            idx[dim] = j
            self.ranks.append(int(mesh.mesh[tuple(idx)]))
        self.name, self.size, self.index = name, mesh.size(dim), coord[dim]
        self.group = mesh.get_group(dim)
        self.device_type = mesh.device_type
        self.host_staged = dist.get_backend(self.group) == "gloo"


def mesh_axis(axis_name, mesh=None) -> MeshAxis:
    """The :class:`MeshAxis` of ``axis_name`` on ``mesh`` (default: the
    active mesh of ``axis_rules``)."""
    if isinstance(axis_name, MeshAxis):
        return axis_name
    if mesh is None:
        from ..auto_parallel.logical_sharding import current_mesh
        mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"no mesh for axis {axis_name!r}: pass mesh= or "
                         f"call inside axis_rules(mesh)")
    return MeshAxis(mesh, axis_name)


def _check_perm(perm, n):
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute pairs {perm} are not a partial "
                         f"permutation of {n} coordinates")


def exchange(x, axis: MeshAxis, perm):
    """One ``ppermute`` step on a local tensor (no autograd): ``x`` goes to
    every coordinate this rank is the source of, and the result is what
    this rank is the destination of, or zeros. Every rank of the dim calls
    it with the same pairs; a rank named in no pair sends and receives
    nothing."""
    me = axis.index
    to = [d for s, d in perm if s == me]
    frm = [s for s, d in perm if d == me]
    if not to and not frm:
        return torch.zeros_like(x)
    if to == [me]:
        return x.clone()
    stage = axis.host_staged and x.device.type == "cuda"
    ops, buf = [], None
    if to:
        src = x.detach().contiguous()
        if stage:
            src = src.cpu()
        ops.append(dist.P2POp(dist.isend, src, axis.ranks[to[0]],
                              group=axis.group))
    if frm:
        buf = torch.empty(x.shape, dtype=x.dtype,
                          device="cpu" if stage else x.device)
        ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[frm[0]],
                              group=axis.group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    exchange.sends += bool(to)
    exchange.recvs += bool(frm)
    if buf is None:
        return torch.zeros_like(x)
    return buf.to(x.device, non_blocking=False) if stage else buf


#: point-to-point sends and receives ``exchange`` made (a profile reads
#: them per step)
exchange.sends = 0
exchange.recvs = 0


class _PPermute(torch.autograd.Function):
    """``exchange`` with the inverted pairs as its backward (``lax.
    ppermute``'s transpose). ``links`` (tensors that take no gradient)
    put the exchange on the path to them: ``torch.autograd.grad`` runs
    only the nodes that lead to its ``inputs``, and a rank that only
    receives must still run this backward, which sends the cotangent."""

    @staticmethod
    def forward(ctx, x, axis, perm, *links):
        ctx.axis, ctx.perm, ctx.n = axis, perm, len(links)
        return exchange(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return (exchange(g, ctx.axis, inv), None, None) + (None,) * ctx.n


class _Anchor(torch.autograd.Function):
    """``out`` itself, with ``others`` as inputs whose gradient is zero:
    in SPMD autograd a rank's backward runs only the exchanges its own
    output depends on, so an exchange whose result this rank does not use
    (a sender's, whose value the receiver uses) is anchored to the output
    to run its backward exchange as its peers do."""

    @staticmethod
    def forward(ctx, out, *others):
        ctx.n = len(others)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * ctx.n


def anchor(out, *others):
    """``out``, with the unused exchange results ``others`` on its
    backward path (see :class:`_Anchor`)."""
    others = [t for t in others if t.requires_grad]
    return _Anchor.apply(out, *others) if others else out


def ppermute(x, axis_name, perm, mesh=None):
    """``lax.ppermute(x, axis_name, perm)`` (:337) on this rank's tensor:
    ``perm`` is a list of (src, dst) coordinates on the mesh dim
    ``axis_name``; differentiable. A DTensor is exchanged by its local
    tensor and keeps its placements."""
    from torch.distributed.tensor import DTensor

    axis = mesh_axis(axis_name, mesh)
    perm = [(int(s), int(d)) for s, d in perm]
    _check_perm(perm, axis.size)
    if isinstance(x, DTensor):
        out = _PPermute.apply(x.to_local(), axis, perm)
        return DTensor.from_local(out, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return _PPermute.apply(x, axis, perm)


def axis_index(axis_name, mesh=None):
    """``lax.axis_index(axis_name)`` (:342): this rank's coordinate on the
    mesh dim, an int32 0-d tensor on the mesh's device."""
    axis = mesh_axis(axis_name, mesh)
    from ...device import resolve_device
    dev = (resolve_device(None) if axis.device_type == "cuda"
           else torch.device(axis.device_type))
    return torch.tensor(axis.index, dtype=torch.int32, device=dev)
