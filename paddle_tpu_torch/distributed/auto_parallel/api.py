"""The semi-automatic parallel API — port of ``paddle_tpu/distributed/
auto_parallel/api.py`` on DTensor.

A distributed tensor is a ``torch.distributed.tensor.DTensor``: its
global shape, its mesh and its placements (Paddle's ``Shard``/
``Replicate``/``Partial`` are taken or DTensor's). The port is SPMD, so
``shard_tensor`` takes the whole tensor that every rank holds and keeps
the rank's chunk; ``dtensor_from_local`` takes each rank's own chunk;
``reshard`` is ``redistribute`` (``Partial`` -> ``Replicate`` is the
all-reduce, ``Shard`` -> ``Replicate`` the all-gather). ``to_static`` over
a mesh, a compiled mesh step, is later work and raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from .._refuse import refuse
from .logical_sharding import distribute
from .placement import (Placement, Replicate, Shard,  # noqa: F401
                        to_dtensor_placements)
from .process_mesh import ProcessMesh, as_device_mesh


def shard_tensor(data, mesh, placements: Sequence, dtype=None,
                 stop_gradient=None):
    """``data`` (the whole tensor, the same on every rank) placed on
    ``mesh`` (a ProcessMesh or DeviceMesh) with ``placements``."""
    t = data if isinstance(data, torch.Tensor) else torch.as_tensor(data)
    if dtype is not None:
        from ...device import resolve_dtype

        t = t.to(resolve_dtype(dtype) if isinstance(dtype, str) else dtype)
    dm = as_device_mesh(mesh)
    if isinstance(t, DTensor):
        return reshard(t, dm, placements)
    t = t.to(dm.device_type)
    grad = (t.requires_grad if stop_gradient is None
            else not stop_gradient)
    if isinstance(data, nn.Parameter):
        return nn.Parameter(distribute(t, dm, placements),
                            requires_grad=grad)
    return distribute(t, dm, placements, requires_grad=grad)


def dtensor_from_local(local_tensor, mesh, placements):
    """A DTensor from each rank's own chunk (shapes assumed even)."""
    return DTensor.from_local(local_tensor, as_device_mesh(mesh),
                              to_dtensor_placements(placements),
                              run_check=False)


def dtensor_to_local(dist_tensor, mesh=None, placements=None):
    return dist_tensor.to_local()


def reshard(dist_tensor, mesh, placements: Sequence):
    """The tensor with new placements (DTensor's ``redistribute``)."""
    return dist_tensor.redistribute(as_device_mesh(mesh),
                                    to_dtensor_placements(placements))


def shard_layer(layer: nn.Module, process_mesh, shard_fn=None,
                input_fn=None, output_fn=None) -> nn.Module:
    """Place a layer's parameters on a mesh: ``shard_fn(name, sublayer,
    mesh)`` per sublayer, by default every parameter replicated."""
    mesh = process_mesh

    if shard_fn is None:
        def shard_fn(name, sublayer, mesh):
            dm = as_device_mesh(mesh)
            for pname, p in list(sublayer._parameters.items()):
                if p is not None and not isinstance(p, DTensor):
                    sublayer._parameters[pname] = shard_tensor(
                        p, dm, [Replicate()] * dm.ndim)

    for name, sub in list(layer.named_modules()):
        shard_fn(name, sub, mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(lambda l, inp: input_fn(inp, mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda l, inp, out: output_fn(out, mesh))
    return layer


def shard_optimizer(optimizer, shard_fn=None, gradient_accumulation_steps=1):
    """Accumulators placed like their parameter (ZeRO by the parameter's
    own sharding), or as ``shard_fn(name, param, acc)`` places them."""
    orig_acc = optimizer._acc

    def _acc(name, p, fill=0.0, shape=None):
        d = optimizer._accumulators.setdefault(name, {})
        if p in d:
            return d[p]
        if not isinstance(p, DTensor):
            return orig_acc(name, p, fill, shape)
        whole = torch.full(tuple(p.shape) if shape is None else shape, fill,
                           dtype=torch.float32, device=p.device)
        if shard_fn is not None:
            acc = shard_fn(name, p, whole)
        elif whole.ndim == p.ndim:
            acc = distribute(whole, p.device_mesh, p.placements)
        else:
            acc = distribute(whole, p.device_mesh,
                             [Replicate()] * p.device_mesh.ndim)
        d[p] = acc
        return acc

    optimizer._acc = _acc
    return optimizer


class ShardingStage1:
    """Paddle's ``ShardingStage*`` for ``shard_optimizer(shard_fn=)``: an
    accumulator sharded along dim 0 over ``axis_name``."""

    def __init__(self, axis_name="dp", mesh=None):
        self.axis_name = axis_name
        self.mesh = mesh

    def __call__(self, key, param, acc):
        dm = (as_device_mesh(self.mesh) if self.mesh is not None
              else getattr(param, "device_mesh", None))
        if dm is None:
            return acc
        placements = [Shard(0) if n == self.axis_name and acc.ndim > 0
                      else Replicate() for n in dm.mesh_dim_names]
        return shard_tensor(acc, dm, placements)


ShardingStage2 = ShardingStage1


class ShardingStage3(ShardingStage1):
    pass


def unshard_dtensor(dist_tensor):
    """The whole tensor on every rank."""
    if isinstance(dist_tensor, DTensor):
        return dist_tensor.full_tensor()
    return dist_tensor


def get_mesh():
    from .process_mesh import get_current_mesh

    return get_current_mesh()


def set_mesh(mesh):
    from .process_mesh import _mesh_stack

    _mesh_stack.clear()
    _mesh_stack.append(mesh)


def shard_dataloader(dataloader, meshes, shard_dims=None, input_keys=None):
    """A loader whose batches are sharded on dim 0 over ``shard_dims`` (a
    mesh axis name; None: every axis); each rank's loader yields the whole
    batch, as every rank holds it."""
    mesh = meshes[0] if isinstance(meshes, (list, tuple)) else meshes
    dim = (shard_dims if isinstance(shard_dims, str)
           else (shard_dims[0] if shard_dims else None))

    class _ShardedLoader:
        def __init__(self, inner):
            self._inner = inner

        def __iter__(self):
            for batch in self._inner:
                yield self._shard(batch)

        def __len__(self):
            return len(self._inner)

        def _shard(self, item):
            if isinstance(item, torch.Tensor):
                dm = as_device_mesh(mesh)
                placements = [Shard(0) if item.ndim > 0
                              and (dim is None or n == dim) else Replicate()
                              for n in dm.mesh_dim_names]
                return shard_tensor(item, dm, placements)
            if isinstance(item, (list, tuple)):
                return type(item)(self._shard(i) for i in item)
            if isinstance(item, dict):
                return {k: self._shard(v) for k, v in item.items()}
            return item

    return _ShardedLoader(dataloader)


class Strategy:
    """Paddle's ``auto_parallel.Strategy`` config tree."""

    class _Cfg:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    def __init__(self, config=None):
        self.sharding = Strategy._Cfg(enable=False, degree=1, stage=1)
        self.fused_passes = Strategy._Cfg(enable=False, fused_passes_list=[])
        self.pipeline = Strategy._Cfg(enable=False, schedule_mode="1F1B",
                                      micro_batch_size=1, accumulate_steps=1)
        self.amp = Strategy._Cfg(enable=False, dtype="bfloat16", level="O1")
        self.recompute = Strategy._Cfg(enable=False)
        if config:
            for k, v in config.items():
                if hasattr(self, k) and isinstance(v, dict):
                    getattr(self, k).__dict__.update(v)


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              input_spec=None):
    raise refuse("auto_parallel.to_static (a compiled mesh step)",
                 "a compiled mesh step")


__all__ = ["ProcessMesh", "Placement", "Shard", "Replicate",
           "shard_tensor", "dtensor_from_local", "dtensor_to_local",
           "reshard", "shard_layer", "shard_optimizer", "ShardingStage1",
           "ShardingStage2", "ShardingStage3", "unshard_dtensor",
           "get_mesh", "set_mesh", "shard_dataloader", "Strategy",
           "to_static"]
