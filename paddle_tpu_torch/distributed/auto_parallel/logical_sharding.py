"""Logical-axis sharding rules — port of ``paddle_tpu/distributed/
auto_parallel/logical_sharding.py`` on DTensor.

Model code names each parameter and activation dimension with a logical
axis ("embed", "heads", "mlp", "vocab", "batch", "seq" ...); the rules
table (the JAX package's, unchanged) maps them onto mesh axes ("dp",
"fsdp", "sep", "tp", "ep"). Where JAX hands the result to GSPMD as a
``NamedSharding``, the port turns it into DTensor placements:
``shard_params`` makes each annotated parameter a DTensor with its
placements, and ``constrain`` is a ``redistribute`` (a no-op with no mesh
or on a plain tensor), so the collectives sit where the rules put them.

The mesh is a ``torch.distributed`` ``DeviceMesh``. ``make_mesh`` builds
it over the world's first ranks in row-major order, as the JAX package
lays devices out: the innermost axis ("tp") gets neighbouring ranks.

Every rank holds the whole tensor when it shards one (the model is built
from the same seed everywhere, or rank 0's weights are broadcast first)
and keeps its own chunk; nothing is scattered.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import Replicate as _DReplicate

from ...device import resolve_device
from .placement import PartitionSpec, spec_to_placements, \
    to_dtensor_placements

# logical axis -> mesh axis (or tuple of mesh axes); the JAX package's
# table (:24-44)
DEFAULT_RULES = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sep"),
    ("vocab", "tp"),
    # the input embedding's vocab dim stays whole (the table is still
    # fsdp-sharded along "embed")
    ("vocab_in", None),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("mlp", "tp"),
    ("expert", "ep"),
    ("expert_mlp", "tp"),
    ("head_dim", None),
    ("norm", None),
    # Megatron-SP residual stream: the sequence sharded over tp too
    ("seq_sp", ("sep", "tp")),
)

_state = threading.local()


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


def current_rules():
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(mesh, rules=None):
    """Activate a mesh and the logical->physical rules."""
    from .process_mesh import as_device_mesh

    prev = (current_mesh(), current_rules())
    _state.mesh = as_device_mesh(mesh)
    _state.rules = tuple(rules) if rules is not None else DEFAULT_RULES
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def logical_to_spec(axes: Sequence[Optional[str]], mesh=None,
                    rules=None) -> PartitionSpec:
    """Logical axis names as a PartitionSpec valid on ``mesh``: an axis
    with no rule, a rule to None, or a rule naming an axis the mesh lacks
    is unsharded, so the same model code runs on any mesh shape."""
    from .process_mesh import as_device_mesh

    mesh = as_device_mesh(mesh) if mesh is not None else current_mesh()
    rules = rules if rules is not None else current_rules()
    mesh_axes = set(_axis_names(mesh))
    table = dict(rules)
    entries = []
    used = set()
    for ax in axes:
        phys = table.get(ax) if ax is not None else None
        if phys is None:
            entries.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        keep = tuple(p for p in phys if p in mesh_axes and p not in used)
        used.update(keep)
        if not keep:
            entries.append(None)
        elif len(keep) == 1:
            entries.append(keep[0])
        else:
            entries.append(keep)
    return PartitionSpec(*entries)


def logical_placements(axes, mesh, rules=None) -> tuple:
    """The DTensor placements of ``axes`` on ``mesh``."""
    spec = logical_to_spec(axes, mesh, rules)
    return to_dtensor_placements(
        spec_to_placements(spec, _axis_names(mesh), len(axes)))


def annotate(param, *axes: Optional[str]):
    """Attach logical axis names (one per dim) to a parameter."""
    param.logical_axes = tuple(axes)
    return param


def param_sharding(param, mesh=None):
    """The DTensor placements of ``param`` by its logical axes on ``mesh``
    (None with no mesh)."""
    from .process_mesh import as_device_mesh

    mesh = as_device_mesh(mesh) if mesh is not None else current_mesh()
    if mesh is None:
        return None
    axes = getattr(param, "logical_axes", None) or (None,) * param.ndim
    return logical_placements(axes, mesh)


def local_chunk(full: torch.Tensor, mesh: DeviceMesh, placements):
    """This rank's chunk of ``full`` under ``placements`` (DTensor's
    ``torch.chunk`` layout, mesh axes in order)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not on the mesh")
    t = full
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            parts = list(torch.chunk(t, n, dim=p.dim))
            while len(parts) < n:
                shape = list(t.shape)
                shape[p.dim] = 0
                parts.append(t.new_empty(shape))
            t = parts[coord[i]]
        elif p.is_partial():
            raise ValueError("a whole tensor has no Partial placement")
    return t


def distribute(full: torch.Tensor, mesh: DeviceMesh, placements,
               requires_grad: bool = False) -> DTensor:
    """A DTensor of ``full`` (held whole by every rank) with
    ``placements``; no communication."""
    placements = to_dtensor_placements(placements)
    local = local_chunk(full.detach(), mesh, placements).contiguous()
    out = DTensor.from_local(local, mesh, placements, run_check=False,
                             shape=full.shape, stride=full.stride())
    return out.requires_grad_(requires_grad)


def _broadcast_whole(t: torch.Tensor, mesh: DeviceMesh):
    """Rank 0's value of ``t`` on every rank of a mesh that covers the
    world (a mesh over part of it relies on the seeded init)."""
    if dist.get_world_size() > 1 and mesh.size() == dist.get_world_size():
        dist.broadcast(t, src=0)


def _swap_param(module: nn.Module, name: str, p, mesh, memo):
    if id(p) in memo:
        module._parameters[name] = memo[id(p)]
        return
    placements = param_sharding(p, mesh)
    with torch.no_grad():
        whole = p.detach().clone()
        _broadcast_whole(whole, mesh)
        new = nn.Parameter(distribute(whole, mesh, placements),
                           requires_grad=p.requires_grad)
    new.__dict__.update(p.__dict__)
    module._parameters[name] = memo[id(p)] = new


def shard_params(layer: nn.Module, mesh=None):
    """Make every parameter (and each annotated buffer) of ``layer`` a
    DTensor placed by its logical axes; tied parameters stay one."""
    from .process_mesh import as_device_mesh

    mesh = as_device_mesh(mesh) if mesh is not None else current_mesh()
    if mesh is None:
        return layer
    memo = {}
    for module in layer.modules():
        for name, p in list(module._parameters.items()):
            if p is not None and not isinstance(p, DTensor):
                _swap_param(module, name, p, mesh, memo)
        for name, b in list(module._buffers.items()):
            if (b is not None and not isinstance(b, DTensor)
                    and getattr(b, "logical_axes", None) is not None):
                module._buffers[name] = distribute(
                    b, mesh, param_sharding(b, mesh))
    return layer


def constrain(x, *axes: Optional[str]):
    """Redistribute a DTensor to the placements of ``axes`` on the active
    mesh; a no-op with no mesh or on a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = logical_placements(axes, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gather_fsdp(p):
    """A weight whole over the "fsdp" axis at its use (ZeRO-3: the
    all-gather before the product, its backward a reduce-scatter); other
    placements, and a plain tensor, stay as they are."""
    if not isinstance(p, DTensor):
        return p
    names = _axis_names(p.device_mesh)
    want = tuple(_DReplicate() if n == "fsdp" and q.is_shard() else q
                 for n, q in zip(names, p.placements))
    if want == tuple(p.placements):
        return p
    return p.redistribute(p.device_mesh, want)


def make_mesh(shape_by_axis, devices=None) -> DeviceMesh:
    """A DeviceMesh from {"dp": 2, "fsdp": 2, "tp": 2, ...} (axes of size 1
    kept) over ranks 0 .. n-1 of the world, row-major. ``devices``: the
    device type ("cuda" or "cpu"; default: the port's current place).
    Every rank of the world calls it."""
    names = [n for n, _ in shape_by_axis.items()]
    sizes = [int(s) for _, s in shape_by_axis.items()]
    n = int(np.prod(sizes))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "init_parallel_env() first")
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    dev = (resolve_device(None).type if devices is None
           else torch.device(devices).type)
    return DeviceMesh(dev, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(names))
