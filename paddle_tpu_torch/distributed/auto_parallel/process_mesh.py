"""ProcessMesh — port of ``paddle_tpu/distributed/auto_parallel/
process_mesh.py`` over a ``torch.distributed`` ``DeviceMesh``.

A ProcessMesh is an N-d array of ranks with named axes; :meth:`to_torch`
builds the ``DeviceMesh`` (on the card, or on the CPU when the caller
asked for it), as the JAX package's ``to_jax`` builds a ``jax`` Mesh.
Building a ``DeviceMesh`` is a collective call: every rank of the world
makes it, in the same order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ...device import resolve_device


class ProcessMesh:
    def __init__(self, mesh=None, dim_names: Optional[Sequence[str]] = None,
                 shape=None, process_ids=None):
        if mesh is not None:
            arr = np.asarray(mesh)
        elif process_ids is not None:
            arr = np.asarray(process_ids).reshape(shape)
        else:
            arr = np.arange(int(np.prod(shape))).reshape(shape)
        self._ids = arr
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        self._dim_names = list(dim_names)
        self._device_mesh = None

    @property
    def shape(self) -> List[int]:
        return list(self._ids.shape)

    @property
    def ndim(self) -> int:
        return self._ids.ndim

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def process_ids(self) -> List[int]:
        return self._ids.reshape(-1).tolist()

    @property
    def mesh(self):
        return self._ids

    def get_dim_size(self, name) -> int:
        return self._ids.shape[self._dim_names.index(name)]

    def get_mesh_with_dim(self, dim_name, index=None):
        axis = self._dim_names.index(dim_name)
        moved = np.moveaxis(self._ids, axis, 0)
        names = [dim_name] + [n for n in self._dim_names if n != dim_name]
        if index is not None:
            return ProcessMesh(moved[index], names[1:])
        return ProcessMesh(moved, names)

    def to_torch(self) -> DeviceMesh:
        """The ``DeviceMesh`` over these ranks (built once)."""
        if self._device_mesh is None:
            if not dist.is_initialized():
                raise RuntimeError("a ProcessMesh needs the process group: "
                                   "call init_parallel_env() first")
            self._device_mesh = DeviceMesh(
                resolve_device(None).type, self._ids.tolist(),
                mesh_dim_names=tuple(self._dim_names))
        return self._device_mesh

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._ids, other._ids)
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._ids.tobytes(), tuple(self._dim_names)))

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self._dim_names})"

    def __enter__(self):
        _mesh_stack.append(self)
        return self

    def __exit__(self, *exc):
        _mesh_stack.pop()
        return False


_mesh_stack: List[ProcessMesh] = []


def get_current_mesh() -> Optional[ProcessMesh]:
    return _mesh_stack[-1] if _mesh_stack else None


def auto_mesh(dim_names: Sequence[str], shape: Sequence[int]) -> ProcessMesh:
    """A mesh over every rank of the world with the given shape."""
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"mesh size {n} != world size {world}")
    return ProcessMesh(np.arange(n).reshape(shape), dim_names)


def as_device_mesh(mesh) -> Optional[DeviceMesh]:
    """A ProcessMesh or a DeviceMesh as a DeviceMesh (None stays None)."""
    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh
    if isinstance(mesh, ProcessMesh):
        return mesh.to_torch()
    raise TypeError(f"not a mesh: {type(mesh).__name__}")
