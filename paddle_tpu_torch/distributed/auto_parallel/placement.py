"""Placements — port of ``paddle_tpu/distributed/auto_parallel/
placement.py``.

``Shard(d)``, ``Replicate()`` and ``Partial()`` say what one mesh axis
does to a tensor, as in Paddle; each maps one-to-one onto DTensor's
placement of the same name (:func:`to_dtensor_placements`,
:func:`from_dtensor_placements`). ``placements_to_spec`` and
``spec_to_placements`` convert to and from a per-tensor-dim
:class:`PartitionSpec` (a tuple: the mesh axis name, a tuple of names, or
None per dim), the JAX package's ``PartitionSpec``.
"""

from __future__ import annotations

from typing import List, Sequence

from torch.distributed import tensor as _dt


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names (major first) or
    None; equal, entry by entry, to the JAX ``PartitionSpec`` of the same
    sharding."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = dim

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __eq__(self, o):
        return isinstance(o, Shard) and o.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __eq__(self, o):
        return isinstance(o, Replicate)

    def __hash__(self):
        return hash("replicate")

    def __repr__(self):
        return "Replicate()"


class Partial(Placement):
    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __eq__(self, o):
        return isinstance(o, Partial) and o.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))

    def __repr__(self):
        return f"Partial({self.reduce_type})"


def to_dtensor_placements(placements: Sequence) -> tuple:
    """Paddle placements as DTensor's (DTensor's pass through)."""
    out = []
    for p in placements:
        if isinstance(p, Shard):
            out.append(_dt.Shard(p.dim))
        elif isinstance(p, Replicate):
            out.append(_dt.Replicate())
        elif isinstance(p, Partial):
            out.append(_dt.Partial(p.reduce_type))
        elif isinstance(p, _dt.Placement):
            out.append(p)
        else:
            raise TypeError(f"not a placement: {p!r}")
    return tuple(out)


def from_dtensor_placements(placements: Sequence) -> List[Placement]:
    """DTensor placements as Paddle's."""
    out: List[Placement] = []
    for p in placements:
        if p.is_shard():
            out.append(Shard(p.dim))
        elif p.is_partial():
            out.append(Partial(getattr(p, "reduce_op", "sum")))
        else:
            out.append(Replicate())
    return out


def placements_to_spec(placements: Sequence[Placement],
                       mesh_dim_names: Sequence[str],
                       ndim: int) -> PartitionSpec:
    """Per-mesh-axis placements as a per-tensor-dim spec."""
    entries: List = [None] * ndim
    for axis_name, p in zip(mesh_dim_names, placements):
        if p.is_shard():
            d = p.dim % ndim
            if entries[d] is None:
                entries[d] = axis_name
            elif isinstance(entries[d], tuple):
                entries[d] = entries[d] + (axis_name,)
            else:
                entries[d] = (entries[d], axis_name)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def spec_to_placements(spec, mesh_dim_names: Sequence[str],
                       ndim: int) -> List[Placement]:
    out: List[Placement] = [Replicate() for _ in mesh_dim_names]
    names = list(mesh_dim_names)
    for tdim, e in enumerate(list(spec) if spec is not None else []):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            # DTensor shards a dim over several mesh axes in mesh order
            raise ValueError(f"spec entry {e!r} names its axes against the "
                             f"mesh order {tuple(names)}")
        for i in pos:
            out[i] = Shard(tdim)
    return out
