"""Megatron sequence parallelism — port of ``paddle_tpu/distributed/
fleet/utils/sequence_parallel_utils.py`` on DTensor.

Activations ``[b, s, h]`` live sequence-sharded over the active mesh's tp
axis between the tensor-parallel regions. ``ScatterOp`` shards the
sequence (its backward gathers), ``GatherOp``/``AllGatherOp`` gather it
(their backward reduce-scatters), ``ReduceScatterOp`` reduces partial sums
into sequence shards: each is a DTensor ``redistribute`` over tp.
``ColumnSequenceParallelLinear`` gathers its sequence-sharded input into
a column-parallel product; ``RowSequenceParallelLinear`` reduce-scatters
its row-parallel product back to sequence shards. A replicated
parameter's gradient from a sequence-parallel region comes back as
partial sums that the engine (or ``reshard``) reduces, so the hooks that
Paddle registers for it have nothing to do, as in the JAX package.
"""

from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

from ....nn import functional as F
from ....nn import initializer as I
from ....nn.layer.layers import Layer
from ..meta_parallel.parallel_layers.mp_layers import (_dt, _mp_info,
                                                       _on_tp, _place)

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "mark_as_sequence_parallel_parameter",
    "register_sequence_parallel_allreduce_hooks",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
]


def _seq(x, shard: bool):
    mesh, tp = _mp_info()
    if mesh is None:
        return x
    x = _dt(x, mesh)
    return x.redistribute(mesh, _on_tp(mesh, tp, Shard(1) if shard
                                       else Replicate()))


class ScatterOp:
    """Split activations along the sequence over tp."""

    @staticmethod
    def apply(x):
        return _seq(x, shard=True)


class GatherOp:
    """Gather sequence-sharded activations whole."""

    @staticmethod
    def apply(x):
        return _seq(x, shard=False)


class AllGatherOp(GatherOp):
    """GatherOp (an all-gather over tp)."""


class ReduceScatterOp:
    """Sum partial activations and split them along the sequence."""

    @staticmethod
    def apply(x):
        return _seq(x, shard=True)


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True
    return parameter


def register_sequence_parallel_allreduce_hooks(
        model, fuse_sequence_parallel_allreduce=False):
    return model


class ColumnSequenceParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, name=None):
        super().__init__()
        self.gather_output = gather_output
        self.mesh, self._tp = _mp_info()
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = (self.create_parameter(
            [out_features], default_initializer=I.Constant(0.0),
            is_bias=True) if has_bias else None)
        _place(self, "weight", self.mesh, self._tp, Shard(1))
        _place(self, "bias", self.mesh, self._tp, Shard(0))

    def forward(self, x):
        if self.mesh is None:
            return F.linear(x, self.weight, self.bias)
        out = GatherOp.apply(x) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output:
            out = out.redistribute(self.mesh,
                                   (Replicate(),) * self.mesh.ndim)
        return out


class RowSequenceParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, name=None):
        super().__init__()
        self.mesh, self._tp = _mp_info()
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = (self.create_parameter(
            [out_features], default_initializer=I.Constant(0.0),
            is_bias=True) if has_bias else None)
        _place(self, "weight", self.mesh, self._tp, Shard(0))
        _place(self, "bias", self.mesh, self._tp, Replicate())

    def forward(self, x):
        if self.mesh is None:
            return F.linear(x, self.weight, self.bias)
        x = _dt(x, self.mesh)
        x = x.redistribute(self.mesh, _on_tp(self.mesh, self._tp,
                                             Shard(x.ndim - 1)))
        # the partial sums reduce-scattered to sequence shards
        out = ReduceScatterOp.apply(x @ self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out
