"""Tensor-parallel layers — port of ``paddle_tpu/distributed/fleet/
meta_parallel/parallel_layers/mp_layers.py`` on DTensor.

The JAX layers place their weights over the hybrid topology's "mp" axis
and let GSPMD insert the collectives. The port places them over the
active mesh's "tp" axis (``axis_rules`` or ``set_mesh``; "mp" is taken
too) as DTensors, and the collectives are the redistributes written out:
a column-parallel output all-gathered when ``gather_output``, a
row-parallel product's partial sums all-reduced, the vocab-parallel
embedding's masked lookups summed. ``ParallelCrossEntropy`` is Megatron's
vocab-parallel form: the max, the sum of exponentials and the target
logit reduced over tp, so the whole logits never meet on one rank. With
no mesh (or no tp axis) they are the dense layers. Parameters carry the
JAX names (``weight``, ``bias``) and ``[in, out]`` layouts, so
``load_jax_state`` carries them across; load the whole weights before
placing them, or build the layer under the mesh from the same seed on
every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .....nn import functional as F
from .....nn import initializer as I
from .....nn.layer.layers import Layer
from ....auto_parallel.logical_sharding import (_broadcast_whole,
                                                current_mesh, distribute)


def _mp_info():
    """(the mesh, the index of its tp axis) or (None, None)."""
    mesh = current_mesh()
    if mesh is None:
        from ....auto_parallel.process_mesh import get_current_mesh

        pm = get_current_mesh()
        mesh = pm.to_torch() if pm is not None else None
    if mesh is None:
        return None, None
    names = tuple(mesh.mesh_dim_names or ())
    for axis in ("tp", "mp"):
        if axis in names:
            return mesh, names.index(axis)
    return None, None


def _on_tp(mesh, tp, placement):
    return tuple(placement if i == tp else Replicate()
                 for i in range(mesh.ndim))


def _place(layer, name, mesh, tp, placement):
    """Make ``layer.<name>`` a DTensor parameter, ``placement`` on tp."""
    p = getattr(layer, name)
    if mesh is None or p is None:
        return
    with torch.no_grad():
        whole = p.detach().clone()
        _broadcast_whole(whole, mesh)
        new = nn.Parameter(distribute(whole, mesh, _on_tp(mesh, tp,
                                                          placement)),
                           requires_grad=p.requires_grad)
    new.__dict__.update(p.__dict__)
    layer._parameters[name] = new


def _dt(x, mesh):
    """``x`` as a DTensor on ``mesh`` (a plain tensor: replicated)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.mesh, self._tp = _mp_info()
        self.world_size = self.mesh.size(self._tp) if self.mesh else 1
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _place(self, "weight", self.mesh, self._tp, Shard(0))

    def forward(self, x):
        if self.mesh is None:
            return F.embedding(x, self.weight)
        out = torch.nn.functional.embedding(_dt(x, self.mesh), self.weight)
        # each rank's rows of the table looked up; the partial sums reduced
        return out.redistribute(self.mesh, (Replicate(),) * self.mesh.ndim)


class ColumnParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.mesh, self._tp = _mp_info()
        self.world_size = self.mesh.size(self._tp) if self.mesh else 1
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        self.bias = (self.create_parameter([out_features], is_bias=True)
                     if has_bias else None)
        _place(self, "weight", self.mesh, self._tp, Shard(1))
        _place(self, "bias", self.mesh, self._tp, Shard(0))

    def forward(self, x):
        if self.mesh is None:
            return F.linear(x, self.weight, self.bias)
        out = _dt(x, self.mesh) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output:
            out = out.redistribute(self.mesh,
                                   (Replicate(),) * self.mesh.ndim)
        return out


class RowParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.mesh, self._tp = _mp_info()
        self.world_size = self.mesh.size(self._tp) if self.mesh else 1
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr)
        self.bias = (self.create_parameter([out_features], is_bias=True)
                     if has_bias else None)
        _place(self, "weight", self.mesh, self._tp, Shard(0))
        _place(self, "bias", self.mesh, self._tp, Replicate())

    def forward(self, x):
        if self.mesh is None:
            return F.linear(x, self.weight, self.bias)
        x = _dt(x, self.mesh)
        x = x.redistribute(self.mesh, _on_tp(self.mesh, self._tp,
                                             Shard(x.ndim - 1)))
        # contracting over the split dim: partial sums, all-reduced
        out = (x @ self.weight).redistribute(
            self.mesh, (Replicate(),) * self.mesh.ndim)
        if self.bias is not None:
            out = out + self.bias
        return out


class _VocabParallelNLL(torch.autograd.Function):
    """Per-row NLL of vocab-sharded logits (Megatron's vocab-parallel CE):
    each rank holds columns [start, start + V/tp) and the tp group reduces
    the row max, the sum of exponentials and the target logit. The
    backward is local: softmax minus the one-hot of the rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, start, group, ignore_index):
        lf = logits.float()
        m = lf.max(-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(lf - m[..., None])
        s = e.sum(-1)
        dist.all_reduce(s, group=group)
        local = labels.long() - start
        inside = (local >= 0) & (local < lf.shape[-1])
        safe = torch.where(inside, local, 0)
        picked = torch.where(inside, lf.gather(-1, safe[..., None])[..., 0],
                             0.0)
        dist.all_reduce(picked, group=group)
        valid = labels.long() != ignore_index
        loss = torch.where(valid, torch.log(s) + m - picked, 0.0)
        ctx.save_for_backward(e, s, safe, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, safe, inside, valid = ctx.saved_tensors
        grad = e / s[..., None]
        grad.scatter_add_(-1, safe[..., None],
                          -inside.to(grad.dtype)[..., None])
        grad = grad * (g * valid)[..., None]
        return grad.to(ctx.dtype), None, None, None, None


class ParallelCrossEntropy(Layer):
    """Unreduced cross entropy of vocab-sharded logits (hard labels): one
    loss per label, 0 where the label is ``ignore_index``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label, soft_label=False):
        mesh, tp = _mp_info()
        if mesh is None or soft_label or not isinstance(input, DTensor):
            return F.cross_entropy(input, label, soft_label=soft_label,
                                   ignore_index=self.ignore_index,
                                   reduction="none")
        if label.ndim == input.ndim:
            label = label.squeeze(-1)
        logits = input.redistribute(mesh, _on_tp(mesh, tp,
                                                 Shard(input.ndim - 1)))
        label = _dt(label, mesh).redistribute(mesh,
                                              (Replicate(),) * mesh.ndim)
        group = mesh.get_group(tp)
        v_local = -(-input.shape[-1] // mesh.size(tp))
        start = mesh.get_coordinate()[tp] * v_local
        rep = (Replicate(),) * mesh.ndim
        ignore = self.ignore_index
        return local_map(
            lambda lg, lb: _VocabParallelNLL.apply(lg, lb, start, group,
                                                   ignore),
            out_placements=list(rep),
            in_placements=(tuple(logits.placements), rep),
            in_grad_placements=(tuple(logits.placements), rep),
            device_mesh=mesh)(logits, label)
