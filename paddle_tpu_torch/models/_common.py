"""Helpers the model families share: weight init, the JAX package's
LayerNorm rounding, causal attention routing and the generator replay
that remat needs. One definition each, so Llama, GPT and BERT agree."""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from ..device import resolve_dtype
from ..nn.functional.flash_attention import _xla_attention
from ..ops.flash_attention import flash_attention


def _normal(shape, config, device, gen):
    t = torch.empty(shape, dtype=resolve_dtype(config.dtype), device=device)
    t.normal_(0.0, config.initializer_range, generator=gen)
    return nn.Parameter(t)


def _layer_norm(x, w, b, eps):
    """LayerNorm in the JAX package's rounding (bert :104-108, gpt
    :64-70): fp32 statistics (population variance), the normalised value
    cast to x's dtype, then ``* w + b`` in that dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _attention(q, k, v, config):
    """Causal attention on [b, s, h, d] tensors: the JAX package's
    ``_attention`` (llama :320-365), the flash kernels, or with
    ``config.use_flash_attention`` False the dense ``_xla_attention``
    (plain tensor ops on either device, as in the JAX package). DTensors
    (a mesh) go through :func:`_mesh_attention`."""
    fn = _flash_causal if config.use_flash_attention else _xla_causal
    if isinstance(q, DTensor):
        return _mesh_attention(q, k, v, fn)
    return fn(q, k, v)


def _flash_causal(q, k, v):
    return flash_attention(q, k, v, causal=True)


def _xla_causal(q, k, v):
    return _xla_attention(q, k, v, causal=True)


def _mesh_attention(q, k, v, fn):
    """``fn`` on each rank's shard, the port of the mesh branches of JAX's
    ``_attention`` (:346-360): DTensor has no sharding rule for the flash
    ops, so they run under ``local_map`` on the local tensors, as JAX runs
    them under ``shard_map`` over (batch, heads). On a one-rank mesh the
    local tensors are the whole ones, so this is the plain call (JAX
    :339-340). Where batch or heads do not divide the mesh, or a tensor is
    sharded on another dim, q/k/v are gathered whole and every rank runs
    the same kernels on them (JAX drops to ``_xla_attention`` there; on
    the card the port keeps the kernel), then the output takes q's
    placements again."""
    mesh = q.device_mesh
    pl = tuple(q.placements)
    even = all(t.shape[d] % mesh.size(i) == 0
               for t in (q, k, v) for i, p in enumerate(t.placements)
               if p.is_shard() for d in (p.dim,))
    local_ok = (even and tuple(k.placements) == pl
                and tuple(v.placements) == pl
                and all(p.is_replicate() or (p.is_shard() and p.dim in (0, 2))
                        for p in pl))
    if local_ok:
        return local_map(fn, out_placements=list(pl), in_placements=(pl, pl, pl),
                         in_grad_placements=(pl, pl, pl),
                         device_mesh=mesh)(q, k, v)
    rep = (Replicate(),) * mesh.ndim
    whole = [t.redistribute(mesh, rep) for t in (q, k, v)]
    out = local_map(fn, out_placements=list(rep), in_placements=(rep, rep, rep),
                    in_grad_placements=(rep, rep, rep),
                    device_mesh=mesh)(*whole)
    return out.redistribute(mesh, pl)


def _replaying(fn, generators):
    """``fn``, whose later calls (a checkpoint's recompute) draw the same
    numbers from ``generators`` as its first call did: each recompute
    starts from the generators' states before the first call and puts back
    the states it found. ``torch.utils.checkpoint`` restores only the
    default generators, not explicit ones."""
    if not generators:
        return fn
    before = [g.get_state() for g in generators]
    first = [True]

    def run(*args):
        if first[0]:
            first[0] = False
            return fn(*args)
        now = [g.get_state() for g in generators]
        for g, st in zip(generators, before):
            g.set_state(st)
        try:
            return fn(*args)
        finally:
            for g, st in zip(generators, now):
                g.set_state(st)
    return run
