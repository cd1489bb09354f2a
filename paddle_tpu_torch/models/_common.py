"""Helpers the model families share: weight init, the JAX package's
LayerNorm rounding, causal attention routing and the generator replay
that remat needs. One definition each, so Llama, GPT and BERT agree."""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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
    placements again. A sequence sharded over a ``sep`` dim of more than
    one rank goes to ring attention (JAX :342-346) when ``fn`` is the
    flash route."""
    mesh = q.device_mesh
    pl = tuple(q.placements)
    if fn is _flash_causal and _sep_sharded(q):
        return _ring_route(q, k, v)
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


def _sep_sharded(q):
    """Is q's sequence (dim 1) sharded over a ``sep`` dim of size > 1?"""
    names = tuple(q.device_mesh.mesh_dim_names or ())
    return any(n == "sep" and q.device_mesh.size(i) > 1 and p.is_shard(1)
               for i, (n, p) in enumerate(zip(names, q.placements)))


def _ring_route(q, k, v):
    """Ring attention over "sep" on each rank's shards, heads sharded over
    tp as they are (JAX's ``qspec``/``kspec`` :244-245). Heads that tp does
    not divide, and any other sharded dim, are made whole first (the ring
    needs the sequence sharded over "sep" alone); the output takes q's
    placements."""
    from ..ops.ring_attention import ring_attention

    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names or ())

    def keep(t):
        return tuple(
            p if (n == "sep" and p.is_shard(1)) or (
                p.is_shard() and p.dim in (0, 2) and n != "sep"
                and all(x.shape[p.dim] % mesh.size(i) == 0
                        for x in (q, k, v))) else Replicate()
            for i, (n, p) in enumerate(zip(names, t.placements)))

    want = keep(q)
    if keep(k) != want:
        want = tuple(a if a == b else Replicate()
                     for a, b in zip(want, keep(k)))
    q2, k2, v2 = (t if tuple(t.placements) == want
                  else t.redistribute(mesh, want) for t in (q, k, v))
    out = ring_attention(q2, k2, v2, mesh, axis_name="sep", causal=True)
    return out if want == tuple(q.placements) else out.redistribute(
        mesh, q.placements)


def mesh_matmul(x, w):
    """``x @ w`` for a projection ([b, s, k] @ [k, n]). A DTensor ``x``
    whose sequence (dim 1) is sharded runs the product on each rank's
    shards under ``local_map``: DTensor's ``matmul`` flattens x's leading
    dims first, which torch 2.11 refuses for a sharded dim 1. Each mesh dim
    places the product as DTensor's rules would: a sharded batch or
    sequence stays sharded (w's gradient partial over it), a column-
    sharded w shards the output's last dim (x's gradient partial), a
    sharded contraction (x's last dim, w's rows) makes the output partial.
    Anything else is DTensor's own product."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor) and x.ndim == 3
            and any(p.is_shard(1) for p in x.placements)):
        return x @ w
    out, gx, gw = [], [], []
    for a, b in zip(x.placements, w.placements):
        if a.is_shard() and a.dim in (0, 1) and b.is_replicate():
            out.append(a), gx.append(a), gw.append(Partial())
        elif a.is_shard(2) and b.is_shard(0):
            out.append(Partial()), gx.append(a), gw.append(b)
        elif a.is_replicate() and b.is_shard(1):
            out.append(Shard(2)), gx.append(Partial()), gw.append(b)
        elif a.is_replicate() and b.is_replicate():
            out.append(a), gx.append(a), gw.append(b)
        else:
            return x @ w
    return local_map(torch.matmul, out_placements=out,
                     in_placements=(tuple(x.placements), tuple(w.placements)),
                     in_grad_placements=(tuple(gx), tuple(gw)),
                     device_mesh=x.device_mesh)(x, w)


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
