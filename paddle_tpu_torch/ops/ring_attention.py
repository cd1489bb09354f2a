"""Ring attention — port of ``paddle_tpu/ops/ring_attention.py``: causal
attention over a sequence sharded on the ``sep`` mesh dim, with K/V
rotating around the ring (``ppermute``) and each stripe pair's partial
attention merged through its logsumexp.

Two layouts, as in the JAX package:
  - ``contiguous``: rank r holds global chunk r; causally it computes r+1
    blocks, so the last rank sets the pace.
  - ``zigzag`` (default, causal only): the sequence is cut into 2n
    stripes and rank r holds stripes (r, 2n-1-r), so every rank computes
    2n+1 stripe pairs (``_zigzag_pair_counts``). The contract is JAX's:
    the sequence is sharded contiguously going in and coming out; the
    permutation to zigzag and back is an explicit exchange between the
    ranks of the dim (one ``all_gather_into_tensor`` each way and a
    slice, never DTensor's ``redistribute``), whose gradient is the
    inverse permutation.

Each stripe pair runs :func:`ops.flash_attention_with_lse` (K1 with lse
forward; K2 in GLSE mode, with the merge's lse cotangent, then K3
backward); on CPU tensors the same op runs its plain version. The merge
is fp32 (``torch.logaddexp``), lse in JAX's ``[b, s, h]`` layout.

Departures from the JAX bodies: each rank knows its coordinate on the
host, so JAX's ``lax.cond`` (zigzag :176, contiguous :220) is a host
branch that computes only the block it needs (the ``jnp.where`` selects of
:179-183 fall away, the per-step work stays balanced), and the last
rotation after the ring's final step, whose result JAX drops, is not made.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ..distributed.communication.functional import (MeshAxis, anchor,
                                                    mesh_axis, ppermute)
from .flash_attention import flash_attention_with_lse

NEG_INF = -1e30


def _block_attn_lse(q, k, v, causal: bool, scale: float, dtype):
    """q [b, sq, h, d], k/v [b, sk, hkv, d] -> (out fp32 [b, sq, h, d],
    lse fp32 [b, sq, h]) (:44): the flash op with lse on q, k, v cast to
    ``dtype`` (the inputs' own dtype), GQA in the kernel."""
    out, lse = flash_attention_with_lse(q.to(dtype), k.to(dtype),
                                        v.to(dtype), causal, scale)
    return out.float(), lse.transpose(1, 2)


def _merge(acc, lse, out_j, lse_j):
    """Merge two normalised partial attentions by their logsumexps (:83)."""
    new = torch.logaddexp(lse, lse_j)
    w1 = torch.exp(lse - new)[..., None]
    w2 = torch.exp(lse_j - new)[..., None]
    return acc * w1 + out_j * w2, new


# ---------------------------------------------------------------------------
# zigzag layout helpers (copies of the JAX package's pure functions)
# ---------------------------------------------------------------------------

def zigzag_perm(s_global: int, n: int) -> np.ndarray:
    """Index array P with x_zigzag = x[:, P]: rank r's contiguous shard
    holds global stripes (r, 2n-1-r)."""
    c = s_global // (2 * n)
    order = []
    for r in range(n):
        order += [r, 2 * n - 1 - r]
    return np.concatenate([np.arange(ch * c, (ch + 1) * c) for ch in order])


def zigzag_inverse(s_global: int, n: int) -> np.ndarray:
    perm = zigzag_perm(s_global, n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(s_global)
    return inv


def _zigzag_pair_counts(n: int):
    """Per-rank stripe-pair compute counts (must be all equal).

    Rank r at ring step j (kv from rank s=(r-j)%n) computes:
      qA(r)      vs kA(s):      iff r >= s
      qB(2n-1-r) vs kA(s):      always
      qB(2n-1-r) vs kB(2n-1-s): iff s >= r
    """
    counts = []
    for r in range(n):
        c = 0
        for j in range(n):
            s = (r - j) % n
            c += (r >= s) + 1 + (s >= r)
        counts.append(c)
    return counts


def _stripes(layout: str, n: int):
    """The global stripes each rank holds, in order, two a rank."""
    if layout == "zigzag":
        return [(r, 2 * n - 1 - r) for r in range(n)]
    return [(2 * r, 2 * r + 1) for r in range(n)]


def _restripe(x, axis: MeshAxis, src: str, dst: str):
    """This rank's local [b, 2c, ...] tensor laid out by ``dst`` from the
    ranks' tensors laid out by ``src`` (no autograd): the ranks' tensors
    gathered along a new leading dim, then the two stripes picked."""
    n = axis.size
    c = x.shape[1] // 2
    whole = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    dist.all_gather_into_tensor(whole.view(-1, *x.shape[1:]),
                                x.contiguous(), group=axis.group)
    where = {g: (r, h) for r, pair in enumerate(_stripes(src, n))
             for h, g in enumerate(pair)}
    parts = []
    for g in _stripes(dst, n)[axis.index]:
        r, h = where[g]
        parts.append(whole[r, :, h * c:(h + 1) * c])
    return torch.cat(parts, dim=1)


class _Restripe(torch.autograd.Function):
    """:func:`_restripe`; its gradient is the inverse permutation."""

    @staticmethod
    def forward(ctx, x, axis, src, dst):
        ctx.axis, ctx.src, ctx.dst = axis, src, dst
        return _restripe(x, axis, src, dst)

    @staticmethod
    def backward(ctx, g):
        return _restripe(g, ctx.axis, ctx.dst, ctx.src), None, None, None


# ---------------------------------------------------------------------------
# ring bodies (on this rank's local tensors)
# ---------------------------------------------------------------------------

def _ring_body_zigzag(q, k, v, axis: MeshAxis, scale: float, dtype):
    """Causal ring over zigzag shards (:134): local seq = [stripe A; stripe
    B], A = global stripe r, B = global stripe 2n-1-r; 2n+1 stripe pairs
    on every rank. q, k, v are fp32 here (see :func:`_ring_local`)."""
    r, n = axis.index, axis.size
    b, sl, h, d = q.shape
    c = sl // 2
    perm = [(i, (i + 1) % n) for i in range(n)]

    qA, qB = q[:, :c], q[:, c:]
    accA = q.new_zeros((b, c, h, d), dtype=torch.float32)
    lseA = q.new_full((b, c, h), NEG_INF, dtype=torch.float32)
    accB = torch.zeros_like(accA)
    lseB = torch.full_like(lseA, NEG_INF)

    def pair(qs, ks, vs, causal):
        return _block_attn_lse(qs, ks, vs, causal, scale, dtype)

    kc, vc = k, v
    for j in range(n):
        s = (r - j) % n
        kA, kB = kc[:, :c], kc[:, c:]
        vA, vB = vc[:, :c], vc[:, c:]

        # qB vs kA: stripe 2n-1-r is always in kA's causal future — full
        accB, lseB = _merge(accB, lseB, *pair(qB, kA, vA, False))
        if j == 0:
            # own K/V: both diagonals are triangular
            accA, lseA = _merge(accA, lseA, *pair(qA, kA, vA, True))
            accB, lseB = _merge(accB, lseB, *pair(qB, kB, vB, True))
        elif r > s:
            # exactly one of (qA vs kA | qB vs kB) is visible, and fully
            accA, lseA = _merge(accA, lseA, *pair(qA, kA, vA, False))
        else:
            accB, lseB = _merge(accB, lseB, *pair(qB, kB, vB, False))
        if j + 1 < n:
            kc = ppermute(kc, axis, perm)
            vc = ppermute(vc, axis, perm)
    return torch.cat([accA, accB], dim=1).to(dtype)


def _ring_body_contiguous(q, k, v, axis: MeshAxis, causal: bool,
                          scale: float, dtype):
    """Plain ring (:192): rank r holds global chunk r; causally the blocks
    from later ranks are skipped. q, k, v are fp32 here."""
    r, n = axis.index, axis.size
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc, lse = _block_attn_lse(q, k, v, causal, scale, dtype)
    kc, vc = k, v
    for j in range(1, n):
        kc = ppermute(kc, axis, perm)
        vc = ppermute(vc, axis, perm)
        if not causal or (r - j) % n <= r:
            acc, lse = _merge(acc, lse, *_block_attn_lse(q, kc, vc, False,
                                                         scale, dtype))
    # the last rotation's K/V, unused where that block is causally skipped
    return anchor(acc, kc, vc).to(dtype)


def _ring_local(q, k, v, axis: MeshAxis, causal: bool, scale: float,
                zigzag: bool):
    """The ring on this rank's shards. The bodies hold q, k, v (and so the
    rotating K/V) in fp32 and cast each stripe to the inputs' dtype for
    its kernel: each gradient then sums its stripe pairs' and ring steps'
    parts in fp32 and is rounded to the inputs' dtype once, as a single
    flash backward rounds it (bf16 sums of the parts would round at every
    step; the rotations carry twice the bytes)."""
    dtype = q.dtype
    if zigzag:
        q, k, v = (_Restripe.apply(t, axis, "contiguous", "zigzag")
                   for t in (q, k, v))
        out = _ring_body_zigzag(q.float(), k.float(), v.float(), axis,
                                scale, dtype)
        return _Restripe.apply(out, axis, "zigzag", "contiguous")
    return _ring_body_contiguous(q.float(), k.float(), v.float(), axis,
                                 causal, scale, dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "sep",
                   causal: bool = True, scale: Optional[float] = None,
                   layout: str = "zigzag"):
    """q [b, s, h, d], k/v [b, s, hkv, d] with the sequence sharded
    contiguously over ``axis_name`` of ``mesh`` (:231); batch may be
    sharded over dp/fsdp and heads over tp, and the ring then runs per
    head shard. DTensors run under ``local_map`` with their placements
    (the output takes q's); plain tensors are this rank's local shards.

    ``layout='zigzag'`` (causal only) balances causal work by permuting
    the sequence into 2n stripes before the ring and back after; it falls
    back to ``contiguous`` when the call is not causal or ``s`` does not
    divide into 2n stripes, as in JAX (:249-250)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    axis = mesh_axis(axis_name, mesh)
    n = axis.size
    s_global = q.shape[1] if isinstance(q, DTensor) else q.shape[1] * n
    zigzag = (layout == "zigzag" and causal and n > 1
              and s_global % (2 * n) == 0)

    def body(a, b, c):
        return _ring_local(a, b, c, axis, causal, float(scale), zigzag)

    if not isinstance(q, DTensor):
        return body(q, k, v)
    qp, kp = tuple(q.placements), tuple(k.placements)
    return local_map(body, out_placements=list(qp),
                     in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kp, kp),
                     device_mesh=q.device_mesh)(q, k, v)
