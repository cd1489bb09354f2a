"""Pipeline parallelism over a ``pp`` mesh dim — port of ``paddle_tpu/
distributed/auto_parallel/pipeline.py``.

The JAX package runs the whole pipeline as one SPMD program: layer weights
stacked along a leading dim sharded over ``pp``, a ``lax.scan`` over
``v * n_micro + p - 1`` ticks inside ``shard_map``, activations moved by
``lax.ppermute``, the backward from ``jax.grad`` through the scan. The port
is SPMD too, one process a rank: each rank runs only its stage's layers
(under VPP its ``v`` chunks) tick by tick, moves activations with the
differentiable ``communication.functional.ppermute``, and its backward is
autograd through the tick loop, ``ppermute``'s backward being the reverse
exchange, which is the reverse schedule JAX gets from the transpose.

The schedule is JAX's, tick for tick (``_Schedule`` is ``zb_schedule``'s
``_meta`` :289-300 evaluated on the host). Departures:
  - every rank knows its bubble ticks on the host and skips them, where
    JAX computes them on garbage and discards the result; a tick's
    exchange carries only the pairs whose receiver uses the value at the
    next tick (JAX's permute is the whole ring every tick);
  - the collected output is broadcast from the last stage (JAX: masked and
    ``psum``-ed), and every rank computes what follows it (the final norm,
    the head, the loss), as JAX's replicated compute over ``pp`` does. Its
    gradient enters the pipeline at the last stage only, from that rank's
    own copy of the loss;
  - in SPMD autograd a rank's backward reaches only the exchanges its own
    loss depends on: the exchanges whose result a rank does not use (a
    stage's sends whose tick receives nothing) are handed to the
    collecting op as inputs that get zero gradients, and each exchange
    carries the stage's weights as ``links`` (so ``torch.autograd.grad``
    over the weights does not prune a receive-only exchange, whose
    backward sends the cotangent): every rank runs every exchange's
    backward, in reverse tick order, as its peers do.

``zb_schedule`` (JAX :197) is a ``torch.autograd.Function``: its forward
walks the same ticks (``_walk_ticks``) keeping each layer's graph (or,
with ``remat``, only each layer's input), its backward runs B, the
activation cotangents, on the critical path in reverse tick order,
exchanging them with explicit point-to-point calls, and then drains W,
each layer's weight gradients from the saved graph and its saved output
cotangent (``torch.autograd.grad`` with ``inputs=`` the activation, then
the weights). Its losses and gradients are those of GPipe; W runs each
layer's backward a second time (the flash backward included), so on one
card it costs more than GPipe. JAX's selective
remat regime for it (a policy's tensors kept in each pullback, which B and
W both apply) is refused: torch runs one backward through a selective-
checkpoint region.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..communication.functional import (MeshAxis, _PPermute, exchange,
                                        mesh_axis)

_state = threading.local()


def in_manual_pipeline() -> bool:
    """True while a stage's layers run inside a pipeline tick (JAX: inside
    the ``shard_map(pp)`` body)."""
    return getattr(_state, "manual", False)


class _ManualCtx:
    def __enter__(self):
        self._prev = in_manual_pipeline()
        _state.manual = True

    def __exit__(self, *exc):
        _state.manual = self._prev
        return False


class _Schedule:
    """The tick schedule of ``p`` stages, ``v`` chunks a stage and ``M``
    microbatches (GPipe: v = 1), on the host (JAX :289-300)."""

    def __init__(self, p: int, v: int, M: int):
        self.p, self.v, self.M = p, v, M
        self.vp = v * p
        self.T = v * M + p - 1

    def meta(self, t: int, d: int):
        """(chunk, microbatch, active, injects, is_out) of stage ``d`` at
        tick ``t``."""
        p, v, vp, M = self.p, self.v, self.vp, self.M
        cyc = (t - d) % vp
        c = min(cyc // p, v - 1)
        e = t - (c * p + d)
        er = e % vp
        mb = (e // vp) * p + er
        active = e >= 0 and er < p and mb < M
        inject = active and d == 0 and cyc < p
        is_out = active and d == p - 1 and c == v - 1
        return c, mb, active, inject, is_out

    def uses_buf(self, t: int, d: int) -> bool:
        if t >= self.T:
            return False
        _, _, active, inject, _ = self.meta(t, d)
        return active and not inject

    def perm(self, t: int):
        """The (src, dst) pairs of the exchange after tick ``t``: each
        stage whose successor uses the value at tick t + 1."""
        pairs = []
        for d in range(self.p):
            nxt = (d + 1) % self.p
            if self.uses_buf(t + 1, nxt):
                if not self.meta(t, d)[2]:
                    raise AssertionError(f"stage {nxt} reads at tick "
                                         f"{t + 1} what stage {d} did not "
                                         f"compute")
                pairs.append((d, nxt))
        return pairs

    def active_ticks(self, d: int):
        return [t for t in range(self.T) if self.meta(t, d)[2]]


class _FromLast(torch.autograd.Function):
    """The pipeline's outputs on every rank: broadcast from the last stage
    (JAX: the masked ``psum`` :104-106). Its gradient goes to the last
    stage's outputs only; the other inputs (the exchanges whose result
    this rank does not use) take zeros, which puts their backward on this
    rank's path."""

    @staticmethod
    def forward(ctx, axis, like, outs, *dangling):
        last = axis.size - 1
        ctx.is_last = axis.index == last
        ctx.n = len(dangling)
        buf = outs.detach().contiguous() if ctx.is_last else torch.empty_like(
            like)
        dist.broadcast(buf, src=axis.ranks[last], group=axis.group)
        return buf

    @staticmethod
    def backward(ctx, g):
        return (None, None, g if ctx.is_last else None) + (None,) * ctx.n


def _split_micro(x, n_micro):
    """The rank's rows of ``x`` as ``n_micro`` microbatches (views)."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro "
                         f"{n_micro}")
    return list(torch.chunk(x, n_micro, dim=0))


def _walk_ticks(sched: _Schedule, d: int, micro: List[torch.Tensor],
                apply_chunk: Callable, exchange_fn: Callable):
    """The forward tick loop of stage ``d`` (JAX's scan, on the host), which
    GPipe / VPP and zero-bubble share: an active tick applies its chunk,
    ``apply_chunk(t, c, h) -> y``, to its injected microbatch or to the
    value received after the tick before, and the exchange after tick
    ``t``, ``exchange_fn(x, perm) -> received``, carries ``sched.perm(t)``'s
    pairs. Returns (the last stage's outputs by microbatch, the results of
    the exchanges this rank only sent on)."""
    outs = [None] * sched.M
    unused = []
    buf = None
    for t in range(sched.T):
        c, mb, active, inject, is_out = sched.meta(t, d)
        y = None
        if active:
            with _ManualCtx():
                y = apply_chunk(t, c, micro[mb] if inject else buf)
            if is_out:
                outs[mb] = y
        perm = sched.perm(t)
        sends = any(s == d for s, _ in perm)
        recvs = any(r == d for _, r in perm)
        if not (sends or recvs):
            continue
        # a receive-only rank passes a microbatch for its shape; it sends
        # nothing
        got = exchange_fn(y if sends else micro[0], perm)
        if recvs:
            buf = got
        else:
            unused.append(got)
    return outs, unused


def _run_ticks(apply_chunk, micro: List[torch.Tensor], axis: MeshAxis,
               sched: _Schedule, links=()):
    """The GPipe / VPP tick loop on this rank (autograd through it): the
    microbatches' outputs, concatenated, on every rank. ``links``: this
    stage's weights, on whose path every exchange is put (a receive-only
    exchange's backward must run under ``torch.autograd.grad`` too)."""
    d = axis.index
    links = [w for w in links if w.requires_grad][:1]
    outs, unused = _walk_ticks(
        sched, d, micro, lambda t, c, h: apply_chunk(c, h),
        lambda x, perm: _PPermute.apply(x, axis, perm, *links))
    # the exchanges only sent on get zero gradients (their backward sends)
    dangling = [got for got in unused if got.requires_grad]
    like = micro[0].new_empty((sum(m.shape[0] for m in micro),)
                              + tuple(micro[0].shape[1:]))
    local = torch.cat(outs) if d == axis.size - 1 else like
    return _FromLast.apply(axis, like, local, *dangling)


# ---------------------------------------------------------------------------
# the schedules (JAX's builders, on this rank)
# ---------------------------------------------------------------------------

def gpipe_schedule(stage_fn: Callable, n_stages: int, axis_name: str = "pp",
                   with_aux: bool = False, mesh=None):
    """The GPipe tick schedule (:61). ``stage_fn(stage_params, h, *bargs)
    -> y`` computes this rank's stage. Returns ``pipeline(params,
    micro_in, *bargs)`` where ``micro_in`` is ``[n_micro, ...]`` (the same
    on every stage) and the result is every microbatch's output on every
    stage."""
    return interleaved_schedule(
        lambda params, c, h, *bargs: stage_fn(params, h, *bargs),
        n_stages, 1, axis_name, with_aux, mesh)


def interleaved_schedule(stage_fn: Callable, n_stages: int, interleave: int,
                         axis_name: str = "pp", with_aux: bool = False,
                         mesh=None):
    """The interleaved (VPP) schedule (:114): this rank holds ``v =
    interleave`` non-adjacent chunks and every microbatch circulates the
    ring v times. ``stage_fn(local_params, chunk_idx, h, *bargs)`` applies
    chunk ``chunk_idx`` of this rank's layers."""
    if with_aux:
        from .._refuse import EP, refuse
        raise refuse("pipeline with_aux (MoE gate losses over pp)", EP)

    def pipeline(params, micro_in, *bargs):
        axis = mesh_axis(axis_name, mesh)
        if axis.size != n_stages:
            raise ValueError(f"{axis_name} has {axis.size} ranks, the "
                             f"schedule {n_stages} stages")
        micro = list(micro_in.unbind(0))
        sched = _Schedule(n_stages, interleave, len(micro))
        links = [w for w in (params if isinstance(params, (list, tuple))
                             else [params]) if isinstance(w, torch.Tensor)]
        out = _run_ticks(lambda c, h: stage_fn(params, c, h, *bargs), micro,
                         axis, sched, links)
        return out.reshape(micro_in.shape)

    return pipeline


class _ZBLayer:
    """One layer of a zero-bubble stage: ``fn(params, h) -> y`` and the
    tensors it differentiates (``params``)."""

    def __init__(self, fn, params):
        self.fn, self.params = fn, list(params)


class _ZeroBubble(torch.autograd.Function):
    """The zero-bubble schedule's forward and hand-built backward (JAX
    ``zb_schedule`` :197-500): inputs ``(run, micro_cat, *weights)``,
    ``run`` a :class:`_ZBRun`."""

    @staticmethod
    def forward(ctx, run, x, *weights):
        ctx.run = run
        return run.forward(x)

    @staticmethod
    def backward(ctx, g):
        dx, dws = ctx.run.backward(g)
        ctx.run = None
        return (None, dx) + tuple(dws)


def _refuse_selective_zb(remat, policy):
    """JAX's third zero-bubble regime (remat with a policy: each layer's
    pullback keeps the policy's tensors, and B and W both apply it) needs
    two backward passes through one selective-checkpoint region, which
    torch refuses."""
    if remat and policy is not None:
        from .._refuse import PP_ZB_SELECTIVE, refuse
        raise refuse("pipeline zero-bubble with a remat policy",
                     PP_ZB_SELECTIVE)


class _ZBRun:
    """The state of one zero-bubble call: the schedule, this rank's chunks
    of layers, and what the forward keeps for B and W.

    Memory regimes (JAX :232-250): ``remat=False`` keeps every layer's
    graph (ZB-inf); ``remat=True`` keeps only each layer's input,
    recomputes the layer for B w.r.t. the activation and once more for W
    w.r.t. the weights (the boundary regime). The selective regime (a
    policy) is refused (:func:`_refuse_selective_zb`)."""

    def __init__(self, chunks, axis, sched, weights, remat):
        self.chunks, self.axis, self.sched = chunks, axis, sched
        self.weights = weights           # the Function's weight inputs
        self.boundary = remat
        self.saved = {}                  # (t, l) -> (h_in, y or None)

    @staticmethod
    def _layer(layer, h):
        return layer.fn(layer.params, h)

    def _apply_chunk(self, t, c, h):
        """Chunk ``c``'s layers at tick ``t``, each keeping its graph (or,
        in the boundary regime, its input) for B and W."""
        for i, layer in enumerate(self.chunks[c]):
            h_in = h.detach().requires_grad_(True)
            if self.boundary:
                with torch.no_grad():
                    h = self._layer(layer, h_in)
                self.saved[(t, i)] = (h_in, None)
            else:
                with torch.enable_grad():
                    h = self._layer(layer, h_in)
                self.saved[(t, i)] = (h_in, h)
            h = h.detach()
        return h

    def forward(self, x):
        axis, d = self.axis, self.axis.index
        outs, _ = _walk_ticks(self.sched, d, _split_micro(x, self.sched.M),
                              self._apply_chunk,
                              lambda y, perm: exchange(y, axis, perm))
        last = axis.size - 1
        out = (torch.cat(outs) if d == last else torch.empty_like(x))
        dist.broadcast(out, src=axis.ranks[last], group=axis.group)
        return out

    def _graph(self, t, i, layer, weights_only=False):
        """(input, output) of layer ``i`` at tick ``t``: the saved graph, or
        (boundary regime) a recompute, w.r.t. the activation for B and the
        weights for W."""
        h_in, y = self.saved[(t, i)]
        if y is not None:
            return h_in, y
        h = h_in.detach() if weights_only else h_in
        with torch.enable_grad(), _ManualCtx():
            return h, self._layer(layer, h)

    def backward(self, g):
        axis, sched, d = self.axis, self.sched, self.axis.index
        gm = _split_micro(g, sched.M)
        dmicro = [torch.zeros_like(m) for m in gm]
        dys = {}
        gbuf = None
        # ---- B: activation cotangents, reverse tick order ----
        for t in reversed(range(sched.T)):
            c, mb, active, inject, is_out = sched.meta(t, d)
            dh = None
            if active:
                dh = gm[mb] if is_out else gbuf
                for i in reversed(range(len(self.chunks[c]))):
                    dys[(t, i)] = dh
                    h_in, y = self._graph(t, i, self.chunks[c][i])
                    (dh,) = torch.autograd.grad(y, h_in, dh,
                                                retain_graph=True)
                    if self.boundary:
                        self.saved[(t, i)] = (h_in.detach(), None)
                if inject:
                    dmicro[mb] = dh
            if t == 0:
                break
            perm = [(r, s) for s, r in sched.perm(t - 1)]
            if any(d in pair for pair in perm):
                send = dh if (dh is not None and not inject) else gm[0]
                got = exchange(send, axis, perm)
                if any(r == d for _, r in perm):
                    gbuf = got
        # ---- W: the weights' gradients, off the exchange chain ----
        grads = {id(w): torch.zeros_like(w) for w in self.weights}
        for t in sched.active_ticks(d):
            c = sched.meta(t, d)[0]
            for i, layer in enumerate(self.chunks[c]):
                _, y = self._graph(t, i, layer, weights_only=True)
                dws = torch.autograd.grad(y, layer.params, dys.pop((t, i)),
                                          allow_unused=True)
                self.saved.pop((t, i))
                for w, dw in zip(layer.params, dws):
                    if dw is not None:
                        grads[id(w)] = grads[id(w)] + dw
        return torch.cat(dmicro), [grads[id(w)] for w in self.weights]


def zb_schedule(layer_fn, n_stages: int, interleave: int, lc: int,
                axis_name: str = "pp", bargs=(), remat: bool = False,
                with_aux: bool = False, remat_policy=None, mesh=None):
    """The zero-bubble (ZBH1-class) W/B-split schedule (:197). ``layer_fn
    (per_layer_params, h, *bargs) -> y`` runs one block; returns
    ``pipeline(params, micro_in)`` where ``params`` are this rank's local
    ``[v * lc, ...]`` stacks."""
    if with_aux:
        from .._refuse import EP, refuse
        raise refuse("pipeline with_aux (MoE gate losses over pp)", EP)
    _refuse_selective_zb(remat, remat_policy)

    def pipeline(params, micro_in):
        axis = mesh_axis(axis_name, mesh)
        if axis.size != n_stages:
            raise ValueError(f"{axis_name} has {axis.size} ranks, the "
                             f"schedule {n_stages} stages")

        def fn(ps, h):
            return layer_fn(ps, h, *bargs)

        # each layer's rows of the stacks (views, whose gradients autograd
        # carries on to the stacks)
        layers = [[(fn, [w[c * lc + i] for w in params]) for i in range(lc)]
                  for c in range(interleave)]
        x = micro_in.reshape((-1,) + tuple(micro_in.shape[2:]))
        return run_pipeline(layers, x, n_micro=micro_in.shape[0],
                            axis_name=axis_name, interleave=interleave,
                            schedule="zb", remat=remat, mesh=mesh
                            ).reshape(micro_in.shape)

    return pipeline


def vpp_layer_order(n_layers: int, p: int, v: int):
    """Layer permutation so a contiguous [L/p] slice per device holds its v
    round-robin chunks: device d gets virtual stages {c*p + d}."""
    lc = n_layers // (v * p)
    order = []
    for d in range(p):
        for c in range(v):
            k = c * p + d
            order.extend(range(k * lc, (k + 1) * lc))
    return order


def _checked(n_layers, n_stages, n_micro, interleave, schedule):
    if schedule not in ("auto", "zb"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if n_layers % (interleave * n_stages) != 0:
        raise ValueError(f"n_layers {n_layers} not divisible by interleave*pp "
                         f"{interleave}*{n_stages}")
    if interleave > 1 and n_micro % n_stages != 0:
        raise ValueError(
            f"VPP requires n_micro % pp == 0, got {n_micro} % {n_stages} "
            f"(reference: accumulate_steps % pp_degree == 0)")
    return n_layers // (interleave * n_stages)


def _local_view(x):
    """(x's local tensor, a function wrapping a local microbatch back as a
    DTensor of x's placements, and unwrapping a DTensor result): the
    pipeline moves local tensors; the stage runs on DTensors."""
    if not isinstance(x, DTensor):
        return x, None
    mesh, pl = x.device_mesh, tuple(x.placements)
    local = x.to_local()
    ways = 1
    for i, p in enumerate(pl):
        if p.is_shard(0):
            ways *= mesh.size(i)

    def wrap(h):
        shape = (h.shape[0] * ways,) + tuple(x.shape[1:])
        return DTensor.from_local(h, mesh, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta")
                                  .stride())

    def unwrap(y):
        if tuple(y.placements) != pl:
            y = y.redistribute(mesh, pl)
        return y.to_local()

    return local, (wrap, unwrap)


def run_pipeline(layers, x, *, n_micro: int, axis_name: str = "pp",
                 interleave: int = 1, schedule: str = "auto",
                 remat: bool = False, remat_policy=None, mesh=None):
    """The pipeline over this rank's layers: ``layers[c]`` lists chunk
    ``c``'s ``(fn, params)`` pairs, ``fn(params, h) -> y`` one block. ``x``
    (a DTensor over the other mesh dims, or a plain tensor) holds this
    rank's rows of the whole batch, the same on every stage; the result is
    like it. ``remat`` wraps each block in ``torch.utils.checkpoint`` with
    ``remat_policy`` (a selective-checkpoint policy function, or None to
    save nothing) under GPipe / VPP, and selects zb's memory regime (a
    policy under zb is refused)."""
    axis = mesh_axis(axis_name, mesh)
    local, io = _local_view(x)
    sched = _Schedule(axis.size, interleave, n_micro)

    def call(fn, params, h):
        if io is None:
            return fn(params, h)
        wrap, unwrap = io
        return unwrap(fn(params, wrap(h)))

    if schedule == "zb":
        _refuse_selective_zb(remat, remat_policy)
        chunks = [[_ZBLayer(lambda ps, h, fn=fn: call(fn, ps, h), ps)
                   for fn, ps in chunk] for chunk in layers]
        weights = list({id(w): w for chunk in chunks for lay in chunk
                        for w in lay.params}.values())
        out = _ZeroBubble.apply(_ZBRun(chunks, axis, sched, weights, remat),
                                local, *weights)
    else:
        ctx_fn = noop_context_fn if remat_policy is None else (
            lambda: create_selective_checkpoint_contexts(remat_policy))

        def apply_chunk(c, h):
            for fn, ps in layers[c]:
                if remat and torch.is_grad_enabled():
                    h = checkpoint(call, fn, ps, h, use_reentrant=False,
                                   context_fn=ctx_fn)
                else:
                    h = call(fn, ps, h)
            return h

        out = _run_ticks(apply_chunk, _split_micro(local, n_micro), axis,
                         sched, [w for chunk in layers for _, ps in chunk
                                 for w in ps])
    if io is None:
        return out
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def pipeline_call(
    block_fn: Callable,
    stacked_params: Sequence[torch.Tensor],
    x,
    *broadcast_args,
    mesh,
    n_micro: int,
    axis_name: str = "pp",
    remat: bool = False,
    with_aux: bool = False,
    interleave: int = 1,
    remat_policy=None,
    schedule: str = "auto",
):
    """Run ``x`` through ``n_layers`` stacked blocks, pipelined over
    ``axis_name`` (:515). ``block_fn(per_layer_params, x,
    *broadcast_args) -> y`` runs one block; ``stacked_params`` are
    ``[n_layers, ...]`` tensors held whole by every rank (rows are
    assigned contiguously; under ``interleave`` a rank's rows are its v
    chunks, so stack in ``vpp_layer_order``); each rank reads and
    differentiates only its rows. ``x`` is this rank's
    rows of the batch (or a DTensor over the other dims), the same on
    every stage; the result has its shape, on every stage. Gradients are
    SPMD: each rank's ``stacked_params`` get its rows' gradients (zeros
    elsewhere), and ``x`` its gradient on stage 0 only, where it enters
    (JAX's global view sums these over the ranks). ``schedule``: "auto"
    (GPipe, or VPP with ``interleave > 1``) or "zb"."""
    if with_aux:
        from .._refuse import EP, refuse
        raise refuse("pipeline with_aux (MoE gate losses over pp)", EP)
    axis = mesh_axis(axis_name, mesh)
    p, d = axis.size, axis.index
    n_layers = stacked_params[0].shape[0]
    if p == 1:
        h = x
        for i in range(n_layers):
            h = block_fn([w[i] for w in stacked_params], h, *broadcast_args)
        return h
    lc = _checked(n_layers, p, n_micro, interleave, schedule)
    # this rank's contiguous rows (JAX's P(axis_name)); under VPP, chunk c
    # is virtual stage c * p + d (stack in vpp_layer_order for the layers'
    # own order, as stack_block_params does)
    rows = range(d * lc * interleave, (d + 1) * lc * interleave)

    def fn(ps, h):
        return block_fn(ps, h, *broadcast_args)

    layers = [[(fn, [w[i] for w in stacked_params])
               for i in rows[c * lc:(c + 1) * lc]] for c in range(interleave)]
    return run_pipeline(layers, x, n_micro=n_micro, axis_name=axis_name,
                        interleave=interleave, schedule=schedule,
                        remat=remat, remat_policy=remat_policy, mesh=mesh)


def stack_block_params(blocks, mesh=None, axis_name: str = "pp",
                       interleave: int = 1):
    """Stack per-block parameters into ``[n_layers, ...]`` tensors (:642):
    (stacked, names, decay_mask, order). With ``interleave > 1`` the layers
    are stacked in ``vpp_layer_order``. (The JAX function also returns
    each stack's sharding; the port's stacks are whole on every rank.)"""
    if interleave > 1 and mesh is not None:
        p = mesh.size(tuple(mesh.mesh_dim_names).index(axis_name))
        order = vpp_layer_order(len(blocks), p, interleave)
    else:
        order = list(range(len(blocks)))
    per_block = [[t for _, t in blocks[i].named_parameters()] for i in order]
    names = [n for n, _ in blocks[0].named_parameters()]
    for pb in per_block:
        if len(pb) != len(names):
            raise ValueError("pipeline blocks have differing parameter "
                             "structure")
    frozen = [n for n, t in blocks[0].named_parameters()
              if not t.requires_grad]
    if frozen:
        raise NotImplementedError(
            f"pipeline blocks with frozen params not supported: {frozen}")
    stacked = [torch.stack([pb[i].detach() for pb in per_block])
               for i in range(len(names))]
    decay = [t.ndim >= 3 for t in stacked]
    return stacked, names, decay, order
