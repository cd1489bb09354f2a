"""The training engine — port of
``paddle_tpu/distributed/auto_parallel/engine.py``, on one device
(``mesh=None``) and over a mesh of ``dp``, ``fsdp``, ``sep``, ``tp`` and
``pp``.

``Engine(model).step(ids, labels)`` runs the JAX package's train step
(``_build_step`` :415-420): the step counter advances first, then the
model's ``loss_fn`` (forward, shifted fused cross-entropy) and its gradients
(``torch.autograd.grad``, the functional counterpart of
``jax.value_and_grad``; attention's backward runs the flash kernels K2/K3),
then the global-norm clip (``_clip_grads`` :333) and AdamW (``_adamw``
:391) with fp32 moments and no fp32 master weights: each parameter is read
as fp32, updated and rounded back to its own dtype, as the JAX step does.

The JAX step donates its buffers so XLA updates parameters and moments in
place; here they are updated in place under ``torch.no_grad()`` — the
model's own tensors ARE the engine's parameters, so ``sync_model`` has
nothing to copy. ``step`` returns the loss as a device tensor and reads no
value on the host (the clip stays on the device).

``Engine(model, optimizer=opt)`` trains with any ``paddle_tpu_torch.
optimizer.Optimizer`` instead (the JAX package's ``_build_opt_step``
:484-514): the same loss and gradients, the global-norm clip in the
gradients' dtype, then fp32 gradients into the optimizer's
``_functional_update`` with ``lr = opt.get_lr()`` read on the host each
step (an ``LRScheduler`` advances on the host) and the step counter as an
fp32 device scalar; nothing is read back. Its accumulators live in
``opt_state`` ({name: {param: tensor}}, created at the first step with the
optimizer's init values) and cross over by parameter name in
``state_dict()["opt"]``, the JAX engine's layout. An optimizer's clip must
be a ``ClipGradByGlobalNorm``, whose ``clip_norm`` the engine takes unless
the caller passed one.

The engine runs where the model lives (the CUDA device unless the model was
built with ``device="cpu"``).

``Engine(model, mesh)`` trains over a ``DeviceMesh`` (``make_mesh``), one
process per rank, each running the same program on its shards (the JAX
engine is one controller over every device; the port is SPMD). The model
is built from the same seed on every rank; ``shard_params`` makes each
parameter a DTensor placed by its logical axes (rank 0's values are
broadcast first where the mesh covers the world). The step is the one
above on DTensors: the model's ``constrain`` calls and the fsdp weight
gathers put the collectives where JAX's rules put them, the attention
kernels and the fused CE run on each rank's local shards, and the loss
comes back replicated. The gradients are reduced to their parameters'
placements (the dp all-reduce, the fsdp reduce-scatter), the global norm
sums every shard once, and AdamW (fp32 moments sharded like their
parameters, JAX's ZeRO) or ``optimizer=`` updates each rank's local
shards in place. ``shard_batch`` keeps the rank's ``dp x fsdp`` rows of
the global batch that every rank holds; ``step`` reads nothing on the
host. ``state_dict`` gathers whole tensors; ``set_state_dict`` takes each
rank's chunk of a snapshot, so a run saved on one mesh resumes on
another.

``Engine(model, guard=GuardPolicy(...))`` is the guarded step (JAX
:253-269, ``_build_guard_step`` :433-482): the same loss, gradients,
clip and AdamW, plus the on-device health word of ``framework.
numeric_guard.guard_step`` over the unclipped gradients, kept in
``last_health`` (an int32 device scalar; the caller reads it, ``step``
does not). The fault plan's code for the step (``numeric_inject_code``
of the host step index) scales the loss by ``SPIKE_INJECT_FACTOR`` inside
the differentiated function or adds NaN to every gradient. Unless the
policy only warns, a step whose word is non-zero leaves the parameters
and both moments bit-identical: the update is computed out of place and
each tensor takes its old or its new values by ``torch.where`` on the
word, on the device; the step counter advances either way. ``lr_scale``
(the watchdog's re-warm) multiplies the learning rate. Over a mesh each
rank tests its local gradient shards and the ``[nan, inf]`` flags are
OR-ed over the mesh's ranks (an all-reduce of two ints along each axis
of more than one rank), so every rank computes the same word and skips or
applies the same step.

Batches keep their dtype (JAX :533): integer arrays become int64 token
ids, floating ones stay floating.

A ``sep`` dim shards the sequence: attention over it is ring attention
(``ops.ring_attention``, through the model's attention route), the
labels are shifted on the global sequence before each rank takes its
positions, and replicated parameters' gradients are summed over sep by
their placements.

A ``pp`` dim of more than one rank pipelines a model with the pipeline
hooks (``pipeline_blocks``, ``pipeline_loss``, ``pipeline_block_fn``;
JAX :93-188, :360-383): each stage runs its share of the blocks (under
``pp_interleave`` its chunks, in ``vpp_layer_order``) over the mesh of the
other dims, with ``n_micro`` microbatches (default: pp) on the GPipe /
VPP schedule or ``pp_schedule="zb"`` (``auto_parallel.pipeline``),
``pp_remat`` (default: the model config's ``recompute``) checkpointing
each block with ``pp_remat_policy``. The embedding, the final norm and the
head run on every stage; their gradients are taken from stage 0, which
holds all of them (a broadcast over pp), and the global norm sums each
stage's block gradients over pp once. Inside a stage attention keeps the
flash kernels (JAX's manual pipeline drops to ``_xla_attention``, :334-340)
and, over a sep dim, the ring. ``state_dict`` gives JAX's pp layout
(:583-601): every parameter whole by name, the moments of the blocks as
``blocks.<name>`` stacked in ``_pp_order``; ``set_state_dict`` raises
under pp, as JAX's does.

Still refused, naming its part of item 6: an ``ep`` axis or an MoE model
over a mesh.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from torch.distributed.tensor import DTensor, Replicate

from ...framework import numeric_guard
from ...nn.clip import ClipGradByGlobalNorm
from ...optimizer import Optimizer, name_parameters
from ..resilience.faults import numeric_inject_code
from .._refuse import EP, refuse
from .logical_sharding import (DEFAULT_RULES, axis_rules, current_mesh,
                               local_chunk, logical_placements, shard_params)
from .process_mesh import as_device_mesh

_DEFAULT_CLIP = object()   # the caller did not choose a clip_norm


def _as_tensor(x, device, dtype=None):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def _as_batch(x, device):
    """A batch array on ``device``: integers as int64 token ids, floating
    arrays in their own dtype (the JAX engine's ``jnp.asarray``)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=None if t.is_floating_point()
                else torch.long)


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _dims(mesh):
    """{dim name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


class _LocalParam:
    """What the optimizer's update rules see of a sharded parameter: its
    local shard's shape and device, every other attribute (its name, its
    ``ParamAttr`` settings) the parameter's own. The JAX engine hands its
    optimizer a ``_ParamProxy`` alike."""

    def __init__(self, p):
        self._p = p
        self.shape = tuple(_local(p).shape)
        self.device = p.device

    def __getattr__(self, name):
        return getattr(self._p, name)


class Engine:
    """Trainer for a model with ``loss_fn(input_ids, labels)``::

        eng = Engine(model, lr=3e-4)
        loss = eng.step(input_ids, labels)   # device scalar, no host sync
    """

    def __init__(
        self,
        model: torch.nn.Module,
        mesh=None,
        *,
        lr: Union[float, Callable] = 1e-3,
        beta1: float = 0.9,
        beta2: float = 0.95,
        epsilon: float = 1e-8,
        weight_decay: float = 0.1,
        apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
        clip_norm: Optional[float] = _DEFAULT_CLIP,
        rules=None,
        loss_fn: Optional[Callable] = None,
        n_micro: Optional[int] = None,
        pp_remat: Optional[bool] = None,
        pp_interleave: int = 1,
        pp_schedule: str = "auto",
        pp_remat_policy="auto",
        optimizer=None,
        guard=None,
    ):
        mesh = as_device_mesh(mesh) if mesh is not None else current_mesh()
        if optimizer is not None and not isinstance(optimizer, Optimizer):
            raise TypeError(f"optimizer= takes a paddle_tpu_torch.optimizer."
                            f"Optimizer, got {type(optimizer).__name__}")
        if guard is not None and optimizer is not None:
            raise ValueError(
                "numeric guard supports the built-in AdamW path only "
                "(pass guard=None with a pluggable optimizer)")
        if mesh is not None:
            self._check_mesh(mesh, model)
        # the whole mesh (the guard's flags OR over all of it); under pp,
        # ``mesh`` becomes the other dims, over which each stage runs
        self._full_mesh = mesh
        self._pp = (mesh is not None and _dims(mesh).get("pp", 1) > 1
                    and hasattr(model, "pipeline_blocks"))
        if self._pp:
            mesh = self._setup_pp(model, mesh, loss_fn, n_micro, pp_remat,
                                  pp_interleave, pp_schedule,
                                  pp_remat_policy)
        self.mesh = mesh
        self.rules = tuple(rules) if rules is not None else DEFAULT_RULES
        self.model = model
        self.lr = lr
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.weight_decay = weight_decay
        self.clip_norm = 1.0 if clip_norm is _DEFAULT_CLIP else clip_norm
        self._loss_fn = loss_fn
        self._optimizer = optimizer

        name_parameters(model)
        if mesh is not None:
            with axis_rules(mesh, self.rules):
                shard_params(model, mesh)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        decay_names = [n for n, _ in named]
        if self._pp:
            # the parameters outside the blocks, then this stage's blocks'
            # (JAX :165-197: the "rest" first, then the stacks)
            block_ids = {id(t) for b in self._blocks
                         for t in b.parameters()}
            rest = [(n, p) for n, p in named if id(p) not in block_ids]
            own = [(f"{self._block_prefix[id(b)]}.{n}", t)
                   for chunk in self._stage_layers for b in chunk
                   for n, t in b.named_parameters() if t.requires_grad]
            self._n_rest = len(rest)
            named = rest + own
            # a block's decay decision goes by its name within the block,
            # as JAX's stacked names (:186-189)
            decay_names = [n for n, _ in rest] + [
                n for chunk in self._stage_layers for b in chunk
                for n, t in b.named_parameters() if t.requires_grad]
        self._param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        if not self.params:
            raise ValueError("the model has no trainable parameters")
        self.device = self.params[0].device
        # weight-decay mask: norm gains and biases (ndim <= 1) excluded
        if apply_decay_param_fun is not None:
            self._decay_mask = [bool(apply_decay_param_fun(n))
                                for n in decay_names]
        else:
            self._decay_mask = [p.ndim >= 2 for p in self.params]
        # what the update reads and writes: each rank's local shards
        self._proxies = ([_LocalParam(p) for p in self.params]
                         if mesh is not None else self.params)
        if optimizer is None:
            # fp32 moments placed like their parameters (ZeRO over fsdp)
            self.m = [torch.zeros_like(p, dtype=torch.float32)
                      for p in self.params]
            self.v = [torch.zeros_like(p, dtype=torch.float32)
                      for p in self.params]
        else:
            oc = optimizer._grad_clip
            if oc is not None:
                # only the global-norm clip is the engine's; another clip
                # must not be silently reinterpreted
                if not isinstance(oc, ClipGradByGlobalNorm):
                    raise ValueError(
                        f"Engine supports ClipGradByGlobalNorm only, got "
                        f"{type(oc).__name__}; pass clip_norm=... instead")
                if clip_norm is _DEFAULT_CLIP:
                    self.clip_norm = oc.clip_norm
            self.opt_state = {}
        self.step_count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)

        # the numeric guard: the detector state and the last health word
        # stay on the device; the re-warm factor and the fault plan's step
        # index are the host's
        self.guard = guard
        self.guard_state = None
        self.last_health = None
        self.lr_scale = 1.0
        self._host_step = 0
        if guard is not None:
            self.guard_state = numeric_guard.guard_init_state(self.device)

    @staticmethod
    def _check_mesh(mesh, model):
        shape = _dims(mesh)
        if shape.get("ep", 1) > 1:
            raise refuse("an ep axis over 1", EP)
        cfg = getattr(model, "config", None)
        if getattr(cfg, "num_experts", 1) > 1:
            raise refuse("an MoE model over a mesh", EP)
        unknown = set(shape) - {"dp", "fsdp", "sep", "tp", "pp", "ep"}
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")

    def _setup_pp(self, model, mesh, loss_fn, n_micro, pp_remat,
                  pp_interleave, pp_schedule, pp_remat_policy):
        """Pipeline parallelism (JAX :113-146): this rank's stage, its
        layers, the schedule's settings; returns the mesh of the other
        dims (None when pp is the only one), over which the stage runs."""
        from ..communication.functional import mesh_axis
        from .pipeline import _checked, vpp_layer_order

        if loss_fn is not None:
            raise ValueError(
                "custom loss_fn is not supported with pipeline parallelism "
                "(pp > 1) — the pp path runs model.pipeline_loss")
        pp = _dims(mesh)["pp"]
        self._pp_axis = mesh_axis("pp", mesh)
        self._blocks = list(model.pipeline_blocks())
        self._pp_interleave = v = pp_interleave
        self._pp_schedule = pp_schedule
        n = len(self._blocks)
        self._n_micro = n_micro if n_micro is not None else pp
        lc = _checked(n, pp, self._n_micro, v, pp_schedule)
        self._pp_remat = (pp_remat if pp_remat is not None else bool(
            getattr(getattr(model, "config", None), "recompute", False)))
        pol_fn = getattr(model, "remat_policy", None)
        model_policy = pol_fn() if callable(pol_fn) else None
        if pp_remat_policy == "auto":
            # zb's selective regime keeps each tick's weights' graph: zb
            # with remat keeps the boundary regime unless asked (:137-145)
            self._pp_remat_policy = (None if pp_schedule == "zb"
                                     else model_policy)
        elif pp_remat_policy == "model":
            self._pp_remat_policy = model_policy
        else:
            self._pp_remat_policy = pp_remat_policy
        if pp_schedule == "zb" and self._pp_remat:
            from .pipeline import _refuse_selective_zb
            _refuse_selective_zb(True, self._pp_remat_policy)
        # stacked row r holds layer _pp_order[r]; this rank holds rows
        # [d * L/p, (d+1) * L/p), chunk c the c-th lc of them
        self._pp_order = (vpp_layer_order(n, pp, v) if v > 1
                          else list(range(n)))
        d = self._pp_axis.index
        rows = self._pp_order[d * lc * v:(d + 1) * lc * v]
        self._stage_layers = [[self._blocks[i] for i in rows[c * lc:
                                                          (c + 1) * lc]]
                              for c in range(v)]
        names = {id(m): n for n, m in model.named_modules()}
        self._block_prefix = {id(b): names[id(b)] for b in self._blocks}
        rest = [n for n in mesh.mesh_dim_names if n != "pp"]
        if not rest:
            return None
        return mesh[rest[0]] if len(rest) == 1 else mesh[tuple(rest)]

    def _run_blocks(self, x, cos, sin):
        """The pipeline over this rank's blocks (JAX :360-383)."""
        from .pipeline import run_pipeline

        fn_of = self.model.pipeline_block_fn

        def bind(b):
            f = fn_of(b)
            return (lambda ps, h: f(ps, h, cos, sin),
                    [t for t in b.parameters()])

        layers = [[bind(b) for b in chunk] for chunk in self._stage_layers]
        return run_pipeline(layers, x, n_micro=self._n_micro,
                            axis_name=self._pp_axis,
                            interleave=self._pp_interleave,
                            schedule=self._pp_schedule,
                            remat=self._pp_remat,
                            remat_policy=self._pp_remat_policy)

    def _pp_broadcast(self, t, stage):
        """``t`` (a local tensor, or a DTensor's local shard) := its value
        on pipeline stage ``stage`` (over the pp dim, in place)."""
        axis = self._pp_axis
        loc = _local(t)
        buf = loc if loc.is_contiguous() else loc.contiguous()
        dist.broadcast(buf, src=axis.ranks[stage], group=axis.group)
        if buf is not loc:
            loc.copy_(buf)

    # ---- the step ----
    def _loss(self, input_ids, labels):
        if self._pp:
            return self.model.pipeline_loss(input_ids, labels,
                                            self._run_blocks)
        fn = self._loss_fn or self.model.loss_fn
        return fn(input_ids, labels)

    def _clip_grads(self, grads):
        if self.clip_norm is None:
            return grads
        if self.mesh is None:
            def sumsq(gs):
                return sum(torch.sum(torch.square(g.float())) for g in gs)
        else:
            sumsq = self._mesh_sumsq
        if self._pp:
            # the parameters outside the blocks once, each stage's blocks
            # summed over pp
            blocks = sumsq(grads[self._n_rest:])
            dist.all_reduce(blocks, group=self._pp_axis.group)
            gsq = sumsq(grads[:self._n_rest]) + blocks
        else:
            gsq = sumsq(grads)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-6),
                            max=1.0)
        # each rank scales its local shards
        return [_local(g) * scale.to(g.dtype) for g in grads]

    @staticmethod
    def _mesh_sumsq(grads):
        """The squared global norm over every shard, each counted once (JAX
        :333-342): the local sums of squares add up per placement (partial
        over the sharded axes, replicated over the others), and each group
        is reduced once."""
        groups = {}
        for g in grads:
            sq = torch.sum(torch.square(g.float()))
            key = tuple(sq.placements)
            groups[key] = sq if key not in groups else groups[key] + sq
        return sum(sq.full_tensor() for sq in groups.values())

    def _lr(self, scale=1.0):
        lr = self.lr(self.step_count) if callable(self.lr) else self.lr
        if scale != 1.0:
            # JAX multiplies by the fp32 scale it was handed (:391-395)
            lr = (lr * float(np.float32(scale)) if callable(self.lr)
                  else float(np.float32(lr) * np.float32(scale)))
        return lr

    @torch.no_grad()
    def _adamw(self, grads, bad=None, lr_scale=1.0):
        """AdamW in place. With ``bad`` (the guard's skip, a device bool)
        the new moments go to fresh tensors, and each parameter and moment
        then keeps its old values where ``bad`` is set, so a skipped step
        leaves them bit-identical (NaN x 0 would not)."""
        b1, b2, eps, wd = self.beta1, self.beta2, self.epsilon, \
            self.weight_decay
        lr = self._lr(lr_scale)
        stepf = self.step_count.float()
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        grads = self._clip_grads(grads)
        for p, mm, vv, g, decay in zip(self.params, self.m, self.v, grads,
                                       self._decay_mask):
            p, mm, vv, g = _local(p), _local(mm), _local(vv), _local(g)
            gf = g.float()
            mm2, vv2 = (mm, vv) if bad is None else (torch.empty_like(mm),
                                                     torch.empty_like(vv))
            torch.mul(mm, b1, out=mm2).add_((1.0 - b1) * gf)
            torch.mul(vv, b2, out=vv2).add_((1.0 - b2) * gf * gf)
            update = (mm2 / bc1) / (torch.sqrt(vv2 / bc2) + eps)
            pf = p.float()
            if decay:
                update = update + wd * pf
            new_p = pf - lr * update
            if bad is None:
                p.copy_(new_p)
            else:
                p.copy_(torch.where(bad, p, new_p.to(p.dtype)))
                mm.copy_(torch.where(bad, mm, mm2))
                vv.copy_(torch.where(bad, vv, vv2))

    @torch.no_grad()
    def _opt_update(self, grads):
        grads = [g.float() for g in self._clip_grads(grads)]
        # read on the host each step (a schedule advances there)
        lr = torch.full((), self._optimizer.get_lr(), dtype=torch.float32,
                        device=self.device)
        locals_ = [_local(p) for p in self.params]
        new_p, self.opt_state = self._optimizer._functional_update(
            [_local(g) for g in grads], locals_, self._proxies,
            self.opt_state, lr, self.step_count.float())
        for p, v in zip(locals_, new_p):
            p.copy_(v)

    def shard_batch(self, *arrays):
        """The host batch (the same global batch on every rank) as DTensors
        on the mesh: each rank keeps its rows of the ``dp x fsdp`` split
        and its columns of the ``sep`` one (JAX ``_batch_sharding``). With
        no mesh, tensors on the engine's device."""
        out = []
        for a in arrays:
            t = _as_tensor(a, self.device)
            if self.mesh is not None:
                axes = ("batch", "seq") + (None,) * (t.ndim - 2)
                pl = logical_placements(axes[:t.ndim], self.mesh, self.rules)
                ways = [1] * t.ndim
                for i, p in enumerate(pl):
                    if p.is_shard():
                        ways[p.dim] *= self.mesh.size(i)
                for d, n in enumerate(ways):
                    # JAX's device_put refuses an uneven batch sharding too
                    if t.shape[d] % n:
                        raise ValueError(
                            f"dim {d} of a {tuple(t.shape)} batch does not "
                            f"divide over the {n} ranks that shard it")
                t = DTensor.from_local(
                    local_chunk(t, self.mesh, pl).contiguous(), self.mesh,
                    pl, run_check=False, shape=t.shape, stride=t.stride())
            out.append(t)
        return tuple(out) if len(out) > 1 else out[0]

    def _to_device(self, input_ids, labels):
        if self.mesh is None:
            return (_as_batch(input_ids, self.device),
                    _as_batch(labels, self.device))
        return tuple(
            x if isinstance(x, DTensor) else self.shard_batch(
                _as_batch(x, self.device))
            for x in (input_ids, labels))

    def _run_loss(self, ids, lbl):
        if self.mesh is None:
            return self._loss(ids, lbl)
        with axis_rules(self.mesh, self.rules):
            loss = self._loss(ids, lbl)
        if isinstance(loss, DTensor) and any(
                p.is_partial() for p in loss.placements):
            # a loss that reduces over sharded rows itself (a plain mean)
            # is a partial value: reduce it, as JAX's global mean is
            loss = loss.redistribute(loss.device_mesh,
                                     [Replicate()] * loss.device_mesh.ndim)
        return loss

    @staticmethod
    def _replicated_value(loss):
        """The loss as a plain device scalar (under a mesh: the replicated
        value every rank holds)."""
        return loss.to_local() if isinstance(loss, DTensor) else loss

    def step(self, input_ids, labels):
        """Run one train step; returns the loss as a device scalar tensor."""
        ids, lbl = self._to_device(input_ids, labels)
        inject = numeric_guard.INJECT_NONE
        if self.guard is not None:
            self._host_step += 1
            inject = numeric_inject_code(str(self._host_step))
        with torch.no_grad():
            self.step_count += 1
        with torch.enable_grad():
            loss = self._run_loss(ids, lbl)
            if inject == numeric_guard.INJECT_LOSS_SPIKE:
                loss = (loss.float()
                        * numeric_guard.SPIKE_INJECT_FACTOR).to(loss.dtype)
            # a parameter the loss does not read (BERT's token-type table
            # without token types, the MLM head's pooler) gets a zero
            # gradient, as under jax.grad: weight decay still moves it
            grads = torch.autograd.grad(loss, self.params, allow_unused=True,
                                        materialize_grads=True)
        if self.mesh is not None:
            # partial sums over dp/fsdp reduced to the parameters' own
            # placements: the dp all-reduce and the fsdp reduce-scatter
            grads = [g if tuple(g.placements) == tuple(p.placements)
                     else g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, self.params)]
        if self._pp:
            # the embedding, final norm and head run on every stage; stage
            # 0 holds all of their gradients (the embedding's enters the
            # pipeline there), so every stage takes stage 0's, once
            with torch.no_grad():
                for g in grads[:self._n_rest]:
                    self._pp_broadcast(g, 0)
        loss = self._replicated_value(loss.detach())
        if self.guard is not None:
            self._guarded_update(loss, grads, inject)
        elif self._optimizer is None:
            self._adamw(grads)
        else:
            self._opt_update(grads)
        return loss

    def _or_ranks(self, flags):
        """``flags`` OR-ed over the mesh's ranks: a MAX all-reduce along
        each axis of more than one rank (the mesh's own groups)."""
        mesh = self._full_mesh
        for dim, n in enumerate(mesh.shape):
            if n > 1:
                dist.all_reduce(flags, op=dist.ReduceOp.MAX,
                                group=mesh.get_group(dim))
        return flags

    @torch.no_grad()
    def _guarded_update(self, loss, grads, inject):
        if inject == numeric_guard.INJECT_NAN_GRAD:
            grads = [g + float("nan") for g in grads]
        pol = self.guard
        word, self.guard_state = numeric_guard.guard_step(
            loss, [_local(g) for g in grads], self.guard_state,
            spike_factor=pol.spike_factor, warmup_steps=pol.warmup_steps,
            reduce_flags=(self._or_ranks if self._full_mesh is not None
                          else None))
        self.last_health = word
        self._adamw(grads, (word & pol.skip_mask) != 0, self.lr_scale)

    def release(self):
        """Drop the engine's references to the model, its parameters and
        moments and its device state, so their memory can go before a
        replacement engine is built (the resilience trainer's rollback).
        The engine cannot step afterwards."""
        self.model = None
        self.params, self.m, self.v = [], [], []
        self._proxies = []
        self.opt_state = {}
        self.guard_state = self.last_health = None

    @torch.no_grad()
    def eval_loss(self, input_ids, labels):
        """The loss at the current parameters (no update)."""
        ids, lbl = self._to_device(input_ids, labels)
        return self._replicated_value(self._run_loss(ids, lbl))

    # ---- state ----
    def sync_model(self):
        """The model, whose tensors the engine updates in place. Under pp
        every rank's copy of each block first takes the values of the
        stage that trains it (JAX :575-587 writes the stacked rows back;
        a collective call)."""
        if self._pp:
            with torch.no_grad():
                for i, b in enumerate(self._blocks):
                    for t in b.parameters():
                        self._pp_broadcast(t.detach(), self._owner(i))
        return self.model

    def _owner(self, layer):
        """The pp stage that trains block ``layer``."""
        per = len(self._blocks) // self._pp_axis.size
        return self._pp_order.index(layer) // per

    def _pp_state(self, states):
        """Under pp, ``states`` ({param: local tensor} of this rank's
        parameters) as JAX's engine names them (:589-601): the parameters
        outside the blocks by name, the blocks' as ``blocks.<name>``
        stacked over the layers in ``_pp_order`` (each row broadcast from
        the stage that trains it), all whole."""
        out = {n: self._whole(states[id(p)], p)
               for n, p in zip(self._param_names[:self._n_rest],
                               self.params[:self._n_rest])}
        names = [n for n, _ in self._blocks[0].named_parameters()]
        mine = list(self._stage_layers[0][0].parameters())
        for j, name in enumerate(names):
            rows = []
            for i in self._pp_order:
                p = list(self._blocks[i].parameters())[j]
                t = states.get(id(p))
                # another stage's: a buffer shaped as this rank's own
                t = (_local(t).clone() if t is not None else
                     torch.zeros_like(_local(states[id(mine[j])])))
                self._pp_broadcast(t, self._owner(i))
                rows.append(self._whole(t, p))
            out[f"blocks.{name}"] = torch.stack(rows)
        return out

    def _whole(self, t, like=None):
        """A copy of ``t`` whole: a DTensor gathered, a sharded parameter's
        local accumulator (``like``: the parameter) placed as its parameter
        and gathered."""
        if isinstance(t, DTensor):
            return t.full_tensor()
        if like is not None and isinstance(like, DTensor):
            if tuple(t.shape) == tuple(_local(like).shape):
                return DTensor.from_local(
                    t, like.device_mesh, like.placements, run_check=False,
                    shape=like.shape, stride=like.stride()).full_tensor()
        return t.clone()

    def state_dict(self):
        """Copies of the parameters and the step count, with the optimizer
        state keyed by parameter name, as the JAX engine keys it: the fp32
        moments ``m`` and ``v`` of the built-in AdamW, or a pluggable
        optimizer's accumulators ``opt`` ({acc: {name: tensor}}). Under a
        mesh every tensor is gathered whole (a collective call)."""
        with torch.no_grad():
            if self._pp:
                return self._pp_state_dict()
            out = {"model": {n: self._whole(p.detach())
                             for n, p in zip(self._param_names, self.params)},
                   "step": self.step_count.clone()}
            if self._optimizer is not None:
                idx = {id(k): i for i, k in enumerate(self._proxies)}
                out["opt"] = {
                    acc: {self._param_names[idx[id(k)]]: self._whole(
                        a, self.params[idx[id(k)]]) for k, a in d.items()}
                    for acc, d in self.opt_state.items()}
            else:
                out["m"] = {n: self._whole(a)
                            for n, a in zip(self._param_names, self.m)}
                out["v"] = {n: self._whole(a)
                            for n, a in zip(self._param_names, self.v)}
            return out

    def _pp_state_dict(self):
        """:meth:`state_dict` under pp: every parameter of the model by its
        name, whole (after :meth:`sync_model`), and the optimizer state in
        JAX's pp layout (:meth:`_pp_state`)."""
        self.sync_model()
        out = {"model": {n: self._whole(p.detach())
                         for n, p in self.model.named_parameters()
                         if p.requires_grad},
               "step": self.step_count.clone()}
        if self._optimizer is not None:
            key = {id(k): id(p) for k, p in zip(self._proxies, self.params)}
            out["opt"] = {acc: self._pp_state({key[id(k)]: a
                                               for k, a in d.items()})
                          for acc, d in self.opt_state.items()}
        else:
            out["m"] = self._pp_state({id(p): a for p, a in
                                       zip(self.params, self.m)})
            out["v"] = self._pp_state({id(p): a for p, a in
                                       zip(self.params, self.v)})
        return out

    @staticmethod
    def _copy_in(name, dst, src):
        """``dst`` := ``src`` (whole); a DTensor takes this rank's chunk."""
        src = _as_tensor(src, dst.device, dst.dtype)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(src.shape)} vs {tuple(dst.shape)}")
        if isinstance(dst, DTensor):
            _local(dst).copy_(local_chunk(src, dst.device_mesh,
                                          dst.placements))
        else:
            dst.copy_(src)

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Resume in place from a :meth:`state_dict` snapshot; arrays may be
        tensors or numpy arrays (for example a JAX engine's state carried by
        ``paddle_tpu_torch.weights.engine_state_from_jax``). Each tensor is
        whole; under a mesh each rank keeps its chunk, so a snapshot of
        any mesh resumes on this engine's (JAX :603-640). Under pp it
        raises, as JAX's does."""
        if self._pp:
            raise NotImplementedError(
                "set_state_dict with pipeline-stacked params is not "
                "supported yet — rebuild the Engine and load via "
                "model.set_state_dict")
        keys = ("m", "v") if self._optimizer is None else ()
        missing = [n for n in self._param_names
                   if n not in state_dict["model"]
                   or any(n not in state_dict[k] for k in keys)]
        if missing:
            raise KeyError(f"state missing for params {missing}")
        for name, p in zip(self._param_names, self.params):
            self._copy_in(name, p, state_dict["model"][name])
        if self._optimizer is None:
            for name, mm, vv in zip(self._param_names, self.m, self.v):
                self._copy_in(name, mm, state_dict["m"][name])
                self._copy_in(name, vv, state_dict["v"][name])
        else:
            by_name = dict(zip(self._param_names,
                               zip(self.params, self._proxies)))
            self.opt_state = {}
            for acc, d in state_dict["opt"].items():
                sub = self.opt_state[acc] = {}
                for n, a in d.items():
                    p, key = by_name[n]
                    a = _as_tensor(a, self.device)
                    if (isinstance(p, DTensor)
                            and tuple(a.shape) == tuple(p.shape)):
                        a = local_chunk(a, p.device_mesh,
                                        p.placements).clone()
                    sub[key] = a
        self.step_count.copy_(_as_tensor(state_dict["step"], self.device,
                                         torch.int32))
        return self
