"""Single-device training engine — port of
``paddle_tpu/distributed/auto_parallel/engine.py`` (``mesh=None``).

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
built with ``device="cpu"``). Meshes, the numeric guard and pipeline
parallelism arrive with later slices and raise here.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..._later import later_slice
from ...nn.clip import ClipGradByGlobalNorm
from ...optimizer import Optimizer, name_parameters

# what the caller can use until the slices arrive
_ONE_DEVICE = ("; this slice trains on one device (Engine(model, "
               "mesh=None), the built-in AdamW or optimizer=)")

_DEFAULT_CLIP = object()   # the caller did not choose a clip_norm


def _as_tensor(x, device, dtype=None):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype)


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
        loss_fn: Optional[Callable] = None,
        n_micro: Optional[int] = None,
        pp_remat: Optional[bool] = None,
        pp_interleave: int = 1,
        pp_schedule: str = "auto",
        pp_remat_policy="auto",
        optimizer=None,
        guard=None,
    ):
        if mesh is not None:
            raise later_slice("mesh training (mesh=)",
                              "distributed-training", "6", _ONE_DEVICE)
        if (n_micro is not None or pp_remat is not None or pp_interleave != 1
                or pp_schedule != "auto" or pp_remat_policy != "auto"):
            raise later_slice("pipeline parallelism (n_micro=, pp_*=)",
                              "distributed-training", "6", _ONE_DEVICE)
        if optimizer is not None and not isinstance(optimizer, Optimizer):
            raise TypeError(f"optimizer= takes a paddle_tpu_torch.optimizer."
                            f"Optimizer, got {type(optimizer).__name__}")
        if guard is not None:
            raise later_slice("the numeric guard (guard=)", "resilience",
                              "6", _ONE_DEVICE)
        self.model = model
        self.lr = lr
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.weight_decay = weight_decay
        self.clip_norm = 1.0 if clip_norm is _DEFAULT_CLIP else clip_norm
        self._loss_fn = loss_fn
        self._optimizer = optimizer

        name_parameters(model)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self._param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        if not self.params:
            raise ValueError("the model has no trainable parameters")
        self.device = self.params[0].device
        # weight-decay mask: norm gains and biases (ndim <= 1) excluded
        if apply_decay_param_fun is not None:
            self._decay_mask = [bool(apply_decay_param_fun(n))
                                for n in self._param_names]
        else:
            self._decay_mask = [p.ndim >= 2 for p in self.params]
        if optimizer is None:
            self.m = [torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for p in self.params]
            self.v = [torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for p in self.params]
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

    # ---- the step ----
    def _loss(self, input_ids, labels):
        fn = self._loss_fn or self.model.loss_fn
        return fn(input_ids, labels)

    def _clip_grads(self, grads):
        if self.clip_norm is None:
            return grads
        gsq = sum(torch.sum(torch.square(g.float())) for g in grads)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-6),
                            max=1.0)
        return [g * scale.to(g.dtype) for g in grads]

    @torch.no_grad()
    def _adamw(self, grads):
        b1, b2, eps, wd = self.beta1, self.beta2, self.epsilon, \
            self.weight_decay
        step = self.step_count
        lr = self.lr(step) if callable(self.lr) else self.lr
        stepf = step.float()
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        grads = self._clip_grads(grads)
        for p, mm, vv, g, decay in zip(self.params, self.m, self.v, grads,
                                       self._decay_mask):
            gf = g.float()
            mm.mul_(b1).add_((1.0 - b1) * gf)
            vv.mul_(b2).add_((1.0 - b2) * gf * gf)
            update = (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
            pf = p.float()
            if decay:
                update = update + wd * pf
            p.copy_(pf - lr * update)

    @torch.no_grad()
    def _opt_update(self, grads):
        grads = [g.float() for g in self._clip_grads(grads)]
        # read on the host each step (a schedule advances there)
        lr = torch.full((), self._optimizer.get_lr(), dtype=torch.float32,
                        device=self.device)
        new_p, self.opt_state = self._optimizer._functional_update(
            grads, self.params, self.params, self.opt_state, lr,
            self.step_count.float())
        for p, v in zip(self.params, new_p):
            p.copy_(v)

    def _to_device(self, input_ids, labels):
        return (_as_tensor(input_ids, self.device, torch.long),
                _as_tensor(labels, self.device, torch.long))

    def step(self, input_ids, labels):
        """Run one train step; returns the loss as a device scalar tensor."""
        ids, lbl = self._to_device(input_ids, labels)
        with torch.no_grad():
            self.step_count += 1
        with torch.enable_grad():
            loss = self._loss(ids, lbl)
            # a parameter the loss does not read (BERT's token-type table
            # without token types, the MLM head's pooler) gets a zero
            # gradient, as under jax.grad: weight decay still moves it
            grads = torch.autograd.grad(loss, self.params, allow_unused=True,
                                        materialize_grads=True)
        if self._optimizer is None:
            self._adamw(grads)
        else:
            self._opt_update(grads)
        return loss.detach()

    @torch.no_grad()
    def eval_loss(self, input_ids, labels):
        """The loss at the current parameters (no update)."""
        ids, lbl = self._to_device(input_ids, labels)
        return self._loss(ids, lbl)

    # ---- state ----
    def sync_model(self):
        """The model, whose tensors the engine updates in place."""
        return self.model

    def state_dict(self):
        """Copies of the parameters and the step count, with the optimizer
        state keyed by parameter name, as the JAX engine keys it: the fp32
        moments ``m`` and ``v`` of the built-in AdamW, or a pluggable
        optimizer's accumulators ``opt`` ({acc: {name: tensor}})."""
        with torch.no_grad():
            out = {"model": {n: p.detach().clone()
                             for n, p in zip(self._param_names, self.params)},
                   "step": self.step_count.clone()}
            if self._optimizer is not None:
                name_of = dict(zip(self.params, self._param_names))
                out["opt"] = {acc: {name_of[p]: a.clone()
                                    for p, a in d.items()}
                              for acc, d in self.opt_state.items()}
            else:
                out["m"] = {n: a.clone()
                            for n, a in zip(self._param_names, self.m)}
                out["v"] = {n: a.clone()
                            for n, a in zip(self._param_names, self.v)}
            return out

    @staticmethod
    def _copy_in(name, dst, src):
        src = _as_tensor(src, dst.device, dst.dtype)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(src.shape)} vs {tuple(dst.shape)}")
        dst.copy_(src)

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Resume in place from a :meth:`state_dict` snapshot; arrays may be
        tensors or numpy arrays (for example a JAX engine's state carried by
        ``paddle_tpu_torch.weights.engine_state_from_jax``)."""
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
            by_name = dict(zip(self._param_names, self.params))
            self.opt_state = {
                acc: {by_name[n]: _as_tensor(a, self.device)
                      for n, a in d.items()}
                for acc, d in state_dict["opt"].items()}
        self.step_count.copy_(_as_tensor(state_dict["step"], self.device,
                                         torch.int32))
        return self
