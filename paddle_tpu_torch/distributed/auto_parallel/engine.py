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

The engine runs where the model lives (the CUDA device unless the model was
built with ``device="cpu"``). Meshes, pluggable optimizers, the numeric
guard and pipeline parallelism arrive with later slices and raise here.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..._later import later_slice

# what the caller can use until the slices arrive
_ONE_DEVICE = ("; this slice trains on one device with the built-in AdamW "
               "(Engine(model, mesh=None))")


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
        clip_norm: Optional[float] = 1.0,
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
        if optimizer is not None:
            raise later_slice("pluggable optimizers (optimizer=)",
                              "Paddle API surface", "8", _ONE_DEVICE)
        if guard is not None:
            raise later_slice("the numeric guard (guard=)", "resilience",
                              "6", _ONE_DEVICE)
        self.model = model
        self.lr = lr
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self._loss_fn = loss_fn

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
        self.m = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in self.params]
        self.v = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in self.params]
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
        self._adamw(grads)
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
        """Copies of the parameters, the fp32 moments (keyed by parameter
        name, as the JAX engine keys them) and the step count."""
        with torch.no_grad():
            return {
                "model": {n: p.detach().clone()
                          for n, p in zip(self._param_names, self.params)},
                "step": self.step_count.clone(),
                "m": {n: a.clone() for n, a in zip(self._param_names, self.m)},
                "v": {n: a.clone() for n, a in zip(self._param_names, self.v)},
            }

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Resume in place from a :meth:`state_dict` snapshot; arrays may be
        tensors or numpy arrays (for example a JAX engine's state carried by
        ``paddle_tpu_torch.weights.engine_state_from_jax``)."""
        missing = [n for n in self._param_names
                   if n not in state_dict["model"] or n not in state_dict["m"]
                   or n not in state_dict["v"]]
        if missing:
            raise KeyError(f"state missing for params {missing}")
        for name, p, mm, vv in zip(self._param_names, self.params, self.m,
                                   self.v):
            for dst, src in ((p, state_dict["model"][name]),
                             (mm, state_dict["m"][name]),
                             (vv, state_dict["v"][name])):
                src = _as_tensor(src, dst.device, dst.dtype)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"shape mismatch for {name}: "
                                     f"{tuple(src.shape)} vs "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        self.step_count.copy_(_as_tensor(state_dict["step"], self.device,
                                         torch.int32))
        return self
