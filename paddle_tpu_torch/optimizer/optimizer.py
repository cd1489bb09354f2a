"""Optimizers — port of ``paddle_tpu/optimizer/optimizer.py``: the
``Optimizer`` base and its fourteen optimizers.

Each optimizer is one per-tensor rule ``_update(g, val, p, lr)`` that
returns the new value (accumulators read with ``_acc`` and replaced with
``_set_acc``, never mutated in place). Two callers share it, as in the JAX
package:

- eager :meth:`Optimizer.step` (gradients in ``param.grad``): clip the raw
  gradients in their own dtype, cast them to fp32, add the coupled decay,
  update, write the result back in the parameter's dtype. ``lr`` is a
  Python float, typed as JAX types it (weakly: a bf16 parameter rounds it
  to bf16 where the two meet);
- :meth:`Optimizer._functional_update`, for ``hapi.Model`` and the
  training ``Engine``: it swaps in the caller's accumulator store and step
  counter and takes ``lr`` and ``step`` as fp32 0-dim device tensors, which
  promote as JAX's strong fp32 scalars do (a bf16 operand goes to fp32).
  Nothing is read back to the host.

Both give each parameter ``lr`` times its ``ParamAttr`` learning-rate
factor, and its own regularizer in place of ``weight_decay`` where it has
one. JAX's ``_functional_update`` (its hapi and Engine steps) leaves the
factor out; the port applies it on both paths (ROADMAP, "Deliberate
departures").

torch's own promotion matches neither; :mod:`..framework.promotion` writes
JAX's out. Accumulators are fp32 tensors on the parameter's device, keyed
by the parameter object; ``state_dict`` keys them by the parameter's
position in the optimizer's list, as the JAX package does.

``AdamW``'s ``apply_decay_param_fun`` reads a parameter's name: the port
names each parameter by its ``named_parameters()`` name, kept as
``param.param_name`` (torch reserves ``Tensor.name``;
:func:`name_parameters`, which ``hapi.Model`` and the Engine call).
"""

from __future__ import annotations

import warnings
from typing import List

import numpy as np
import torch

from .._later import later_slice
from ..core.tensor import unwrap
from ..framework.promotion import scale
from ..regularizer import L2Decay, WeightDecayRegularizer
from .lr import LRScheduler

_F32 = torch.float32


def name_parameters(model: torch.nn.Module) -> torch.nn.Module:
    """Give each parameter of ``model`` its ``named_parameters()`` name as
    ``.param_name``, the name ``AdamW(apply_decay_param_fun=)`` reads; a
    parameter named by its ``ParamAttr(name=)`` keeps that name."""
    for n, p in model.named_parameters():
        if not getattr(p, "attr_named", False):
            p.param_name = n
    return model


def _param_name(p) -> str:
    name = getattr(p, "param_name", None)
    if name is None:
        raise ValueError(
            "apply_decay_param_fun needs each parameter's name: pass the "
            "model through hapi.Model or the Engine, or call "
            "paddle_tpu_torch.optimizer.name_parameters(model) first")
    return name


def _as_f32(x):
    """A Python number as an fp32 0-dim tensor (as jnp ops on weak floats
    give); a tensor passes unchanged."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=_F32)


def _param_lr(lr, p):
    """The rate of ``p``'s update: ``lr`` times its ``ParamAttr``
    learning-rate factor (``optimize_attr``, JAX ``optimizer.py:160``);
    ``lr`` itself at the factor 1, so no op is added a parameter."""
    factor = getattr(p, "optimize_attr", None)
    factor = 1.0 if factor is None else factor.get("learning_rate", 1.0)
    return lr if factor == 1.0 else lr * factor


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._param_groups = None
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            # groups are flattened; no per-group setting applies (as in
            # the JAX package)
            self._param_groups = self._parameter_list
            flat = []
            for g in self._param_groups:
                flat.extend(g["params"])
            self._parameter_list = flat
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators = {}   # name -> {param: fp32 tensor}
        self._step_count = 0

    # ---- lr ----
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        self._lr = value

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    @property
    def _learning_rate(self):
        return self._lr

    def _lr_step(self):
        if isinstance(self._lr, LRScheduler):
            self._lr.step()

    # ---- state ----
    def state_dict(self):
        """``{"step_count", "accumulators": {name: {str(position): tensor}},
        "LR_Scheduler"}``, the JAX package's layout."""
        out = {"step_count": self._step_count}
        id2key = {id(p): str(i)
                  for i, p in enumerate(self._parameter_list or [])}
        out["accumulators"] = {
            name: {id2key.get(id(k), str(id(k))): v.detach()
                   for k, v in d.items()}
            for name, d in self._accumulators.items()}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        """Resume from :meth:`state_dict`'s layout; arrays may be tensors or
        numpy arrays (a JAX optimizer's state through
        ``weights.state_from_jax_optimizer``)."""
        self._step_count = int(state.get("step_count", 0))
        params = self._parameter_list or []
        for name, d in state.get("accumulators", {}).items():
            restored = {}
            for k, v in d.items():
                idx = int(k)
                if 0 <= idx < len(params):
                    t = v if isinstance(v, torch.Tensor) else \
                        torch.from_numpy(np.array(v))
                    restored[params[idx]] = t.to(params[idx].device)
            self._accumulators[name] = restored
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])

    def _acc(self, name, p, fill=0.0, shape=None):
        """Accumulator ``name`` of ``p``, created at first use as fp32
        ``fill`` of ``shape`` (default: ``p``'s)."""
        d = self._accumulators.setdefault(name, {})
        if p not in d:
            d[p] = torch.full(tuple(p.shape) if shape is None else shape,
                              fill, dtype=_F32, device=p.device)
        return d[p]

    def _set_acc(self, name, p, value):
        self._accumulators[name][p] = value

    # ---- update ----
    def _update(self, g, val, p, lr):
        raise NotImplementedError(
            f"{type(self).__name__} has no per-tensor update rule")

    def _l2_coeff(self) -> float:
        """L2 coefficient of ``weight_decay`` (a number, or a regularizer
        carrying one); decoupled-decay optimizers (AdamW) get none."""
        wd = self._weight_decay
        if wd is None or isinstance(self, _DecoupledWeightDecay):
            return 0.0
        if isinstance(wd, (int, float)):
            return float(wd)
        for attr in ("_regularization_coeff", "_coeff"):
            if hasattr(wd, attr):
                return float(getattr(wd, attr))
        return 0.0

    def _decay_term(self, value, g_dtype, param=None):
        """The coupled decay added to the gradient, or None: a regularizer
        object's own term (L1's ``coeff * sign(p)``), a number as L2. A
        parameter's own regularizer (``ParamAttr(regularizer=)``) replaces
        the optimizer's ``weight_decay`` (the reference's precedence)."""
        if isinstance(self, _DecoupledWeightDecay):
            return None
        wd = getattr(param, "regularizer", None)
        if not isinstance(wd, WeightDecayRegularizer):
            wd = self._weight_decay
        if wd is None:
            return None
        if isinstance(wd, WeightDecayRegularizer):
            return wd(value).to(g_dtype)
        coeff = self._l2_coeff()
        return coeff * value.to(g_dtype) if coeff else None

    @torch.no_grad()
    def step(self):
        params = self._parameter_list
        if params is None:
            raise ValueError("optimizer created without parameters")
        # plain torch ops on Paddle Parameters: no Python dispatch, and no
        # Paddle operator (the dispatcher) on their detached values
        with torch._C.DisableTorchFunctionSubclass():
            pg = [(p, p.grad) for p in params]
            if self._grad_clip is not None:
                pg = self._grad_clip(pg)
            self._step_count += 1
            for p, g in pg:
                if g is None or not p.requires_grad:
                    continue
                g = unwrap(g).float()
                val = p.detach()
                d = self._decay_term(val, g.dtype, p)
                if d is not None:
                    g = g + d
                p.copy_(self._update(g, val, p,
                                     _param_lr(self.get_lr(), p)))

    @torch.no_grad()
    def _functional_update(self, grads, values, params, acc_state, lr,
                           step):
        """New values of ``values`` and the new accumulator store, from
        fp32 ``grads``; ``acc_state`` ({name: {param: tensor}}) and
        ``step`` stand in for the optimizer's own store and counter."""
        saved_acc, saved_step = self._accumulators, self._step_count
        self._accumulators = acc_state
        self._step_count = step
        try:
            new_vals = []
            with torch._C.DisableTorchFunctionSubclass():
                for g, v, p in zip(grads, values, params):
                    if g is None:
                        new_vals.append(v)
                        continue
                    g, v = unwrap(g), unwrap(v)
                    d = self._decay_term(v, g.dtype, p)
                    if d is not None:
                        g = g + d
                    new_vals.append(self._update(
                        g, v, p, _param_lr(lr, p)).to(v.dtype))
        finally:
            new_acc = self._accumulators
            self._accumulators = saved_acc
            self._step_count = saved_step
        return new_vals, new_acc

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        if not isinstance(loss, torch.Tensor):
            raise later_slice("Optimizer.minimize on a static-graph loss",
                              "Paddle API surface", "8")
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in (self._parameter_list or [])]

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad


class _DecoupledWeightDecay:
    pass


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, g, val, p, lr):
        return val - scale(lr, g.to(val.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, g, val, p, lr):
        v = self._acc("velocity", p)
        v = self._momentum * v + g
        self._set_acc("velocity", p, v)
        if self._nesterov:
            return val - scale(lr, (g + self._momentum * v).to(val.dtype))
        return val - scale(lr, v.to(val.dtype))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update(self, g, val, p, lr):
        m = self._acc("moment", p, fill=self._init_acc)
        m = m + g * g
        self._set_acc("moment", p, m)
        return val - (lr * g / (torch.sqrt(m) + self._epsilon)).to(val.dtype)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update(self, g, val, p, lr):
        ms = self._acc("mean_square", p)
        ms = self._rho * ms + (1 - self._rho) * g * g
        self._set_acc("mean_square", p, ms)
        if self._centered:
            mg = self._acc("mean_grad", p)
            mg = self._rho * mg + (1 - self._rho) * g
            self._set_acc("mean_grad", p, mg)
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._acc("momentum", p)
        mom = self._momentum * mom + lr * g / denom
        self._set_acc("momentum", p, mom)
        return val - mom.to(val.dtype)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _update(self, g, val, p, lr):
        avg_sq = self._acc("avg_squared_grad", p)
        avg_upd = self._acc("avg_squared_update", p)
        avg_sq = self._rho * avg_sq + (1 - self._rho) * g * g
        upd = torch.sqrt(avg_upd + self._epsilon) / torch.sqrt(
            avg_sq + self._epsilon) * g
        avg_upd = self._rho * avg_upd + (1 - self._rho) * upd * upd
        self._set_acc("avg_squared_grad", p, avg_sq)
        self._set_acc("avg_squared_update", p, avg_upd)
        return val - (lr * upd).to(val.dtype)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = amsgrad

    def _update(self, g, val, p, lr):
        t = self._step_count
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        mhat = m / (1 - self._beta1 ** t)
        if self._amsgrad:
            vmax = self._acc("moment2_max", p)
            vmax = torch.maximum(vmax, v)
            self._set_acc("moment2_max", p, vmax)
            vhat = vmax / (1 - self._beta2 ** t)
        else:
            vhat = v / (1 - self._beta2 ** t)
        return val - (lr * mhat / (torch.sqrt(vhat) + self._epsilon)).to(
            val.dtype)


class AdamW(Adam, _DecoupledWeightDecay):
    """Decoupled weight decay: ``val - lr * coeff * val`` in the
    parameter's dtype, then Adam's step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        if isinstance(weight_decay, L2Decay):
            weight_decay = weight_decay._coeff
        elif isinstance(weight_decay, WeightDecayRegularizer):
            raise TypeError(
                f"AdamW weight_decay must be a number or L2Decay, got "
                f"{weight_decay}: L1 sign semantics cannot be expressed as "
                "decoupled (multiplicative) decay — use Adam with an L1Decay "
                "regularizer instead")
        if weight_decay is None:
            self._wd_coeff = 0.0
        elif isinstance(weight_decay, (str, bytes)):
            raise TypeError(
                f"AdamW weight_decay must be a number or L2Decay, got "
                f"{type(weight_decay).__name__}")
        else:
            try:
                self._wd_coeff = float(weight_decay)
            except (TypeError, ValueError):
                raise TypeError(
                    f"AdamW weight_decay must be a number or L2Decay, got "
                    f"{type(weight_decay).__name__}") from None
        for p in self._parameter_list or []:
            if isinstance(getattr(p, "regularizer", None),
                          WeightDecayRegularizer):
                warnings.warn(
                    f"ParamAttr regularizer on "
                    f"{getattr(p, 'param_name', '?')} is "
                    "ignored by decoupled-decay optimizers (AdamW); use a "
                    "coupled optimizer (Adam + weight_decay) to apply it",
                    stacklevel=2)
                break
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, g, val, p, lr):
        decay = True
        if self._apply_decay_param_fun is not None:
            decay = self._apply_decay_param_fun(_param_name(p))
        if decay and self._wd_coeff:
            val = val - scale(lr * self._wd_coeff, val)
        return super()._update(g, val, p, lr)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, g, val, p, lr):
        t = self._step_count
        m = self._acc("moment", p)
        u = self._acc("inf_norm", p)
        m = self._beta1 * m + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * u, torch.abs(g))
        self._set_acc("moment", p, m)
        self._set_acc("inf_norm", p, u)
        return val - (lr / (1 - self._beta1 ** t) * m
                      / (u + self._epsilon)).to(val.dtype)


class NAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _update(self, g, val, p, lr):
        t = self._step_count
        mu_t = self._beta1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_t1 = self._beta1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        # a 0-dim accumulator that starts at 1
        mprod = self._acc("mu_product", p, fill=1.0, shape=())
        mprod_new = mprod * mu_t
        self._set_acc("mu_product", p, mprod_new)
        mhat = (mu_t1 * m / (1 - mprod_new * mu_t1)
                + (1 - mu_t) * g / (1 - mprod_new))
        vhat = v / (1 - self._beta2 ** t)
        return val - (lr * mhat / (torch.sqrt(vhat) + self._epsilon)).to(
            val.dtype)


class RAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update(self, g, val, p, lr):
        t = self._step_count
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        rho_inf = 2 / (1 - self._beta2) - 1
        rho_t = rho_inf - 2 * t * self._beta2 ** t / (1 - self._beta2 ** t)
        mhat = m / (1 - self._beta1 ** t)
        vhat = torch.sqrt(v / (1 - self._beta2 ** t))
        ratio = ((rho_t - 4) * (rho_t - 2) * rho_inf) / (
            (rho_inf - 4) * (rho_inf - 2) * rho_t)
        r = torch.sqrt(torch.clamp(_as_f32(ratio), min=1e-16))
        adaptive = val - (lr * r * mhat / (vhat + self._epsilon)).to(
            val.dtype)
        plain = val - (lr * mhat).to(val.dtype)
        # on the device when the step counter is a device scalar
        if isinstance(rho_t, torch.Tensor):
            return torch.where(rho_t > 4, adaptive, plain)
        return adaptive if rho_t > 4 else plain


class Lamb(Optimizer):
    """Layer-wise adaptive moments for large-batch training."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, g, val, p, lr):
        t = self._step_count
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        m = self._beta1 * m + (1 - self._beta1) * g
        v = self._beta2 * v + (1 - self._beta2) * g * g
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._epsilon)
        wd = 0.0 if (self._exclude_fn is not None and self._exclude_fn(p)) \
            else self._lamb_wd
        update = r + wd * val.float()
        w_norm = torch.linalg.vector_norm(val.float())
        u_norm = torch.linalg.vector_norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        return val - (lr * trust * update).to(val.dtype)


class LBFGS(Optimizer):
    """Limited-memory BFGS, line-search free; it has ``step(closure)`` and
    no per-tensor rule, so hapi and the Engine cannot run it."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._history_size = history_size
        self._s_hist: List = []
        self._y_hist: List = []
        self._prev_flat = None
        self._prev_grad = None

    @staticmethod
    def _flatten(tensors):
        return torch.cat([t.reshape(-1) for t in tensors])

    def step(self, closure=None):
        loss = None
        if closure is not None:
            loss = closure()
        params = [p for p in self._parameter_list if p.grad is not None]
        if not params:
            return loss
        with torch.no_grad():
            self._step(params)
        return loss

    def _step(self, params):
        flat_g = self._flatten([p.grad.float() for p in params])
        flat_p = self._flatten([p.detach().float() for p in params])
        if self._prev_flat is not None:
            s = flat_p - self._prev_flat
            y = flat_g - self._prev_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                if len(self._s_hist) > self._history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
        q = flat_g
        alphas = []
        for s, y in zip(reversed(self._s_hist), reversed(self._y_hist)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if self._s_hist:
            s, y = self._s_hist[-1], self._y_hist[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        direction = -q
        self._prev_flat = flat_p
        self._prev_grad = flat_g
        new_flat = flat_p + self.get_lr() * direction
        off = 0
        for p in params:
            n = p.numel()
            p.copy_(new_flat[off:off + n].reshape(p.shape))
            off += n
        self._step_count += 1


class ASGD(Optimizer):
    """Averaged SGD: steps with the mean of the last ``batch_num``
    gradients, kept in a circular buffer ``ys`` ([batch_num, *p.shape])
    with running sum ``d``: d <- d - ys[i] + g."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = max(int(batch_num), 1)

    def _update(self, g, val, p, lr):
        n = self._batch_num
        d = self._acc("d", p)
        ys = self._acc("ys", p, shape=(n,) + tuple(p.shape))
        i = (self._step_count - 1) % n
        # a device index when the step counter is a device scalar
        i = (i.long().reshape(1) if isinstance(i, torch.Tensor) else
             torch.full((1,), i, dtype=torch.long, device=ys.device))
        oldest = ys.index_select(0, i)[0]
        d = d - oldest + g
        ys = ys.index_copy(0, i, g.unsqueeze(0))
        self._set_acc("d", p, d)
        self._set_acc("ys", p, ys)
        return val - (lr * d / float(n)).to(val.dtype)


class Rprop(Optimizer):
    """Resilient backprop: sign-based per-weight step sizes."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _update(self, g, val, p, lr):
        prev = self._acc("prev_grad", p)
        step = self._acc("step_size", p, fill=self.get_lr())
        sign = torch.sign(g * prev)
        factor = torch.where(sign > 0, self._eta_pos,
                             torch.where(sign < 0, self._eta_neg, 1.0))
        step = torch.clamp(step * factor, self._lr_min, self._lr_max)
        # where the sign flipped, zero the gradient (Rprop-)
        g_eff = torch.where(sign < 0, 0.0, g)
        self._set_acc("step_size", p, step)
        self._set_acc("prev_grad", p, g_eff)
        return val - (step * torch.sign(g_eff)).to(val.dtype)
