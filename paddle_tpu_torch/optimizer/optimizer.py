"""Optimizers — port of the ``Optimizer`` base, ``SGD`` and ``Momentum``
(``paddle_tpu/optimizer/optimizer.py`` :23-255), the part ``hapi.Model``
needs.

One update path serves ``step()`` (gradients in ``param.grad``) and
``hapi.Model.train_batch``: it takes the gradients in fp32, clips them
(``grad_clip``), adds the coupled L2 term ``weight_decay * param``, and
runs each optimizer's ``_update`` — the JAX package's
``_functional_update`` (:164) after its hapi step's cast and clip
(``paddle_tpu/hapi/model.py`` :80-95). Accumulators (Momentum's velocity)
are fp32. The updates are plain PyTorch ops, one parameter at a time.
"""

from __future__ import annotations

import torch

from .._later import later_slice


def _item8(what):
    return later_slice(what, "Paddle API surface", "8")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise _item8("an LR scheduler as learning_rate")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise _item8("a regularizer object as weight_decay")
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            raise _item8("parameter groups")
        self._lr = float(learning_rate)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators = {}   # name -> {param: fp32 tensor}
        self._step_count = 0

    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value):
        self._lr = float(value)

    def state_dict(self):
        raise _item8("Optimizer.state_dict")

    def set_state_dict(self, state):
        raise _item8("Optimizer.set_state_dict")

    def _acc(self, name, p):
        d = self._accumulators.setdefault(name, {})
        if p not in d:
            d[p] = torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        return d[p]

    def _decay_term(self, value, g_dtype):
        """The coupled L2 term ``weight_decay * value`` (in the gradient's
        dtype) added to the gradient, or None."""
        if not self._weight_decay:
            return None
        return float(self._weight_decay) * value.to(g_dtype)

    def _update(self, g, value, p, lr):
        raise NotImplementedError

    @torch.no_grad()
    def _apply(self, params, grads):
        """One update of ``params`` (tensors updated in place) from
        ``grads`` (any dtype; a None gradient leaves its parameter as it
        is): fp32, clip, decay, ``_update``."""
        pg = [(p, None if g is None else g.float())
              for p, g in zip(params, grads)]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        lr = self.get_lr()
        for p, g in pg:
            if g is None:
                continue
            d = self._decay_term(p, g.dtype)
            if d is not None:
                g = g + d
            p.copy_(self._update(g, p, p, lr))

    def step(self):
        """Update the parameters given at construction from their
        ``.grad``."""
        if self._parameter_list is None:
            raise ValueError("optimizer created without parameters")
        self._step_count += 1
        params = [p for p in self._parameter_list if p.requires_grad]
        self._apply(params, [p.grad for p in params])

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            p.grad = None

    clear_gradients = clear_grad


class SGD(Optimizer):
    def _update(self, g, value, p, lr):
        return value - lr * g.to(value.dtype)


class Momentum(Optimizer):
    """Heavy-ball momentum: ``v = momentum * v + g``, then
    ``p - lr * v`` (Nesterov: ``p - lr * (g + momentum * v)``)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, g, value, p, lr):
        v = self._acc("velocity", p)
        v.mul_(self._momentum).add_(g)
        if self._nesterov:
            return value - lr * (g + self._momentum * v).to(value.dtype)
        return value - lr * v.to(value.dtype)
