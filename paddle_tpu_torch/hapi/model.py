"""``hapi.Model`` — port of its batch steps (``paddle_tpu/hapi/model.py``
:26-188): ``prepare``, ``train_batch``, ``eval_batch``, ``predict_batch``
and ``parameters``.

``train_batch`` is the JAX package's jitted step (``_build_train_step``
:49-128) run eagerly: the network in training mode, the loss, the
gradients of every trainable parameter (``torch.autograd``; a parameter
the loss never reads gets a zero gradient, as under ``jax.grad``), the
optimizer's update (fp32 gradients, clip, coupled decay: ``Optimizer.
_apply``). BatchNorm layers update their running statistics in place
during the forward, as the JAX step's carried buffer updates do. It
returns ``[float(loss)]`` and the metrics (none: metrics are a later
slice), so each step reads the loss on the host once, as JAX's does. The
JAX package's eager step (:130-139) computes the same update, so
``prepare(jit=...)`` is accepted either way and there is one path.

The network and the inputs must be on one device: the port moves no data.
"""

from __future__ import annotations

import torch

from .._later import later_slice


def _item8(what):
    return later_slice(what, "Paddle API surface", "8")


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        if inputs is not None or labels is not None:
            raise _item8("Model(inputs=..., labels=...) input specs")
        self.network = network
        self._optimizer = None
        self._loss = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=True):
        if metrics is not None:
            raise _item8("Model.prepare(metrics=...)")
        if amp_configs is not None:
            raise _item8("Model.prepare(amp_configs=...)")
        self._optimizer = optimizer
        self._loss = loss

    def _loss_of(self, outs, ys):
        loss = self._loss(*outs, *ys)
        return loss[0] if isinstance(loss, (list, tuple)) else loss

    def train_batch(self, inputs, labels=None, update=True):
        if not update:
            raise _item8("Model.train_batch(update=False) (gradient "
                         "accumulation)")
        self.network.train()
        out = self.network(*_as_list(inputs))
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        loss = self._loss_of(outs, _as_list(labels))
        params = [p for p in self.network.parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        self._optimizer._step_count += 1
        self._optimizer._apply(params, grads)
        return [loss.item()], []

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        out = self.network(*_as_list(inputs))
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        ys = _as_list(labels)
        if self._loss is None or not ys:
            return [], []
        return [self._loss_of(outs, ys).item()], []

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        return self.network(*_as_list(inputs))

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())

    def fit(self, *args, **kwargs):
        raise _item8("Model.fit (with callbacks and metrics)")

    def evaluate(self, *args, **kwargs):
        raise _item8("Model.evaluate")

    def predict(self, *args, **kwargs):
        raise _item8("Model.predict")

    def save(self, *args, **kwargs):
        raise _item8("Model.save")

    def load(self, *args, **kwargs):
        raise _item8("Model.load")

    def summary(self, *args, **kwargs):
        raise _item8("Model.summary")

    def flops(self, *args, **kwargs):
        raise _item8("Model.flops")
