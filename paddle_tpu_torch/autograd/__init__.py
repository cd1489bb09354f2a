"""paddle_tpu_torch.autograd — port of ``paddle_tpu/autograd/__init__.py``
on ``torch.autograd``.

``backward`` / ``grad`` / the grad-mode switches re-export the port's
autograd API; ``PyLayer`` (reference autograd/py_layer.py:36) runs a custom
forward and backward through ``torch.autograd.Function``: the forward runs
without recording, its float tensor inputs get the gradients the user's
``backward`` returns, in order. As in the JAX package, differentiating
through a ``PyLayer`` with ``create_graph=True`` raises (its backward is
not itself differentiable), ``hessian`` raises, and ``saved_tensors_hooks``
is a context that does nothing.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.autograd_engine import (enable_grad, grad, grad_enabled,  # noqa
                                    no_grad, set_grad_enabled)
from ..core.tensor import Tensor, unwrap, wrap


def backward(tensors, grad_tensors=None, retain_graph=False):
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is not None and not isinstance(grad_tensors,
                                                   (list, tuple)):
        grad_tensors = [grad_tensors]
    for i, t in enumerate(tensors):
        g = grad_tensors[i] if grad_tensors is not None else None
        t.backward(g, retain_graph=retain_graph)


def is_grad_enabled():
    return grad_enabled()


class PyLayerContext:
    def __init__(self):
        self._saved = []
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    def saved_tensor(self):
        return self._saved

    saved_tensors = property(lambda self: self._saved)

    def mark_not_inplace(self, *tensors):
        self.not_inplace_tensors = tensors


def _is_diff(a) -> bool:
    return isinstance(a, torch.Tensor) and a.is_floating_point()


class _PyLayerFunction(torch.autograd.Function):
    """The torch Function behind every PyLayer: ``layer`` is the user's
    class, ``ctx.paddle`` its PyLayerContext."""

    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        pctx = PyLayerContext()
        ctx.paddle, ctx.layer = pctx, layer
        ctx.diff = [_is_diff(a) for a in args]
        out = layer.forward(pctx, *[wrap(a) if isinstance(a, torch.Tensor)
                                    else a for a in args], **kwargs)
        ctx.single = not isinstance(out, (tuple, list))
        outs = [out] if ctx.single else list(out)
        return tuple(unwrap(o) if isinstance(o, torch.Tensor)
                     else torch.as_tensor(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"create_graph=True cannot differentiate through PyLayer "
                f"'{ctx.layer.__name__}': its backward is not recorded. Use "
                f"paddle.autograd.jacobian, or express the op through the "
                f"Paddle functions")
        got = ctx.layer.backward(ctx.paddle, *[wrap(g) for g in grads])
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        out, it = [None, None], iter(got)
        for diff in ctx.diff:
            g = next(it, None) if diff else None
            out.append(unwrap(g) if isinstance(g, torch.Tensor) else g)
        return tuple(out)


class PyLayerMeta(type):
    def __init__(cls, name, bases, attrs):
        super().__init__(name, bases, attrs)


class PyLayer(metaclass=PyLayerMeta):
    """Custom autograd op (reference: autograd/py_layer.py:36).

    class Exp(PyLayer):
        @staticmethod
        def forward(ctx, x): ctx.save_for_backward(x); return x.exp()
        @staticmethod
        def backward(ctx, dy): (x,) = ctx.saved_tensor(); return dy * x.exp()
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        outs = _PyLayerFunction.apply(cls, kwargs, *args)
        outs = [wrap(o) for o in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)


class PyLayerLegacy(PyLayer):
    pass


def jacobian(ys, xs, batch_axis=None):
    """The dense Jacobian, row by row through ``grad`` (as the JAX
    package builds it): for each x, a [numel(ys), numel(x)] matrix."""
    xs_list = xs if isinstance(xs, (list, tuple)) else [xs]
    ys_list = ys if isinstance(ys, (list, tuple)) else [ys]
    blocks = [[] for _ in xs_list]
    for y in ys_list:
        n = y.numel()
        for i in range(n):
            seed = torch.zeros(n, dtype=y.dtype, device=y.device)
            seed[i] = 1.0
            gs = grad([y], xs_list, grad_outputs=[seed.reshape(y.shape)],
                      retain_graph=True, allow_unused=True)
            for k, (g, x) in enumerate(zip(gs, xs_list)):
                blocks[k].append(unwrap(g).reshape(-1) if g is not None
                                 else torch.zeros(x.numel(), dtype=x.dtype,
                                                  device=x.device))
    jac = [wrap(torch.stack(rows)) for rows in blocks]
    return jac if isinstance(xs, (list, tuple)) else jac[0]


def hessian(func_out, xs):
    raise NotImplementedError("use jax.hessian via paddle_tpu.jit for "
                              "higher-order AD")


def saved_tensors_hooks(*args, **kwargs):
    return contextlib.nullcontext()


__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext", "PyLayerLegacy",
           "jacobian", "hessian", "saved_tensors_hooks", "Tensor"]
