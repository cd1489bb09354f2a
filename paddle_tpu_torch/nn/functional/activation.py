"""Activation functionals — port of ``paddle_tpu/nn/functional/
activation.py``, each through the op dispatcher under the JAX package's op
name: ``softmax`` and ``log_softmax`` under its black ``OpDef("softmax")``
(bf16/fp16 inputs run in fp32 under AMP), the others neutral (they run in
the dtype they are given).

Each computes the JAX function's formula, with torch's fused op where that
op is the same formula. ``rrelu`` outside training uses the mean slope
(lower + upper) / 2, as the JAX package does always; in training it draws
one slope an element from U(lower, upper) (Paddle's meaning, which the
JAX package leaves out), from ``generator`` or the global generator of the
input's device. ``gumbel_softmax`` draws its noise there too; its bits
cannot equal ``jax.random``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core import dtype as dtype_mod
from ...core.op_registry import AMP_BLACK, OpDef, apply_fn
from ...framework.random import generator as global_generator

_SOFTMAX = OpDef("softmax", None, amp=AMP_BLACK)


def _gen(a, generator):
    return generator if generator is not None else global_generator(a.device)


def _inplace(fn, x, *args):
    from ...tensor import _inplace as inplace
    return inplace(fn, fn.__name__ + "_")(x, *args)


def relu(x, name=None):
    return apply_fn("relu", F.relu, x)


def relu_(x, name=None):
    """:func:`relu` written into ``x``."""
    return _inplace(relu, x)


def relu6(x, name=None):
    return apply_fn("relu6", F.relu6, x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_fn("leaky_relu", lambda a: F.leaky_relu(a, negative_slope),
                    x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x >= 0, x, w x)`` with one slope, or one a channel (axis 1
    for NC* layouts, the last axis otherwise)."""
    def fn(a, w):
        if w.numel() == 1:
            return torch.where(a >= 0, a, w.reshape(()) * a)
        shape = [1] * a.ndim
        shape[1 if data_format.startswith("NC") else a.ndim - 1] = w.numel()
        return torch.where(a >= 0, a, w.reshape(shape) * a)

    return apply_fn("prelu", fn, x, weight)


def rrelu(x, lower=0.125, upper=0.333, training=False, name=None,
          generator=None):
    def fn(a):
        if not training:
            return torch.where(a >= 0, a, (lower + upper) / 2 * a)
        slope = torch.empty_like(a).uniform_(lower, upper,
                                             generator=_gen(a, generator))
        return torch.where(a >= 0, a, slope * a)

    return apply_fn("rrelu", fn, x)


def elu(x, alpha=1.0, name=None):
    return apply_fn("elu", lambda a: F.elu(a, alpha), x)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_fn("selu", lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)), x)


def celu(x, alpha=1.0, name=None):
    return apply_fn("celu", lambda a: F.celu(a, alpha), x)


def gelu(x, approximate=False, name=None):
    """Paddle's default is the exact (erf) GELU; ``approximate=True`` is the
    tanh form (``jax.nn.gelu``'s default)."""
    return apply_fn("gelu", lambda a: F.gelu(
        a, approximate="tanh" if approximate else "none"), x)


def silu(x, name=None):
    return apply_fn("silu", F.silu, x)


swish = silu


def mish(x, name=None):
    return apply_fn("mish", F.mish, x)


def hardswish(x, name=None):
    return apply_fn("hardswish", F.hardswish, x)


def hardsigmoid(x, slope=1 / 6, offset=0.5, name=None):
    return apply_fn("hardsigmoid", lambda a: torch.clamp(
        slope * a + offset, 0, 1), x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply_fn("hardtanh", lambda a: F.hardtanh(a, min, max), x)


def hardshrink(x, threshold=0.5, name=None):
    return apply_fn("hardshrink", lambda a: F.hardshrink(a, threshold), x)


def softshrink(x, threshold=0.5, name=None):
    return apply_fn("softshrink", lambda a: F.softshrink(a, threshold), x)


def tanhshrink(x, name=None):
    return apply_fn("tanhshrink", F.tanhshrink, x)


def _in_dtype(v, a):
    """The Python scalar ``v`` rounded to a's dtype, as JAX's weak typing
    rounds it before comparing (torch's CPU kernels compare a bf16 input
    with the unrounded scalar, its CUDA kernels with the rounded one)."""
    return float(torch.tensor(v, dtype=a.dtype)) if a.is_floating_point() \
        else v


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply_fn("thresholded_relu", lambda a: F.threshold(
        a, _in_dtype(threshold, a), value), x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply_fn("softplus", lambda a: F.softplus(a, beta, threshold), x)


def softsign(x, name=None):
    return apply_fn("softsign", F.softsign, x)


def sigmoid(x, name=None):
    return apply_fn("sigmoid", torch.sigmoid, x)


def logsigmoid(x, name=None):
    return apply_fn("log_sigmoid", F.logsigmoid, x)


log_sigmoid = logsigmoid


def tanh(x, name=None):
    return apply_fn("tanh", torch.tanh, x)


def softmax(x, axis=-1, dtype=None, name=None):
    dt = dtype_mod.convert_dtype(dtype)

    def fn(a):
        if dt is not None:
            a = a.to(dt)
        return torch.softmax(a, int(axis))

    return apply_fn("softmax", fn, x, _opdef=_SOFTMAX)


def log_softmax(x, axis=-1, dtype=None, name=None):
    dt = dtype_mod.convert_dtype(dtype)

    def fn(a):
        if dt is not None:
            a = a.to(dt)
        return torch.log_softmax(a, int(axis))

    return apply_fn("log_softmax", fn, x, _opdef=_SOFTMAX)


def softmax_(x, axis=-1, dtype=None, name=None):
    """:func:`softmax` written into ``x``."""
    return _inplace(softmax, x, axis, dtype)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """softmax((x + g) / temperature), g Gumbel noise; ``hard`` gives the
    one-hot of the argmax with the soft values' gradient."""
    def fn(a):
        u = torch.rand(a.shape, dtype=a.dtype, device=a.device,
                       generator=_gen(a, generator))
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(a.dtype).tiny)))
        y = torch.softmax((a + g) / temperature, axis)
        if hard:
            onehot = torch.zeros_like(y).scatter_(
                axis, y.argmax(axis, keepdim=True), 1.0)
            y = onehot + y - y.detach()
        return y

    return apply_fn("gumbel_softmax", fn, x)


def maxout(x, groups, axis=1, name=None):
    def fn(a):
        ax = axis % a.ndim
        c = a.shape[ax]
        shape = a.shape[:ax] + (c // groups, groups) + a.shape[ax + 1:]
        return a.reshape(shape).amax(ax + 1)

    return apply_fn("maxout", fn, x)


def glu(x, axis=-1, name=None):
    return apply_fn("glu", lambda a: F.glu(a, axis), x)
