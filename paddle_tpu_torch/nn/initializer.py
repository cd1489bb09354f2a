"""Parameter initializers — port of ``paddle_tpu/nn/initializer.py``:
every initializer and ``calculate_gain``, drawn from an explicit
``torch.Generator``.

The draws cannot equal ``jax.random``'s: weights cross over by name
instead (:func:`paddle_tpu_torch.weights.load_jax_state`). Each
initializer draws from its JAX counterpart's distribution, in fp32 on the
target device, and casts to the parameter's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core import dtype as dtype_mod
from ..device import resolve_device
from ..framework.random import generator as global_generator


def _fans(shape, fan_in=None, fan_out=None):
    """(fan_in, fan_out) as the JAX package counts them (:15-25): a conv
    kernel is ``[out, in, *spatial]``, a matrix ``[in, out]``; a given
    ``fan_in`` / ``fan_out`` replaces the counted one."""
    shape = tuple(shape)
    if not shape:
        fi, fo = 1, 1
    elif len(shape) == 1:
        fi, fo = shape[0], shape[0]
    elif len(shape) == 2:
        fi, fo = shape[0], shape[1]
    else:
        receptive = math.prod(shape[2:])
        fi, fo = shape[1] * receptive, shape[0] * receptive
    return (fi if fan_in is None else fan_in,
            fo if fan_out is None else fan_out)


def _fp32(shape, device):
    return torch.empty(tuple(shape), dtype=torch.float32, device=device)


class Initializer:
    """``init(shape, dtype, device=None, generator=None)``: a tensor of
    ``shape`` in ``dtype`` (default fp32) on ``device`` (default: the
    current place) drawn from ``generator`` (default: that device's global
    generator)."""

    def __call__(self, shape, dtype=None, device=None, generator=None):
        dev = resolve_device(device)
        gen = generator if generator is not None else global_generator(dev)
        return self._draw(tuple(shape), dev, gen).to(
            dtype_mod.convert_dtype(dtype) or torch.float32)

    def _draw(self, shape, device, generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = float(value)

    def _draw(self, shape, device, generator):
        return torch.full(shape, self.value, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, device, generator):
        return _fp32(shape, device).normal_(self.mean, self.std,
                                            generator=generator)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _draw(self, shape, device, generator):
        return _fp32(shape, device).uniform_(self.low, self.high,
                                             generator=generator)


class TruncatedNormal(Initializer):
    """``mean + std * z``, z a standard normal cut to [a, b] (:50-56)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _draw(self, shape, device, generator):
        z = nn.init.trunc_normal_(_fp32(shape, device), 0.0, 1.0, self.a,
                                  self.b, generator=generator)
        return z * self.std + self.mean


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, device, generator):
        fi, fo = _fans(shape, self.fan_in, self.fan_out)
        return _fp32(shape, device).normal_(
            0.0, self.gain * math.sqrt(2.0 / (fi + fo)), generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, device, generator):
        fi, fo = _fans(shape, self.fan_in, self.fan_out)
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _fp32(shape, device).uniform_(-limit, limit,
                                             generator=generator)


class KaimingNormal(Initializer):
    """std sqrt(2 / ((1 + negative_slope^2) fan_in)); ``nonlinearity`` is
    not read, as in the JAX package (:95-105)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def _draw(self, shape, device, generator):
        fi = _fans(shape, self.fan_in)[0]
        std = math.sqrt(2.0 / ((1 + self.negative_slope ** 2) * fi))
        return _fp32(shape, device).normal_(0.0, std, generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def _draw(self, shape, device, generator):
        fi = _fans(shape, self.fan_in)[0]
        limit = math.sqrt(6.0 / ((1 + self.negative_slope ** 2) * fi))
        return _fp32(shape, device).uniform_(-limit, limit,
                                             generator=generator)


class Assign(Initializer):
    """The given value (array, list or tensor) reshaped to ``shape``."""

    def __init__(self, value):
        self.value = value

    def _draw(self, shape, device, generator):
        v = self.value
        v = v.detach() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v))
        return v.to(device=device, dtype=torch.float32).reshape(shape)


class Orthogonal(Initializer):
    """``jax.nn.initializers.orthogonal(gain)`` (:136-141): the trailing
    axis against the rest flattened, Q of the QR of a standard normal
    matrix (signs fixed by R's diagonal), transposed when wide."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _draw(self, shape, device, generator):
        rows, cols = math.prod(shape[:-1]), shape[-1]
        big, small = max(rows, cols), min(rows, cols)
        a = _fp32((big, small), device).normal_(generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q).reshape(shape)


class Dirac(Initializer):
    """Ones at the spatial centre of ``[i, i % in]`` for the first
    min(out, in x groups) kernels, zeros elsewhere (:144-155)."""

    def __init__(self, groups=1):
        self.groups = groups

    def _draw(self, shape, device, generator):
        arr = np.zeros(shape, dtype=np.float32)
        oc, ic = shape[0], shape[1]
        mid = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            arr[(i, i % ic) + mid] = 1.0
        return torch.from_numpy(arr).to(device)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


# the lower-case names ParamAttr(initializer=...) code uses
constant = Constant
normal = Normal
uniform = Uniform


def create_parameter(shape, init, device, generator=None,
                     dtype=torch.float32):
    """An ``nn.Parameter`` of ``shape`` drawn by ``init`` (one of the
    initializers above) from ``generator`` on ``device``."""
    return nn.Parameter(init(shape, dtype, device, generator))


def seeded(device, seed):
    """(device, generator) for a model's constructor: ``device`` resolved
    (the CUDA device when None; raises without one unless ``device="cpu"``)
    and a ``torch.Generator`` on it seeded by ``seed``."""
    dev = resolve_device(device)
    return dev, torch.Generator(device=dev).manual_seed(int(seed))
