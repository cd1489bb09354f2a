"""Parameter initializers — the distributions of ``paddle_tpu/nn/
initializer.py`` (the ones the port's layers and models use), drawn from
an explicit ``torch.Generator``.

The draws cannot equal ``jax.random``'s: weights cross over by name
instead (:func:`paddle_tpu_torch.weights.load_jax_state`). Each
initializer draws from its JAX counterpart's distribution, in fp32 on the
target device, and casts to the parameter's dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device


def _fans(shape):
    """(fan_in, fan_out) as the JAX package counts them (:15-25): a conv
    kernel is ``[out, in, *spatial]``, a matrix ``[in, out]``."""
    shape = tuple(shape)
    if not shape:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _fp32(shape, device):
    return torch.empty(tuple(shape), dtype=torch.float32, device=device)


class Constant:
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, shape, dtype, device, generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class Uniform:
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device, generator=None):
        return _fp32(shape, device).uniform_(
            self.low, self.high, generator=generator).to(dtype)


class TruncatedNormal:
    """``mean + std * z``, z a standard normal cut to [a, b] (:50-56)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype, device, generator=None):
        z = nn.init.trunc_normal_(_fp32(shape, device), 0.0, 1.0, self.a,
                                  self.b, generator=generator)
        return (z * self.std + self.mean).to(dtype)


class XavierNormal:
    def __call__(self, shape, dtype, device, generator=None):
        fi, fo = _fans(shape)
        return _fp32(shape, device).normal_(
            0.0, math.sqrt(2.0 / (fi + fo)), generator=generator).to(dtype)


class XavierUniform:
    def __call__(self, shape, dtype, device, generator=None):
        fi, fo = _fans(shape)
        limit = math.sqrt(6.0 / (fi + fo))
        return _fp32(shape, device).uniform_(
            -limit, limit, generator=generator).to(dtype)


class KaimingNormal:
    def __init__(self, fan_in=None):
        self.fan_in = fan_in

    def __call__(self, shape, dtype, device, generator=None):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        return _fp32(shape, device).normal_(
            0.0, math.sqrt(2.0 / fi), generator=generator).to(dtype)


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
