"""Activation functionals — port of ``relu``, ``relu6``, ``gelu``, ``silu``
and ``softmax`` (``paddle_tpu/nn/functional/activation.py`` :10-143),
each through the op dispatcher: ``softmax`` under the JAX package's black
``OpDef("softmax")`` (bf16/fp16 inputs run in fp32 under AMP), the others
neutral."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core import dtype as dtype_mod
from ...core.op_registry import AMP_BLACK, OpDef, apply_fn

_SOFTMAX = OpDef("softmax", None, amp=AMP_BLACK)


def relu(x, name=None):
    return apply_fn("relu", F.relu, x)


def relu6(x, name=None):
    return apply_fn("relu6", F.relu6, x)


def gelu(x, approximate=False, name=None):
    """Paddle's default is the exact (erf) GELU; ``approximate=True`` is the
    tanh form (``jax.nn.gelu``'s default)."""
    return apply_fn("gelu", lambda a: F.gelu(
        a, approximate="tanh" if approximate else "none"), x)


def silu(x, name=None):
    return apply_fn("silu", F.silu, x)


def softmax(x, axis=-1, dtype=None, name=None):
    dt = dtype_mod.convert_dtype(dtype)

    def fn(a):
        if dt is not None:
            a = a.to(dt)
        return torch.softmax(a, int(axis))

    return apply_fn("softmax", fn, x, _opdef=_SOFTMAX)
