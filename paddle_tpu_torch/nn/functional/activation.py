"""Activation functionals — port of ``relu``, ``relu6``, ``gelu`` and
``silu`` (``paddle_tpu/nn/functional/activation.py`` :13-64)."""

from __future__ import annotations

import torch.nn.functional as F


def relu(x, name=None):
    return F.relu(x)


def relu6(x, name=None):
    return F.relu6(x)


def gelu(x, approximate=False, name=None):
    """Paddle's default is the exact (erf) GELU; ``approximate=True`` is the
    tanh form (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return F.silu(x)
