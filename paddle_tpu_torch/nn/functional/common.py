"""Common functionals — port of ``linear``, ``dropout`` and ``flatten``
(``paddle_tpu/nn/functional/common.py`` :20-54; ``flatten`` from
``paddle_tpu/tensor/manipulation.py:34``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..._later import later_slice


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (the Paddle
    layout, not ``torch.nn.functional.linear``'s ``[out, in]``)."""
    return F.linear(x, weight.t(), bias)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Inverted dropout (:40-54): keep each element with probability
    1 - p and scale the kept ones by 1 / (1 - p); the identity outside
    training or at p = 0. The keep mask comes from ``generator`` (a
    ``torch.Generator`` on x's device) or torch's default one; its bits
    cannot equal ``jax.random``'s."""
    if axis is not None or mode != "upscale_in_train":
        raise later_slice("dropout with axis= or mode='downscale_in_infer'",
                          "Paddle API surface", "8")
    if not training or p == 0.0:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - p, generator=generator).bool()
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return torch.flatten(x, start_axis, stop_axis)
