"""Helpers the model families share: weight init, the JAX package's
LayerNorm rounding, causal attention routing and the generator replay
that remat needs. One definition each, so Llama, GPT and BERT agree."""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_dtype
from ..nn.functional.flash_attention import _xla_attention
from ..ops.flash_attention import flash_attention


def _normal(shape, config, device, gen):
    t = torch.empty(shape, dtype=resolve_dtype(config.dtype), device=device)
    t.normal_(0.0, config.initializer_range, generator=gen)
    return nn.Parameter(t)


def _layer_norm(x, w, b, eps):
    """LayerNorm in the JAX package's rounding (bert :104-108, gpt
    :64-70): fp32 statistics (population variance), the normalised value
    cast to x's dtype, then ``* w + b`` in that dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _attention(q, k, v, config):
    """Causal attention on [b, s, h, d] tensors: the single-device branches
    of the JAX package's ``_attention`` (llama :320-365), the flash
    kernels, or with ``config.use_flash_attention`` False the dense
    ``_xla_attention`` (plain tensor ops on either device, as in the JAX
    package)."""
    if config.use_flash_attention:
        return flash_attention(q, k, v, causal=True)
    return _xla_attention(q, k, v, causal=True)


def _replaying(fn, generators):
    """``fn``, whose later calls (a checkpoint's recompute) draw the same
    numbers from ``generators`` as its first call did: each recompute
    starts from the generators' states before the first call and puts back
    the states it found. ``torch.utils.checkpoint`` restores only the
    default generators, not explicit ones."""
    if not generators:
        return fn
    before = [g.get_state() for g in generators]
    first = [True]

    def run(*args):
        if first[0]:
            first[0] = False
            return fn(*args)
        now = [g.get_state() for g in generators]
        for g, st in zip(generators, before):
            g.set_state(st)
        try:
            return fn(*args)
        finally:
            for g, st in zip(generators, now):
                g.set_state(st)
    return run
