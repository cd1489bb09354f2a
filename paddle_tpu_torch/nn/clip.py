"""Gradient clipping — port of ``ClipGradByValue``, ``ClipGradByNorm`` and
``ClipGradByGlobalNorm`` (``paddle_tpu/nn/clip.py`` :14-78).

Each is called with ``[(param, grad), ...]`` and returns the pairs with
the gradients clipped; a ``None`` gradient passes through. The port runs
them on fp32 gradients, as the JAX package's ``hapi`` step does
(``paddle_tpu/hapi/model.py`` :82-95), whose formulas these are.
"""

from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient clamped to [min, max] (``min`` defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def __call__(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by min(clip_norm / max(|g|, 1e-12), 1)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                norm = torch.linalg.vector_norm(g.float())
                g = g * (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(
                    1.0).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by clip_norm / max(global norm, clip_norm),
    the global norm taken over all gradients together."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        norm = torch.stack([g.float().square().sum() for g in grads]).sum()
        scale = self.clip_norm / norm.sqrt().clamp_min(self.clip_norm)
        return [(p, None if g is None else g * scale.to(g.dtype))
                for p, g in params_grads]
