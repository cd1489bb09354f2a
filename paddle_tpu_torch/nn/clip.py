"""Gradient clipping — port of ``ClipGradByValue``, ``ClipGradByNorm`` and
``ClipGradByGlobalNorm`` (``paddle_tpu/nn/clip.py`` :14-78).

Each is called with ``[(param, grad), ...]`` and returns the pairs with
the gradients clipped; a ``None`` gradient passes through. As in the JAX
package, the norms are taken in fp32 and each gradient is scaled in fp32
and cast back to its own dtype (eager ``Optimizer.step()`` clips the raw
gradients). ``hapi.Model`` and the training ``Engine`` apply their own
clips to a clip object's settings (``paddle_tpu/hapi/model.py`` :80-95,
``distributed/auto_parallel/engine.py`` :333-342).
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
                gf = g.float()
                norm = torch.sqrt(torch.sum(torch.square(gf)))
                g = (gf * (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(
                    1.0)).to(g.dtype)
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
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
        scale = self.clip_norm / norm.clamp_min(self.clip_norm)
        return [(p, None if g is None else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]
