"""Weight-decay regularizers — port of ``paddle_tpu/regularizer.py``.

Both classes carry ``_coeff`` and are accepted by an optimizer's
``weight_decay`` argument. ``__call__(param)`` returns the decay term added
to the gradient: ``coeff * sign(param)`` for L1 (the gradient of
``coeff * sum(|x|)``), ``coeff * param`` for L2 (the gradient of
``0.5 * coeff * sum(x^2)``), in the parameter's dtype, with ``coeff``
typed as JAX types a Python number (:mod:`.framework.promotion`).
"""

from __future__ import annotations

import torch

from .framework.promotion import scale

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __call__(self, param):
        raise NotImplementedError

    def __str__(self):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """loss += coeff * sum(|param|); gradient term coeff * sign(param)."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)
        self._regularization_coeff = self._coeff  # legacy attribute name

    def __call__(self, param):
        return scale(self._coeff, torch.sign(param))

    def __str__(self):
        return f"L1Decay, coeff={self._coeff:f}"


class L2Decay(WeightDecayRegularizer):
    """loss += 0.5 * coeff * sum(param^2); gradient term coeff * param."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)
        self._regularization_coeff = self._coeff

    def __call__(self, param):
        return scale(self._coeff, param)

    def __str__(self):
        return f"L2Decay, coeff={self._coeff:f}"
