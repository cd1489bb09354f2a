"""``Linear`` and ``Dropout`` — port of ``paddle_tpu/nn/layer/common.py``
(:19-68)."""

from __future__ import annotations

from torch import nn

from ..._later import later_slice
from ...device import resolve_device
from .. import functional as F
from .. import initializer as I


def _no_attr(weight_attr, bias_attr, what):
    """``ParamAttr`` objects (initializers, per-parameter learning rates,
    regularizers) are not ported; ``bias_attr=False`` (no bias) is."""
    if weight_attr is not None or bias_attr not in (None, False):
        raise later_slice(f"{what} with a ParamAttr", "Paddle API surface",
                          "8")


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]`` (Paddle's
    layout, unlike ``torch.nn.Linear``): weight Xavier-normal, bias zero,
    drawn from ``generator`` on ``device`` (default: the CUDA device;
    raises without one unless ``device="cpu"``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        _no_attr(weight_attr, bias_attr, "Linear")
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.weight = I.create_parameter([in_features, out_features],
                                         I.XavierNormal(), dev, generator)
        self.bias = (None if bias_attr is False else I.create_parameter(
            [out_features], I.Constant(0.0), dev))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Dropout(nn.Module):
    """Inverted dropout in training mode, the identity in eval mode; the
    keep masks come from ``generator`` (the owning model's) or torch's
    default generator."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode,
                         generator=self.generator)
