"""``Conv2D`` — port of ``paddle_tpu/nn/layer/conv.py`` (:15-66), on
:class:`Layer`."""

from __future__ import annotations

import math

from ..._later import later_slice
from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer, check_attr


def _ntuple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class Conv2D(Layer):
    """NCHW convolution; ``weight`` ``[out, in / groups, kh, kw]`` drawn
    Kaiming-normal over fan_in = in / groups x kh x kw, ``bias`` uniform in
    +-1 / sqrt(fan_in) (``bias_attr=False``: none), from ``generator`` on
    ``device`` (as :class:`Linear`)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__()
        check_attr(weight_attr, "Conv2D")
        check_attr(bias_attr, "Conv2D")
        if padding_mode != "zeros" or data_format != "NCHW":
            raise later_slice(f"Conv2D with padding_mode={padding_mode!r} "
                              f"or data_format={data_format!r}",
                              "Paddle API surface", "8")
        dev = resolve_device(device)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _ntuple(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        fan_in = in_channels * math.prod(self._kernel_size) // groups
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            default_initializer=I.KaimingNormal(fan_in=fan_in), device=dev,
            generator=generator)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_channels], default_initializer=I.Uniform(-bound, bound),
            device=dev, generator=generator))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups)
