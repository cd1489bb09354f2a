"""Convolution layers — port of ``paddle_tpu/nn/layer/conv.py``, on
:class:`Layer`: ``Conv1D`` / ``2D`` / ``3D`` and their transposes.

``weight`` is ``[out, in / groups, *k]`` (a transpose's ``[in, out /
groups, *k]``), drawn Kaiming-normal over fan_in = in / groups x prod(k);
``bias`` uniform in +-1 / sqrt(fan_in) (zeros under a ``ParamAttr``
without an initializer; ``bias_attr=False``: none), from ``generator`` on
``device`` (as :class:`Linear`). ``padding_mode`` other than "zeros"
("reflect", "replicate", "circular": Paddle's meaning, which the JAX
package ignores) pads the input so, then convolves unpadded.
"""

from __future__ import annotations

import math

import torch.nn.functional as TF

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from ..functional.conv import _flat, _pads, _tuplize
from .layers import Layer, check_attr

_PADDING_MODES = ("zeros", "reflect", "replicate", "circular")


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0, device=None,
                 generator=None):
        super().__init__()
        if padding_mode not in _PADDING_MODES:
            raise ValueError(f"unknown padding_mode {padding_mode!r}")
        bias_attr = check_attr(bias_attr, type(self).__name__)
        dev = resolve_device(device)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _ntuple(kernel_size, n)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._padding_mode, self._data_format = padding_mode, data_format
        self._n, self._output_padding = n, output_padding
        w_shape = ([in_channels, out_channels // groups] if transpose
                   else [out_channels, in_channels // groups])
        fan_in = in_channels * math.prod(self._kernel_size) // groups
        self.weight = self.create_parameter(
            w_shape + list(self._kernel_size),
            attr=check_attr(weight_attr, type(self).__name__),
            default_initializer=I.KaimingNormal(fan_in=fan_in), device=dev,
            generator=generator)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=(I.Uniform(-bound, bound) if bias_attr is None
                                 else None), device=dev, generator=generator)

    def _conv(self, fn, x):
        """``fn(x, padding)`` with ``padding_mode`` applied."""
        if self._padding_mode == "zeros":
            return fn(x, self._padding)
        n = self._n
        cl = not self._data_format.startswith("NC")
        spatial = x.shape[1:-1] if cl else x.shape[2:]
        pads = _pads(self._padding, spatial, self._kernel_size,
                     _tuplize(self._stride, n), _tuplize(self._dilation, n))
        xn = x.movedim(-1, 1) if cl else x
        xn = TF.pad(xn, _flat(pads), mode=self._padding_mode)
        return fn(xn.movedim(1, -1) if cl else xn, 0)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return self._conv(lambda a, p: F.conv1d(
            a, self.weight, self.bias, self._stride, p, self._dilation,
            self._groups, self._data_format), x)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return self._conv(lambda a, p: F.conv2d(
            a, self.weight, self.bias, self._stride, p, self._dilation,
            self._groups, self._data_format), x)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return self._conv(lambda a, p: F.conv3d(
            a, self.weight, self.bias, self._stride, p, self._dilation,
            self._groups, self._data_format), x)


class _ConvTransposeNd(_ConvNd):
    _fn = None

    def forward(self, x, output_size=None):
        return type(self)._fn(x, self.weight, self.bias, self._stride,
                              self._padding, self._output_padding,
                              self._groups, self._dilation, output_size,
                              self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device=device, generator=generator)


class Conv2DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device=device, generator=generator)


class Conv3DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device=device, generator=generator)
