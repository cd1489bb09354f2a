"""Pooling layers — port of ``paddle_tpu/nn/layer/pooling.py``: each
holds its functional's arguments (:mod:`..functional.pooling`) and calls
it."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size=None, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              **self.kwargs)


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)


class MaxPool3D(_Pool):
    _fn = staticmethod(F.max_pool3d)


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)


class AvgPool3D(_Pool):
    _fn = staticmethod(F.avg_pool3d)


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, self.output_size, **self.kwargs)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool2d)


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool3d)


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool3d)
