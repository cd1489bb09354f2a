"""``LayerNorm`` and ``BatchNorm2D`` — port of ``paddle_tpu/nn/layer/
norm.py`` (:13-93), on :class:`Layer`."""

from __future__ import annotations

import torch

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer, check_attr


class LayerNorm(Layer):
    """Normalises over the trailing ``normalized_shape`` dims (statistics in
    fp32, :func:`..functional.layer_norm`): ``weight`` ones, ``bias`` zeros
    (``weight_attr`` / ``bias_attr`` False: none)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        dev = resolve_device(device)
        self.weight = None if weight_attr is False else self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0), device=dev)
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True, device=dev)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class BatchNorm2D(Layer):
    """Batch norm over axis 1: ``weight`` one, ``bias`` zero, and the
    running statistics as persistent fp32 buffers under the JAX package's
    names, ``_mean`` (zeros) and ``_variance`` (ones), so a JAX
    ``state_dict`` loads as it is. In training mode each call updates them
    in place (:func:`paddle_tpu_torch.nn.functional.batch_norm`)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        check_attr(weight_attr, "BatchNorm2D")
        check_attr(bias_attr, "BatchNorm2D")
        dev = resolve_device(device)
        self._num_features, self._momentum = num_features, momentum
        self._epsilon, self._data_format = epsilon, data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], default_initializer=I.Constant(1.0), device=dev)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_features], is_bias=True, device=dev))
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, self.training, self._momentum,
                            self._epsilon, self._data_format,
                            self._use_global_stats)
