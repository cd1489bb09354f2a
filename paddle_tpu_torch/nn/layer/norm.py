"""``BatchNorm2D`` — port of ``paddle_tpu/nn/layer/norm.py`` (:50-93)."""

from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from .common import _no_attr


class BatchNorm2D(nn.Module):
    """Batch norm over axis 1: ``weight`` one, ``bias`` zero, and the
    running statistics as persistent fp32 buffers under the JAX package's
    names, ``_mean`` (zeros) and ``_variance`` (ones), so a JAX
    ``state_dict`` loads as it is. In training mode each call updates them
    in place (:func:`paddle_tpu_torch.nn.functional.batch_norm`)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        _no_attr(weight_attr, bias_attr, "BatchNorm2D")
        dev = resolve_device(device)
        self._num_features, self._momentum = num_features, momentum
        self._epsilon, self._data_format = epsilon, data_format
        self._use_global_stats = use_global_stats
        self.weight = I.create_parameter([num_features], I.Constant(1.0),
                                         dev)
        self.bias = (None if bias_attr is False else I.create_parameter(
            [num_features], I.Constant(0.0), dev))
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, self.training, self._momentum,
                            self._epsilon, self._data_format,
                            self._use_global_stats)
