"""Normalisation layers — port of ``paddle_tpu/nn/layer/norm.py``, on
:class:`Layer`, under the JAX package's parameter and buffer names
(``weight`` / ``bias``; ``scale`` / ``bias`` for the instance norms;
``_mean`` / ``_variance`` for the batch norms). ``weight_attr`` /
``bias_attr`` take None, False (no parameter) or a ``ParamAttr``;
``device`` defaults to the current place."""

from __future__ import annotations

import torch

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer, check_attr


def _affine(layer, shape, weight_attr, bias_attr, dev, what,
            weight_name="weight"):
    """The ones-initialised weight and zero bias of a norm layer (None
    where its attr is False)."""
    weight_attr = check_attr(weight_attr, what)
    bias_attr = check_attr(bias_attr, what)
    setattr(layer, weight_name, None if weight_attr is False
            else layer.create_parameter(shape, attr=weight_attr,
                                        default_initializer=I.Constant(1.0),
                                        device=dev))
    layer.bias = (None if bias_attr is False else layer.create_parameter(
        shape, attr=bias_attr, is_bias=True, device=dev))


class LayerNorm(Layer):
    """Normalises over the trailing ``normalized_shape`` dims (statistics in
    fp32, :func:`..functional.layer_norm`)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _affine(self, self._normalized_shape, weight_attr, bias_attr,
                resolve_device(device), "LayerNorm")

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=check_attr(weight_attr, "RMSNorm"),
            default_initializer=I.Constant(1.0),
            device=resolve_device(device))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
    """Batch norm over the channel axis (1, or the last for channels-last
    layouts): ``weight`` one, ``bias`` zero, and the running statistics as
    persistent fp32 buffers under the JAX package's names, ``_mean``
    (zeros) and ``_variance`` (ones), so a JAX ``state_dict`` loads as it
    is. In training mode each call updates them in place
    (:func:`paddle_tpu_torch.nn.functional.batch_norm`)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self._num_features, self._momentum = num_features, momentum
        self._epsilon, self._data_format = epsilon, data_format
        self._use_global_stats = use_global_stats
        _affine(self, [num_features], weight_attr, bias_attr, dev,
                type(self).__name__)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, self.training, self._momentum,
                            self._epsilon, self._data_format,
                            self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)


class SyncBatchNorm(_BatchNormBase):
    """In one process the batch is all there is: ``BatchNorm``. Across
    processes the statistics would need an all-reduce, which arrives with
    the distributed slice (ROADMAP Queue 1, item 7):
    ``convert_sync_batchnorm`` swaps the layers all the same, keeping
    their parameters and statistics."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      weight_attr=False if layer.weight is None else None,
                      bias_attr=False if layer.bias is None else None,
                      data_format=layer._data_format,
                      use_global_stats=layer._use_global_stats,
                      device=layer._mean.device)
            new.set_state_dict(layer.state_dict())
            new.train(layer.training)
            return new
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        _affine(self, [num_channels], weight_attr, bias_attr,
                resolve_device(device), "GroupNorm")

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    """Instance norm with its affine parameters ``scale`` and ``bias``
    (the JAX package's names); ``momentum`` is not read (no running
    statistics, as there)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=None):
        super().__init__()
        self._epsilon, self._data_format = epsilon, data_format
        _affine(self, [num_features], weight_attr, bias_attr,
                resolve_device(device), type(self).__name__, "scale")

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device=device)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, *, device=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device=device)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)
