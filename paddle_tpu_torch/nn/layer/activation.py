"""Activation layers — port of ``paddle_tpu/nn/layer/activation.py``: one
class a functional of JAX's ``_make`` table (:10-44), taking that
functional's arguments positionally in the JAX table's order or by name,
and ``PReLU``.

``RReLU`` passes its training mode on (random slopes in training, the mean
slope in eval mode); the JAX package's calls ``rrelu`` in eval form
always (ROADMAP, "Deliberate departures").
"""

from __future__ import annotations

from ...device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer, check_attr

_ARG_NAMES = {
    "leaky_relu": ["negative_slope"],
    "elu": ["alpha"],
    "celu": ["alpha"],
    "gelu": ["approximate"],
    "hardtanh": ["min", "max"],
    "hardshrink": ["threshold"],
    "softshrink": ["threshold"],
    "thresholded_relu": ["threshold", "value"],
    "softplus": ["beta", "threshold"],
    "softmax": ["axis"],
    "log_softmax": ["axis"],
    "maxout": ["groups", "axis"],
    "glu": ["axis"],
    "hardsigmoid": ["slope", "offset"],
    "rrelu": ["lower", "upper"],
}


def _make(name, fn_name):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            names = _ARG_NAMES.get(fn_name, [])
            if len(args) > len(names):
                raise TypeError(f"{name} takes {len(names)} positional "
                                f"arguments ({names}), got {len(args)}")
            self._kwargs = dict(zip(names, args))
            self._kwargs.update((k, v) for k, v in kwargs.items()
                                if k != "name")

        def forward(self, x):
            kw = self._kwargs
            if fn_name == "rrelu":
                kw = {**kw, "training": self.training}
            return getattr(F, fn_name)(x, **kw)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _make("ReLU", "relu")
ReLU6 = _make("ReLU6", "relu6")
LeakyReLU = _make("LeakyReLU", "leaky_relu")
ELU = _make("ELU", "elu")
CELU = _make("CELU", "celu")
SELU = _make("SELU", "selu")
GELU = _make("GELU", "gelu")
Silu = _make("Silu", "silu")
Swish = _make("Swish", "silu")
Mish = _make("Mish", "mish")
Hardswish = _make("Hardswish", "hardswish")
Hardsigmoid = _make("Hardsigmoid", "hardsigmoid")
Hardtanh = _make("Hardtanh", "hardtanh")
Hardshrink = _make("Hardshrink", "hardshrink")
Softshrink = _make("Softshrink", "softshrink")
Tanhshrink = _make("Tanhshrink", "tanhshrink")
ThresholdedReLU = _make("ThresholdedReLU", "thresholded_relu")
Softplus = _make("Softplus", "softplus")
Softsign = _make("Softsign", "softsign")
Sigmoid = _make("Sigmoid", "sigmoid")
LogSigmoid = _make("LogSigmoid", "logsigmoid")
Tanh = _make("Tanh", "tanh")
Softmax = _make("Softmax", "softmax")
LogSoftmax = _make("LogSoftmax", "log_softmax")
Maxout = _make("Maxout", "maxout")
GLU = _make("GLU", "glu")
RReLU = _make("RReLU", "rrelu")


class PReLU(Layer):
    """``weight`` [num_parameters], all ``init`` (0.25)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=check_attr(weight_attr, "PReLU"),
            default_initializer=I.Constant(init),
            device=resolve_device(device))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
