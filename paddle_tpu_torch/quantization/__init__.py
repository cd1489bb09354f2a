"""Quantization: QAT, PTQ and the int8 deployment layers — port of
``paddle_tpu/quantization/__init__.py``.

- The observers (:48-104) keep their running absmax on the tensor's device
  (float64 0-dim tensors, where the JAX package reads a Python float to
  the host each call): the same values, no host read.
- :func:`fake_quant` (:111-126) is the straight-through estimator written
  as ``x + (q - x).detach()``: the forward gives q, the gradient is the
  identity.
- :class:`ConvertedLinear` (:154) quantizes its input per tensor and
  multiplies int8 by int8 into int32 with :func:`int8_matmul`
  (``torch._int_mm``: cuBLASLt's integer GEMM on the card, exact integer
  arithmetic on the CPU; JAX's ``lax.dot_general`` with an int32 result,
  no Pallas kernel). It dequantizes in JAX's order:
  ``acc.float() * (a_s * (w_scale / w_qmax))``, then the bias, then a cast
  to the input's dtype. :class:`ConvertedConv2D` (:225) stores int8
  weights and convolves in the input's dtype, as in JAX.
- :class:`QuantConfig`, :class:`QAT` and :class:`PTQ` (:266-369) replace
  the Linear (and Conv2D) sublayers in place.

The int8 paged-KV names (``KV_QMAX``, ``QuantizedKVPool``, ``quantize_kv``,
``dequantize_kv``, ``kv_absmax``) are re-exported from ``ops``.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F

from .. import nn
from ..core.op_registry import apply_fn
from ..core.tensor import unwrap
from ..ops import (KV_QMAX, QuantizedKVPool, dequantize_kv,  # noqa: F401
                   kv_absmax, quantize_kv)

__all__ = [
    "AbsmaxObserver", "MovingAverageAbsmaxObserver",
    "PerChannelAbsmaxObserver", "QuantConfig", "QAT", "PTQ",
    "QuantedLinear", "ConvertedLinear", "QuantedConv2D", "ConvertedConv2D",
    "fake_quant", "int8_matmul",
    "KV_QMAX", "QuantizedKVPool", "quantize_kv", "dequantize_kv",
    "kv_absmax",
]


def _absmax(x):
    return unwrap(x).detach().abs().amax().double()


# ---------------------------------------------------------------------------
# observers
# ---------------------------------------------------------------------------

class AbsmaxObserver:
    """Running max of |x|: a per-tensor scale (1.0 before any sample)."""

    def __init__(self, quant_bits: int = 8):
        self.quant_bits = quant_bits
        self._absmax = None

    def sample(self, x):
        v = _absmax(x)
        self._absmax = v if self._absmax is None else torch.maximum(
            self._absmax, v)

    def scale(self):
        if self._absmax is None:
            return 1.0
        return torch.where(self._absmax > 0, self._absmax, 1.0)

    def qmax(self) -> int:
        return 2 ** (self.quant_bits - 1) - 1


class MovingAverageAbsmaxObserver(AbsmaxObserver):
    """EMA of each batch's absmax, the first batch's as it is."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9):
        super().__init__(quant_bits)
        self.moving_rate = moving_rate

    def sample(self, x):
        v = _absmax(x)
        if self._absmax is None:
            self._absmax = v
        else:
            self._absmax = (self.moving_rate * self._absmax
                            + (1 - self.moving_rate) * v)


class PerChannelAbsmaxObserver:
    """Per-channel absmax along ``channel_axis`` (weights), in the
    sample's dtype; the scale is at least 1e-8."""

    def __init__(self, quant_bits: int = 8, channel_axis: int = -1):
        self.quant_bits = quant_bits
        self.channel_axis = channel_axis
        self._absmax = None

    def sample(self, x):
        a = unwrap(x).detach().abs()
        ax = self.channel_axis % a.ndim
        v = a.amax(dim=[i for i in range(a.ndim) if i != ax])
        self._absmax = v if self._absmax is None else torch.maximum(
            self._absmax, v)

    def scale(self):
        if self._absmax is None:
            return torch.ones((1,), dtype=torch.float32)
        return self._absmax.clamp_min(1e-8)

    def qmax(self) -> int:
        return 2 ** (self.quant_bits - 1) - 1


# ---------------------------------------------------------------------------
# fake quant (straight-through estimator)
# ---------------------------------------------------------------------------

def _fake_quant_kernel(a, scale, qmax):
    s = scale / qmax
    q = torch.clamp(torch.round(a / s), -qmax, qmax) * s
    return a + (q - a).detach()


def _fp32_scale(scale, device):
    return torch.as_tensor(scale, dtype=torch.float32).to(device)


def fake_quant(x, scale, quant_bits: int = 8):
    """Simulated quantization: forward ``clip(round(x / s), -qmax, qmax) s``
    with s = scale / qmax (scale cast to fp32; the result promotes to fp32
    as in JAX), gradient the identity."""
    qmax = 2 ** (quant_bits - 1) - 1
    return apply_fn("fake_quantize", _fake_quant_kernel, x,
                    scale=_fp32_scale(scale, x.device), qmax=qmax)


# ---------------------------------------------------------------------------
# the int8 product
# ---------------------------------------------------------------------------

def _round_up(n, m):
    return -(-n // m) * m


def int8_matmul(a, b):
    """a [M, K] int8 @ b [K, N] int8 -> int32 [M, N], exact.

    ``torch._int_mm`` on both devices. On the card it wants M > 16 and K,
    N multiples of 8: smaller or ragged operands are padded with zero rows
    and columns (exact for integers) and the result sliced; a float
    product is never used. B goes to cuBLASLt column-major (a stride-1
    first axis; ``ConvertedLinear`` keeps its weight so): a row-major B
    is refused at some widths (N = 40) and runs 4-7x slower where taken
    (NVIDIA H100 80GB HBM3, 700 W). Counts ``quantized_linear.launches``
    on CUDA tensors."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a.contiguous(), b.contiguous())
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    if b.stride(0) != 1:
        b = b.t().contiguous().t()
    out = torch._int_mm(a.contiguous(), b)
    quantized_linear.launches += 1
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _quantize_act(a, a_s, a_qmax):
    return torch.clamp(torch.round(a.float() / a_s), -a_qmax,
                       a_qmax).to(torch.int8)


def quantized_linear(x, qweight, bias, a_scale, w_scale, a_qmax, w_qmax):
    """The converted linear's forward (the JAX op ``quantized_linear``):
    x quantized per tensor by ``a_scale / a_qmax``, the int8 product with
    ``qweight`` [in, out] into int32, dequantized by ``a_s * (w_scale /
    w_qmax)``, plus ``bias``, in x's dtype."""
    def fn(a, qw, *b):
        a_s = (a_scale / a_qmax).to(torch.float32)
        aq = _quantize_act(a, a_s, a_qmax)
        acc = int8_matmul(aq.reshape(-1, aq.shape[-1]), qw).reshape(
            aq.shape[:-1] + (qw.shape[-1],))
        out = acc.float() * (a_s * (w_scale / w_qmax))
        if b:
            out = out + b[0]
        return out.to(a.dtype)

    args = [x, qweight] + ([bias] if bias is not None else [])
    return apply_fn("quantized_linear", fn, *args)


#: int8 products launched on the card (``torch._int_mm``); callers reset it
quantized_linear.launches = 0


# ---------------------------------------------------------------------------
# quanted (QAT) and converted (deployment) layers
# ---------------------------------------------------------------------------

class QuantedLinear(nn.Layer):
    """Linear with a fake-quantized weight (per output channel) and input
    (per tensor, observed in training and while calibrating)."""

    def __init__(self, linear, activation_observer=None, weight_bits: int = 8,
                 act_bits: int = 8):
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        self._w_obs = PerChannelAbsmaxObserver(weight_bits, channel_axis=-1)
        self._a_obs = activation_observer or MovingAverageAbsmaxObserver(
            act_bits)
        self._act_bits = act_bits
        self._weight_bits = weight_bits
        self._calibrating = False   # PTQ samples while the model is in eval

    def forward(self, x):
        if self.training or self._calibrating:
            self._a_obs.sample(x)
        xq = fake_quant(x, self._a_obs.scale(), self._act_bits)
        self._w_obs.sample(self.weight)
        wq = fake_quant(self.weight, self._w_obs.scale(), self._weight_bits)
        return nn.functional.linear(xq, wq, self.bias)


class ConvertedLinear(nn.Layer):
    """Deployment linear: int8 weights ``qweight`` [in, out] (column-major
    in memory) and the int8 product (:func:`quantized_linear`)."""

    def __init__(self, linear, w_scale, a_scale, act_bits: int = 8,
                 weight_bits: int = 8):
        super().__init__()
        w = unwrap(linear.weight).detach().float()
        self._w_qmax = 2 ** (weight_bits - 1) - 1
        self._a_qmax = 2 ** (act_bits - 1) - 1
        self._w_scale = _fp32_scale(w_scale, w.device)   # [out_features]
        self._a_scale = torch.as_tensor(a_scale, dtype=torch.float64).to(
            w.device)
        wq = torch.clamp(torch.round(w / (self._w_scale / self._w_qmax)),
                         -self._w_qmax, self._w_qmax).to(torch.int8)
        # [in, out] stored column-major: the layout int8_matmul hands on
        self.register_buffer("qweight", wq.t().contiguous().t())
        self.bias = linear.bias

    def forward(self, x):
        return quantized_linear(x, self.qweight, self.bias, self._a_scale,
                                self._w_scale, self._a_qmax, self._w_qmax)


class QuantedConv2D(nn.Layer):
    """Conv2D with fake-quantized weights (per output channel, axis 0 of
    OIHW) and input (per tensor), both observed in training and while
    calibrating."""

    def __init__(self, conv, activation_observer=None, weight_bits: int = 8,
                 act_bits: int = 8):
        super().__init__()
        self._conv = conv
        self.weight = conv.weight
        self.bias = conv.bias
        self._w_obs = PerChannelAbsmaxObserver(weight_bits, channel_axis=0)
        self._a_obs = activation_observer or MovingAverageAbsmaxObserver(
            act_bits)
        self._w_bits, self._a_bits = weight_bits, act_bits
        self._calibrating = False

    def forward(self, x):
        if self._calibrating or self.training:
            self._a_obs.sample(x)
            self._w_obs.sample(self.weight)
        xq = fake_quant(x, self._a_obs.scale(), self._a_bits)
        w_scale = _fp32_scale(self._w_obs.scale(), x.device).reshape(
            (-1,) + (1,) * (self.weight.ndim - 1))
        wq = fake_quant(self.weight, w_scale, self._w_bits)
        c = self._conv
        return nn.functional.conv2d(xq, wq, self.bias, c._stride, c._padding,
                                    c._dilation, c._groups, c._data_format)


class ConvertedConv2D(nn.Layer):
    """Deployment conv: int8 per-channel weights, dequantized in the
    input's dtype at the convolution (no int8 convolution, as in JAX).
    Keeps only the conv's configuration, not the fp32 layer."""

    def __init__(self, conv, w_scale, a_scale, act_bits: int = 8,
                 weight_bits: int = 8):
        super().__init__()
        inner = getattr(conv, "_conv", conv)
        self._cfg = (inner._stride, inner._padding, inner._dilation,
                     inner._groups, inner._data_format)
        w = unwrap(conv.weight).detach().float()
        qmax = 2 ** (weight_bits - 1) - 1
        scale = _fp32_scale(w_scale, w.device).clamp_min(1e-8)
        step = (scale / qmax).reshape((-1,) + (1,) * (w.ndim - 1))
        self.register_buffer("qweight", torch.clamp(
            torch.round(w / step), -qmax, qmax).to(torch.int8))
        self._w_step = step
        self.bias = inner.bias

    def forward(self, x):
        stride, padding, dilation, groups, data_format = self._cfg

        def fn(a, qw, *b):
            w = qw.to(a.dtype) * self._w_step.to(a.dtype)
            return nn.functional.conv2d(a, w, b[0] if b else None, stride,
                                        padding, dilation, groups,
                                        data_format)

        args = [x, self.qweight] + ([self.bias] if self.bias is not None
                                    else [])
        return apply_fn("quantized_conv2d", fn, *args)


# ---------------------------------------------------------------------------
# QuantConfig / QAT / PTQ
# ---------------------------------------------------------------------------

class QuantConfig:
    """Which layer types to quantize (Linear by default) and the activation
    observer's factory. A ``weight`` quanter (which the JAX package takes
    and ignores) raises."""

    def __init__(self, activation=None, weight=None, quant_bits: int = 8):
        if weight is not None:
            raise NotImplementedError(
                "QuantConfig(weight=...): the JAX package takes it and "
                "ignores it (weights use the per-channel absmax observer)")
        self.activation_factory = activation or (
            lambda: MovingAverageAbsmaxObserver(quant_bits))
        self.weight_bits = quant_bits
        self.act_bits = quant_bits
        self._types = (nn.Linear,)

    def add_type_config(self, layer_types, activation=None, weight=None):
        if activation is not None or weight is not None:
            raise NotImplementedError(
                "QuantConfig.add_type_config(activation=, weight=): the JAX "
                "package takes them and ignores them")
        if not isinstance(layer_types, (list, tuple)):
            layer_types = [layer_types]
        self._types = tuple(set(self._types) | set(layer_types))


def _replace_layers(model, predicate, build):
    for name, child in list(model.named_children()):
        if predicate(child):
            setattr(model, name, build(child))
        else:
            _replace_layers(child, predicate, build)
    return model


class QAT:
    """Quantization-aware training: :meth:`quantize` puts QuantedLinear /
    QuantedConv2D in place of the configured layers, :meth:`convert` the
    Converted ones in place of those."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace: bool = True):
        cfg = self.config
        # refuse before changing anything
        unsupported = sorted({
            type(l).__name__ for _, l in model.named_sublayers()
            if isinstance(l, cfg._types)
            and not isinstance(l, (nn.Linear, nn.Conv2D))})
        if unsupported:
            raise NotImplementedError(
                f"quantization of {', '.join(unsupported)} is not supported "
                f"(Linear and Conv2D)")
        if not inplace:
            model = copy.deepcopy(model)

        def build(l):
            if isinstance(l, nn.Conv2D):
                return QuantedConv2D(l, cfg.activation_factory(),
                                     cfg.weight_bits, cfg.act_bits)
            return QuantedLinear(l, cfg.activation_factory(),
                                 cfg.weight_bits, cfg.act_bits)

        return _replace_layers(model, lambda l: isinstance(l, cfg._types),
                               build)

    def convert(self, model, inplace: bool = True):
        cfg = self.config
        if not inplace:
            model = copy.deepcopy(model)

        def build(l):
            cls = (ConvertedConv2D if isinstance(l, QuantedConv2D)
                   else ConvertedLinear)
            return cls(l, l._w_obs.scale(), l._a_obs.scale(), cfg.act_bits,
                       cfg.weight_bits)

        return _replace_layers(
            model, lambda l: isinstance(l, (QuantedLinear, QuantedConv2D)),
            build)


class PTQ:
    """Post-training quantization: :meth:`quantize` inserts the observers
    (absmax by default) and puts the model in eval with them sampling;
    run calibration batches; :meth:`convert`."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig(
            activation=lambda: AbsmaxObserver(8))
        self._qat = QAT(self.config)

    def quantize(self, model, inplace: bool = True):
        q = self._qat.quantize(model, inplace)
        q.eval()
        for _, layer in q.named_sublayers(include_self=True):
            if isinstance(layer, (QuantedLinear, QuantedConv2D)):
                layer._calibrating = True
        return q

    def convert(self, model, inplace: bool = True):
        model.eval()
        for _, layer in model.named_sublayers(include_self=True):
            if isinstance(layer, (QuantedLinear, QuantedConv2D)):
                layer._calibrating = False
        return self._qat.convert(model, inplace)
