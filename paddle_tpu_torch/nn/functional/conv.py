"""2-D convolution — port of ``conv2d`` (``paddle_tpu/nn/functional/
conv.py`` :27-60, :105), NCHW.

The JAX package computes it with ``lax.conv_general_dilated`` (an XLA op,
no Pallas kernel), so the port calls torch's convolution: cuDNN on the
card. Weights are ``[out, in / groups, kh, kw]`` in both. The call goes
through the op dispatcher under the JAX package's white ``OpDef("conv")``.
"""

from __future__ import annotations

import math

import torch.nn.functional as F

from ..._later import later_slice
from ...core.op_registry import AMP_WHITE, OpDef, apply_fn

_CONV = OpDef("conv", None, amp=AMP_WHITE)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1])) if len(v) == 2 else (int(v[0]),) * 2
    return (int(v), int(v))


def _same_pads(size, k, s, d):
    """XLA's "SAME": ceil(size / s) outputs, the padding split with the
    smaller half before."""
    total = max((math.ceil(size / s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(padding, spatial, kernel, stride, dilation):
    """((top, bottom), (left, right)) from Paddle's padding forms: an int,
    a pair, four per-side values [top, bottom, left, right], per-dimension
    pairs (the last two of a 4-D list), "SAME" or "VALID"."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return (0, 0), (0, 0)
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return tuple(_same_pads(*a) for a in zip(spatial, kernel, stride,
                                                 dilation))
    if isinstance(padding, (list, tuple)) and padding \
            and isinstance(padding[0], (list, tuple)):
        return tuple((int(lo), int(hi)) for lo, hi in padding[-2:])
    if isinstance(padding, (list, tuple)) and len(padding) == 4:
        p = [int(v) for v in padding]
        return (p[0], p[1]), (p[2], p[3])
    ph, pw = _pair(padding)
    return (ph, ph), (pw, pw)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    if data_format != "NCHW":
        raise later_slice(f"conv2d with data_format={data_format!r}",
                          "Paddle API surface", "8")
    stride, dilation = _pair(stride), _pair(dilation)

    def fn(a, w, b):
        (top, bottom), (left, right) = _pads(padding, a.shape[2:],
                                             w.shape[2:], stride, dilation)
        if top == bottom and left == right:
            return F.conv2d(a, w, b, stride, (top, left), dilation, groups)
        return F.conv2d(F.pad(a, (left, right, top, bottom)), w, b, stride,
                        0, dilation, groups)

    return apply_fn("conv2d", fn, x, weight, bias, _opdef=_CONV)
