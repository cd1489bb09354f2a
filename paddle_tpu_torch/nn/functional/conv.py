"""Convolutions — port of ``paddle_tpu/nn/functional/conv.py``: ``conv1d``,
``conv2d``, ``conv3d`` and the three ``conv*d_transpose``.

The JAX package computes them with ``lax.conv_general_dilated`` (an XLA
op, no Pallas kernel), so the port calls torch's convolutions: cuDNN on
the card. Weights are ``[out, in / groups, *k]`` (a transpose's ``[in, out
/ groups, *k]``) in both. Every call goes through the op dispatcher under
the JAX package's white ``OpDef("conv")`` (``_conv_nd`` :39), as
``conv{n}d`` or ``conv{n}d_transpose``. Channels-last layouts (``NLC``,
``NHWC``, ``NDHWC``) move the channels to axis 1 and back.

Padding takes Paddle's forms: an int, one value a spatial dim, two a dim
(``[before_0, after_0, before_1, ...]``), per-dimension pairs (the last n
of a list of pairs), "SAME" (XLA's: ceil(size / stride) outputs, the
smaller half before) or "VALID". A transpose's padding crops its output.
There "SAME" (which the JAX package reads as "VALID") is Paddle's: the
padding of a "SAME" conv of the input, ``max((ceil(in / s) - 1) s + k -
in, 0)`` split with the smaller half before and the dilation taken as 1,
so the output is ``in x stride`` when the stride divides the input and
the kernel is no smaller than the stride. ``output_size`` (which the JAX
package ignores) is Paddle's: it picks the ``output_padding`` that
reaches that size.
"""

from __future__ import annotations

import math

import torch.nn.functional as F

from ...core.op_registry import AMP_WHITE, OpDef, apply_fn

_CONV = OpDef("conv", None, amp=AMP_WHITE)
_FWD = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_TRANSPOSE = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
              3: F.conv_transpose3d}
_CHANNELS_FIRST = ("NCL", "NCW", "NCHW", "NCDHW")


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v) if len(v) == n \
            else (int(v[0]),) * n
    return (int(v),) * n


def _same_pads(size, k, s, d):
    """XLA's "SAME": ceil(size / s) outputs, the padding split with the
    smaller half before."""
    total = max((math.ceil(size / s) - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(padding, spatial, kernel, stride, dilation):
    """((before, after), ...) a spatial dim from Paddle's padding forms."""
    n = len(spatial)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return ((0, 0),) * n
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return tuple(_same_pads(*a) for a in zip(spatial, kernel, stride,
                                                 dilation))
    if isinstance(padding, (list, tuple)) and padding \
            and isinstance(padding[0], (list, tuple)):
        return tuple((int(lo), int(hi)) for lo, hi in padding[-n:])
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        p = [int(v) for v in padding]
        return tuple((p[2 * i], p[2 * i + 1]) for i in range(n))
    return tuple((p, p) for p in _tuplize(padding, n))


def _flat(pads):
    """torch's ``F.pad`` list (last dim first) of ((before, after), ...)."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _nc(fn, data_format):
    if data_format in _CHANNELS_FIRST:
        return fn
    return lambda a, *rest: fn(a.movedim(-1, 1), *rest).movedim(1, -1)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format):
    stride, dilation = _tuplize(stride, n), _tuplize(dilation, n)

    def fn(a, w, *b):
        pads = _pads(padding, a.shape[2:], w.shape[2:], stride, dilation)
        bb = b[0] if b else None
        if all(lo == hi for lo, hi in pads):
            return _FWD[n](a, w, bb, stride, [lo for lo, _ in pads],
                           dilation, groups)
        return _FWD[n](F.pad(a, _flat(pads)), w, bb, stride, 0, dilation,
                       groups)

    extra = [bias] if bias is not None else []
    return apply_fn(f"conv{n}d", _nc(fn, data_format), x, weight, *extra,
                    _opdef=_CONV)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       groups, dilation, output_size, n, data_format):
    stride, dilation = _tuplize(stride, n), _tuplize(dilation, n)
    if isinstance(padding, str) and padding.upper() == "SAME":
        # the SAME padding of a conv of the input at dilation 1 (Paddle's
        # UpdatePaddingAndDilation)
        dilation = (1,) * n
    opad = _tuplize(output_padding, n)

    def fn(a, w, *b):
        k = w.shape[2:]
        pads = _pads(padding, a.shape[2:], k, stride, dilation)
        # the output a dim has (in - 1) s + d (k - 1) + 1 - lo - hi + op
        full = [(i - 1) * s + d * (kk - 1) + 1 for i, s, d, kk in
                zip(a.shape[2:], stride, dilation, k)]
        op = opad
        if output_size is not None:
            want = _tuplize(output_size, n) if isinstance(
                output_size, (list, tuple)) and len(output_size) == n \
                else tuple(int(v) for v in list(output_size)[-n:])
            if any(opad):
                raise ValueError("conv_transpose: output_size and "
                                 "output_padding both given")
            op = tuple(o - (f - lo - hi) for o, f, (lo, hi) in
                       zip(want, full, pads))
            if any(not 0 <= v < max(s, d) for v, s, d in
                   zip(op, stride, dilation)):
                raise ValueError(f"conv_transpose: output_size {want} is "
                                 f"not reachable from the input")
        bb = b[0] if b else None
        if all(lo == hi for lo, hi in pads):
            return _TRANSPOSE[n](a, w, bb, stride, [lo for lo, _ in pads],
                                 op, groups, dilation)
        # asymmetric padding: the full output, cropped (and extended by
        # the output padding) a side at a time, then the bias
        out = _TRANSPOSE[n](a, w, None, stride, 0, 0, groups, dilation)
        out = F.pad(out, _flat([(-lo, o - hi) for (lo, hi), o in
                                zip(pads, op)]))
        if bb is not None:
            out = out + bb.reshape([1, -1] + [1] * n)
        return out

    extra = [bias] if bias is not None else []
    return apply_fn(f"conv{n}d_transpose", _nc(fn, data_format), x, weight,
                    *extra, _opdef=_CONV)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, output_size,
                              1, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, output_size,
                              2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, groups, dilation, output_size,
                              3, data_format)
