"""Pooling — port of ``paddle_tpu/nn/functional/pooling.py`` (1-D, 2-D and
3-D max, average and adaptive pools, ``lp_pool1d`` / ``lp_pool2d``),
neutral ops of the dispatcher.

The JAX package pools with ``lax.reduce_window`` (an XLA op, no Pallas
kernel); the port calls torch's pooling (cuDNN on the card). Max pooling
pads with -inf; an average pool's ``exclusive`` (the default) leaves the
padding out of each window's count. The adaptive pools take windows
``[floor(i * in / out), ceil((i + 1) * in / out))`` along each axis, as
JAX's does axis by axis (so they also upsample). Channels-last layouts
(``NLC``, ``NHWC``, ``NDHWC``) move the channels to axis 1 and back.

Where the JAX package ignores an argument the port gives it Paddle's
meaning, which torch's pools have: ``ceil_mode`` keeps a last window that
runs past the input's end; ``divisor_override`` divides every window's sum
by it; ``return_mask`` (also with ``ceil_mode``, a channels-last layout
or an adaptive max pool, which JAX refuses or drops) returns ``(out,
mask)``, the mask the int32 flat index of each maximum within its
(sample, channel) spatial map. ``lp_pool*`` is JAX's ``sum(|x|^p)^(1/p)``
over each window (zero padding counted); its ``ceil_mode`` is Paddle's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.op_registry import apply_fn

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_ADAPTIVE_AVG = {1: F.adaptive_avg_pool1d, 2: F.adaptive_avg_pool2d,
                 3: F.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: F.adaptive_max_pool1d, 2: F.adaptive_max_pool2d,
                 3: F.adaptive_max_pool3d}


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v[:n]) if len(v) >= n \
            else (int(v[0]),) * n
    return (int(v),) * n


def _nc(fn, data_format):
    """``fn`` of a channels-first tensor applied in ``data_format``
    (outputs moved back; an int mask too)."""
    if data_format.startswith("NC"):
        return fn

    def moved(a):
        out = fn(a.movedim(-1, 1))
        if isinstance(out, tuple):
            return tuple(o.movedim(1, -1) for o in out)
        return out.movedim(1, -1)

    return moved


def _mask(out):
    return (out[0], out[1].to(torch.int32)) if isinstance(out, tuple) \
        else out


def _max_pool(x, kernel_size, stride, padding, n, return_mask, ceil_mode,
              data_format):
    kernel = _tuplize(kernel_size, n)
    stride = _tuplize(stride if stride is not None else kernel, n)
    pad = _tuplize(padding, n)
    return apply_fn("pool", _nc(lambda a: _mask(_MAX[n](
        a, kernel, stride, pad, ceil_mode=ceil_mode,
        return_indices=return_mask)), data_format), x)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, 1, return_mask,
                     ceil_mode, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 2, return_mask,
                     ceil_mode, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, 3, return_mask,
                     ceil_mode, data_format)


def _avg_pool(x, kernel_size, stride, padding, n, exclusive, ceil_mode,
              divisor_override, data_format):
    kernel = _tuplize(kernel_size, n)
    stride = _tuplize(stride if stride is not None else kernel, n)
    pad = _tuplize(padding, n)
    kw = {} if divisor_override is None \
        else {"divisor_override": int(divisor_override)}
    return apply_fn("pool", _nc(lambda a: _AVG[n](
        a, kernel, stride, pad, ceil_mode=ceil_mode,
        count_include_pad=not exclusive, **kw), data_format), x)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1, exclusive,
                     ceil_mode, None, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 2, exclusive,
                     ceil_mode, divisor_override, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, 3, exclusive,
                     ceil_mode, divisor_override, data_format)


def _adaptive(x, output_size, n, kind, data_format="NC", return_mask=False):
    size = _tuplize(output_size, n)
    if kind == "avg":
        fn = lambda a: _ADAPTIVE_AVG[n](a, size)  # noqa: E731
    else:
        fn = lambda a: _mask(_ADAPTIVE_MAX[n](  # noqa: E731
            a, size, return_indices=return_mask))
    return apply_fn("adaptive_pool", _nc(fn, data_format), x)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", return_mask=return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", return_mask=return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max", return_mask=return_mask)


def _lp_pool(x, norm_type, kernel_size, stride, padding, n, ceil_mode,
             data_format, name):
    p = float(norm_type)
    kernel = _tuplize(kernel_size, n)
    stride = _tuplize(stride if stride is not None else kernel, n)
    pad = _tuplize(padding, n)

    def fn(a):
        powed = torch.abs(a) ** p
        if n == 1:   # avg_pool1d has no divisor_override
            summed = F.avg_pool2d(powed[..., None], (kernel[0], 1),
                                  (stride[0], 1), (pad[0], 0), ceil_mode,
                                  True, 1)[..., 0]
        else:
            summed = F.avg_pool2d(powed, kernel, stride, pad, ceil_mode,
                                  True, 1)
        return summed ** (1.0 / p)

    return apply_fn(name, _nc(fn, data_format), x)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 1, ceil_mode,
                    data_format, "lp_pool1d")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 2, ceil_mode,
                    data_format, "lp_pool2d")
