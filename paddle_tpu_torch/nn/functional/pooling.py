"""2-D pooling — port of ``max_pool2d``, ``avg_pool2d`` and
``adaptive_avg_pool2d`` (``paddle_tpu/nn/functional/pooling.py`` :17-129),
NCHW, neutral ops of the dispatcher.

The JAX package pools with ``lax.reduce_window`` (an XLA op, no Pallas
kernel); the port calls torch's pooling. Max pooling pads with -inf;
``avg_pool2d``'s ``exclusive`` (the default) leaves the padding out of
each window's count. ``adaptive_avg_pool2d`` averages windows
``[floor(i * in / out), ceil((i + 1) * in / out))`` along each axis, as
JAX's does axis by axis, so it also upsamples (1 x 1 -> 7 x 7 repeats).

``ceil_mode=True`` keeps a last window that runs past the input's end
(Paddle's and torch's rule). The JAX package's ``_pool`` ignores
``ceil_mode`` (:17-41): the port departs from it there, and only there.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..._later import later_slice
from ...core.op_registry import apply_fn


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v[:2]) if len(v) >= 2 \
            else (int(v[0]),) * 2
    return (int(v), int(v))


def _check(data_format, what):
    if data_format != "NCHW":
        raise later_slice(f"{what} with data_format={data_format!r}",
                          "Paddle API surface", "8")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    _check(data_format, "max_pool2d")
    if return_mask:
        raise later_slice("max_pool2d(return_mask=True)",
                          "Paddle API surface", "8")
    kernel = _pair(kernel_size)
    return apply_fn("max_pool2d", lambda a: F.max_pool2d(
        a, kernel, _pair(stride or kernel), _pair(padding),
        ceil_mode=ceil_mode), x)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    _check(data_format, "avg_pool2d")
    if divisor_override is not None:
        raise later_slice("avg_pool2d(divisor_override=...)",
                          "Paddle API surface", "8")
    kernel = _pair(kernel_size)
    return apply_fn("avg_pool2d", lambda a: F.avg_pool2d(
        a, kernel, _pair(stride or kernel), _pair(padding),
        ceil_mode=ceil_mode, count_include_pad=not exclusive), x)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    _check(data_format, "adaptive_avg_pool2d")
    return apply_fn("adaptive_avg_pool2d", lambda a: F.adaptive_avg_pool2d(
        a, _pair(output_size)), x)
