"""Normalisation functionals — port of ``paddle_tpu/nn/functional/
norm.py``, neutral ops of the dispatcher.

``layer_norm`` and ``rms_norm`` compute as the JAX package does: their
statistics in fp32 (the population variance; the mean square), the
normalised values cast back to the input's dtype, then times ``weight``
(and plus ``bias``) in the types the operands promote to (a bf16 input
with fp32 weights gives fp32, as in JAX).

``batch_norm`` calls torch's batch norm (cuDNN on the card). In training
it normalises by the batch's statistics (population variance) and updates
the running ones in place: ``momentum * running + (1 - momentum) *
batch``, with the unbiased variance ``var * n / (n - 1)``. Paddle's
``momentum`` (0.9) is the weight of the old value; torch's is that of the
new one, so torch gets ``1 - momentum``. Outside training, or with
``use_global_stats``, it normalises by the running statistics and updates
nothing.

``group_norm`` and ``instance_norm`` call torch's (cuDNN on the card).
The JAX package reduces in the input's dtype; torch's kernels accumulate
a bf16 input in fp32, so in bf16 the port is the more exact of the two
(their difference is bf16 rounding of the JAX side's statistics). The
affine weights multiply after the cast, in the promoted type, as in JAX.
``instance_norm`` normalises by each sample's own statistics, which is
all the JAX package does; given running statistics it is torch's
``instance_norm`` with them (``use_input_stats=False`` normalises by
them).

``local_response_norm`` is the JAX package's ``x / (k + alpha *
sum(x^2 over size channels))^beta`` (Paddle and torch divide the sum by
``size``). Channels-last layouts (``NHWC``, ``NLC``, ``NDHWC``) move the
channels to axis 1 and back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.op_registry import apply_fn


def _channels_last(data_format):
    return not data_format.startswith("NC")


def _to_nc(a, data_format):
    return a.movedim(-1, 1) if _channels_last(data_format) else a


def _from_nc(a, data_format):
    return a.movedim(1, -1) if _channels_last(data_format) else a


def _affine(out, w, b):
    """``out * w + b`` along axis 1 (either may be None), promoted as the
    JAX package's broadcasts promote."""
    shape = [1, -1] + [1] * (out.ndim - 2)
    if w is not None:
        out = out * w.reshape(shape)
    if b is not None:
        out = out + b.reshape(shape)
    return out


def _split_wb(wb, weight, bias):
    wb = list(wb)
    return (wb.pop(0) if weight is not None else None,
            wb.pop(0) if bias is not None else None)


def _opt(*tensors):
    return [t for t in tensors if t is not None]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    nd = len(tuple(normalized_shape))

    def fn(a, *wb):
        w, b = _split_wb(wb, weight, bias)
        dims = tuple(range(a.ndim - nd, a.ndim))
        af = a.float()
        var, mean = torch.var_mean(af, dims, correction=0, keepdim=True)
        out = ((af - mean) / torch.sqrt(var + epsilon)).to(a.dtype)
        if w is not None:
            out = out * w
        if b is not None:
            out = out + b
        return out

    return apply_fn("layer_norm", fn, x, *_opt(weight, bias))


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """``x / sqrt(mean(x^2) + eps)`` over the last axis in fp32, cast back
    to x's dtype, then times ``weight`` (:39-52)."""
    def fn(a, *w):
        af = a.float()
        ms = torch.mean(torch.square(af), -1, keepdim=True)
        out = (af * torch.rsqrt(ms + epsilon)).to(a.dtype)
        return out * w[0] if w else out

    return apply_fn("rms_norm", fn, x, *_opt(weight))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    use_batch_stats = bool(training and not use_global_stats)
    return apply_fn("batch_norm", lambda a, rm, rv, w, b: _from_nc(
        F.batch_norm(_to_nc(a, data_format), rm, rv, w, b, use_batch_stats,
                     1.0 - momentum, epsilon), data_format),
        x, running_mean, running_var, weight, bias)


def _fused_affine(a, w, b):
    """Whether torch's norm can take ``w`` and ``b`` itself: both given or
    absent together, in a's dtype (otherwise :func:`_affine` promotes)."""
    return all(t is not None and t.dtype == a.dtype for t in (w, b))


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalised over its spatial dims
    (:105-121). The running statistics (which the JAX package ignores) are
    torch's ``instance_norm``'s: with ``use_input_stats=False`` the input
    is normalised with ``running_mean`` / ``running_var``; with input
    statistics the given running buffers are updated in place, Paddle's
    ``momentum`` (0.9 keeps 90% of the old value)."""
    if (running_mean is None) != (running_var is None):
        raise ValueError("instance_norm takes running_mean and running_var "
                         "together")
    if running_mean is not None:
        def stats_fn(a, rm, rv, *wb):
            w, b = _split_wb(wb, weight, bias)
            out = F.instance_norm(_to_nc(a, data_format), rm, rv,
                                  use_input_stats=use_input_stats,
                                  momentum=1.0 - momentum, eps=eps)
            return _from_nc(_affine(out, w, b), data_format)

        return apply_fn("instance_norm", stats_fn, x, running_mean,
                        running_var, *_opt(weight, bias))
    if not use_input_stats:
        raise ValueError("instance_norm(use_input_stats=False) needs "
                         "running_mean and running_var")

    def fn(a, *wb):
        w, b = _split_wb(wb, weight, bias)
        an = _to_nc(a, data_format)
        if _fused_affine(an, w, b):
            return _from_nc(F.instance_norm(an, weight=w, bias=b, eps=eps),
                            data_format)
        return _from_nc(_affine(F.instance_norm(an, eps=eps), w, b),
                        data_format)

    return apply_fn("instance_norm", fn, x, *_opt(weight, bias))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Each sample's channels split into ``num_groups`` groups, each group
    normalised over its channels and spatial dims (:124-150)."""
    def fn(a, *wb):
        w, b = _split_wb(wb, weight, bias)
        an = _to_nc(a, data_format)
        if _fused_affine(an, w, b):
            return _from_nc(F.group_norm(an, num_groups, w, b, epsilon),
                            data_format)
        return _from_nc(_affine(F.group_norm(an, num_groups, eps=epsilon),
                                w, b), data_format)

    return apply_fn("group_norm", fn, x, *_opt(weight, bias))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    def fn(a):
        an = _to_nc(a, data_format)
        c, half = an.shape[1], size // 2
        sq = F.pad(torch.square(an).movedim(1, -1),
                   (half, size - 1 - half)).movedim(-1, 1)
        acc = sum(sq[:, i:i + c] for i in range(size))
        return _from_nc(an / (k + alpha * acc) ** beta, data_format)

    return apply_fn("local_response_norm", fn, x)


def spectral_norm(x, weight_u, weight_v, dim=0, power_iters=1, eps=1e-12,
                  name=None):
    """``x / sigma``, sigma the largest singular value of x (``dim`` first,
    the rest flattened) by ``power_iters`` power iterations from
    ``weight_u`` (:169-180); the vectors are not written back."""
    def fn(w, u, v):
        w_mat = w.movedim(dim, 0).reshape(w.shape[dim], -1)
        for _ in range(power_iters):
            v = w_mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = w_mat @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        return w / (u @ w_mat @ v)

    return apply_fn("spectral_norm", fn, x, weight_u, weight_v)
