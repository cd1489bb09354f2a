"""Common functionals — port of ``paddle_tpu/nn/functional/common.py`` and
``flatten`` (``paddle_tpu/tensor/manipulation.py:34``), each through the
op dispatcher under the JAX package's op name: ``linear`` under its white
``OpDef("linear")``, the others neutral.

``interpolate`` is the JAX package's ``jax.image.resize`` (:133-149),
written out: half-pixel centres; ``nearest`` takes input pixel
floor((i + 0.5) in / out); ``linear`` / ``bilinear`` / ``trilinear`` and
``area`` (which the JAX package runs as linear) use the triangle kernel,
``bicubic`` Keys' cubic kernel (a = -0.5), both widened by in / out when
shrinking (antialiasing), each output's weights normalised to sum 1 and
zero where its sample falls outside the input. One weight matrix an axis,
applied by a matmul in the input's dtype. ``align_corners=True`` (which
the JAX package ignores) is Paddle's meaning, torch's
``interpolate(align_corners=True)``. So is ``align_mode=1`` for
``linear`` / ``bilinear`` / ``trilinear`` without ``align_corners``: the
asymmetric source index ``i * in / out`` (``1 / scale_factor`` when that
is given), its weights built on the host in fp32 likewise; the other
modes ignore it, as Paddle's do.

``pixel_shuffle`` / ``pixel_unshuffle`` in NHWC order the channels as in
NCHW (Paddle's kernels); the JAX package's NHWC forms order them
otherwise (ROADMAP, "Deliberate departures").

The masks of ``dropout``, ``dropout2d`` / ``dropout3d`` (whole channels)
and ``alpha_dropout`` come from ``generator`` or the global generator of
the input's device; their bits cannot equal ``jax.random``'s.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.op_registry import AMP_WHITE, OpDef, apply_fn
from ...core.tensor import Tensor
from ...framework.random import generator as global_generator

_LINEAR = OpDef("linear", None, amp=AMP_WHITE)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (the Paddle
    layout, not ``torch.nn.functional.linear``'s ``[out, in]``)."""
    if bias is None:
        return apply_fn("linear", lambda a, w: F.linear(a, w.t()), x, weight,
                        _opdef=_LINEAR)
    return apply_fn("linear", lambda a, w, b: F.linear(a, w.t(), b), x,
                    weight, bias, _opdef=_LINEAR)


def dropout_eval_kernel(a, p=0.5, axis=None, mode="upscale_in_train"):
    """Test-mode dropout: the identity, or ``a * (1 - p)`` for
    ``mode="downscale_in_infer"``."""
    return a if mode == "upscale_in_train" else a * (1 - p)


def dropout_train_kernel(a, p=0.5, axis=None, mode="upscale_in_train",
                         generator=None):
    """Keep each element (each slice along ``axis``: the mask spans only
    those dims) with probability 1 - p; ``upscale_in_train`` scales the
    kept ones by 1 / (1 - p). The mask comes from ``generator`` or the
    global generator of a's device; its bits cannot equal ``jax.random``'s.
    """
    shape = list(a.shape)
    if axis is not None:
        axes = [ax % a.ndim for ax in (axis if isinstance(axis, (list, tuple))
                                       else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(a.shape)]
    gen = generator if generator is not None else global_generator(a.device)
    keep = torch.empty(shape, device=a.device).bernoulli_(
        1.0 - p, generator=gen).bool()
    if mode == "upscale_in_train":
        return torch.where(keep, a / (1.0 - p), torch.zeros_like(a))
    return torch.where(keep, a, torch.zeros_like(a))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Dropout (:40-54); the identity outside training or at p = 0 (for the
    default mode)."""
    axis = list(axis) if isinstance(axis, (list, tuple)) else axis
    if not training or p == 0.0:
        return apply_fn("dropout_eval", dropout_eval_kernel, x, p=p,
                        mode=mode)
    return apply_fn("dropout", dropout_train_kernel, x, p=p, axis=axis,
                    mode=mode, generator=generator)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x`` (cast to int32 first, as the JAX
    package does); the rows of ids equal to a non-negative ``padding_idx``
    are zeros (so their gradient is zero). Ids out of range raise (JAX's
    gather clamps them)."""
    def fn(w, idx):
        out = F.embedding(idx, w)
        if padding_idx is not None and padding_idx >= 0:
            out = torch.where((idx == padding_idx)[..., None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out

    ids = x.astype("int32") if isinstance(x, Tensor) else x
    return apply_fn("embedding", fn, weight, ids)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return apply_fn("flatten", lambda a: torch.flatten(a, start_axis,
                                                       stop_axis), x)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Dropout of whole channels of an NCHW / NHWC input."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis, training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis, training, generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """Dropout that keeps a SELU network's mean and variance: dropped
    elements take -alpha * scale, then an affine correction (:73-88)."""
    if not training or p == 0.0:
        return x

    def fn(a):
        gen = generator if generator is not None \
            else global_generator(a.device)
        keep = torch.empty(a.shape, device=a.device).bernoulli_(
            1.0 - p, generator=gen).bool()
        alpha_p = -_SELU_ALPHA * _SELU_SCALE
        q = 1.0 - p
        a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
        b_coef = -a_coef * alpha_p * p
        return a_coef * torch.where(keep, a, alpha_p) + b_coef

    return apply_fn("alpha_dropout", fn, x)


def one_hot(x, num_classes, name=None):
    """fp32 one-hot rows; an index outside [0, num_classes) gives a row of
    zeros (``jax.nn.one_hot``'s rule)."""
    return apply_fn("one_hot", lambda idx: (idx[..., None] == torch.arange(
        num_classes, device=idx.device)).float(), x)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def fn(lab, *pd):
        if pd:
            return (1 - epsilon) * lab + epsilon * pd[0]
        return (1 - epsilon) * lab + epsilon / lab.shape[-1]

    extra = [prior_dist] if prior_dist is not None else []
    return apply_fn("label_smooth", fn, label, *extra)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def fn(a, b):
        num = torch.sum(a * b, axis)
        den = torch.sqrt(torch.sum(a * a, axis)) * torch.sqrt(
            torch.sum(b * b, axis))
        return num / den.clamp_min(eps)

    return apply_fn("cosine_similarity", fn, x1, x2)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def fn(a):
        nrm = torch.sum(torch.abs(a) ** p, axis, keepdim=True) ** (1.0 / p)
        return a / nrm.clamp_min(epsilon)

    return apply_fn("normalize", fn, x)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ...tensor.manipulation import pad as _pad

    return _pad(x, pad, mode, value, data_format)


_RESIZE = {"nearest": "nearest", "bilinear": "linear", "trilinear": "linear",
           "linear": "linear", "bicubic": "cubic", "area": "linear"}
_TORCH_ALIGNED = {"linear": "linear", "bilinear": "bilinear",
                  "trilinear": "trilinear", "bicubic": "bicubic"}


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out, method):
    """[n_in, n_out] fp32 weights of ``jax.image``'s ``compute_weight_mat``
    (no translation, antialiased), in its fp32 arithmetic."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), 1 - x) if method == "linear" else _keys_cubic(x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def _resize(a, axes, sizes, method):
    """Each axis resized in turn by a gather (nearest) or a matmul with its
    weight matrix, both built on the host in numpy's IEEE fp32 as
    ``jax.image`` computes them (a CUDA division by a scalar multiplies by
    its reciprocal, which moves a nearest index)."""
    for ax, n_out in zip(axes, sizes):
        n_in = a.shape[ax]
        if n_in == n_out:
            continue
        if method == "nearest":
            pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
                * np.float32(n_in) / np.float32(n_out)
            idx = torch.from_numpy(np.floor(pos).astype(np.int64))
            a = a.index_select(ax, idx.to(a.device))
        else:
            w = torch.from_numpy(_resize_weights(n_in, n_out, method))
            a = torch.matmul(a.movedim(ax, -1),
                             w.to(a.device, a.dtype)).movedim(-1, ax)
    return a


def _asymmetric_weights(n_in, n_out, ratio):
    """[n_in, n_out] fp32 weights of Paddle's linear resize with
    ``align_mode=1``: output i reads ``src = ratio * i`` (no half-pixel
    shift), between ``floor(src)`` and the next sample (the last sample
    alone at the end)."""
    f32 = np.float32
    src = f32(ratio) * np.arange(n_out, dtype=f32)
    lo = np.floor(src).astype(np.int64).clip(0, n_in - 1)
    frac = (src - lo).astype(f32)
    hi = np.minimum(lo + 1, n_in - 1)
    w = np.zeros((n_in, n_out), f32)
    cols = np.arange(n_out)
    np.add.at(w, (lo, cols), f32(1) - frac)
    np.add.at(w, (hi, cols), frac)
    return w


def _resize_asymmetric(a, axes, sizes, ratios):
    for ax, n_out, r in zip(axes, sizes, ratios):
        w = torch.from_numpy(_asymmetric_weights(a.shape[ax], n_out, r))
        a = torch.matmul(a.movedim(ax, -1),
                         w.to(a.device, a.dtype)).movedim(-1, ax)
    return a


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims to ``size`` or ``floor(dim *
    scale_factor)`` (see the module docstring)."""
    if mode not in _RESIZE:
        raise ValueError(f"unknown interpolation mode {mode!r}")
    if align_corners and mode not in _TORCH_ALIGNED:
        raise ValueError(f"align_corners=True with mode {mode!r}")
    asymmetric = align_mode == 1 and not align_corners \
        and mode in ("linear", "bilinear", "trilinear")
    cf = data_format.startswith("NC")

    def fn(a):
        spatial = a.shape[2:] if cf else a.shape[1:-1]
        if size is not None:
            tgt = [int(s) for s in (size if isinstance(size, (list, tuple))
                                    else [size])]
        else:
            sf = (scale_factor if isinstance(scale_factor, (list, tuple))
                  else [scale_factor] * len(spatial))
            tgt = [int(s * f) for s, f in zip(spatial, sf)]
        if align_corners:
            an = a if cf else a.movedim(-1, 1)
            out = F.interpolate(an, size=tgt, mode=_TORCH_ALIGNED[mode],
                                align_corners=True)
            return out if cf else out.movedim(1, -1)
        first = 2 if cf else 1
        if asymmetric:
            ratios = ([1.0 / f for f in sf] if size is None
                      else [s / t for s, t in zip(spatial, tgt)])
            return _resize_asymmetric(a, range(first, first + len(tgt)), tgt,
                                      ratios)
        return _resize(a, range(first, first + len(tgt)), tgt, _RESIZE[mode])

    return apply_fn("interpolate", fn, x)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return tuple(int(u) for u in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


def _unfold_pads(paddings):
    """(top, bottom, left, right) from an int, a pair, or Paddle's four
    [top, left, bottom, right]."""
    if isinstance(paddings, (list, tuple)) and len(paddings) == 4:
        t, l_, b, r = (int(v) for v in paddings)
        return t, b, l_, r
    ph, pw = _pair(paddings)
    return ph, ph, pw, pw


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] -> [N, C kh kw, L], the channel-major order of
    the JAX package (:152-175)."""
    t, b, l_, r = _unfold_pads(paddings)

    def fn(a):
        if t == b and l_ == r:
            return F.unfold(a, _pair(kernel_sizes), _pair(dilations),
                            (t, l_), _pair(strides))
        return F.unfold(F.pad(a, (l_, r, t, b)), _pair(kernel_sizes),
                        _pair(dilations), 0, _pair(strides))

    return apply_fn("unfold", fn, x)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the sum of the overlapping patches (:178-200)."""
    return apply_fn("fold", lambda a: F.fold(
        a, _pair(output_sizes), _pair(kernel_sizes), _pair(dilations),
        _pair(paddings), _pair(strides)), x)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] . weight[o] . x2[b] (+ bias)``."""
    def fn(a, b, w, *bb):
        out = F.bilinear(a, b, w)
        return out + bb[0] if bb else out

    extra = [bias] if bias is not None else []
    return apply_fn("bilinear", fn, x1, x2, weight, *extra)


def _nchw(fn, data_format):
    """``fn`` of an NCHW tensor applied to one in ``data_format``."""
    if data_format == "NCHW":
        return fn
    return lambda a: fn(a.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return apply_fn("pixel_shuffle", _nchw(
        lambda a: F.pixel_shuffle(a, upscale_factor), data_format), x)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return apply_fn("pixel_unshuffle", _nchw(
        lambda a: F.pixel_unshuffle(a, downscale_factor), data_format), x)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def fn(a):
        n, c, h, w = a.shape
        return a.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)

    return apply_fn("channel_shuffle", _nchw(fn, data_format), x)
