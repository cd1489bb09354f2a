"""Common functionals — port of ``linear``, ``dropout`` and ``embedding``
(``paddle_tpu/nn/functional/common.py`` :17-90) and ``flatten``
(``paddle_tpu/tensor/manipulation.py:34``), each through the op
dispatcher: ``linear`` under the JAX package's white ``OpDef("linear")``,
the others neutral."""

from __future__ import annotations

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
