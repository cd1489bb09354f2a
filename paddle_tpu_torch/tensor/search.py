"""Search and sort ops — port of ``paddle_tpu/tensor/search.py``.

Ties resolve as in the JAX package: sorts are stable, so ``argsort``,
``topk`` and ``kthvalue`` give the lower index first among equal values
(``topk`` sorts the whole axis for that: torch's ``topk`` leaves the order
of ties unspecified). ``mode`` runs on the host, as the JAX package's
does: the smallest of the most frequent values and its first index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.op_registry import apply_fn
from ..core.tensor import Tensor, unwrap


def _arg_extreme(name, fn, x, axis, keepdim, dtype):
    dt = dtype_mod.convert_dtype(dtype)

    def f(a):
        if axis is None:
            out = fn(a.reshape(-1))
            return (out.reshape((1,) * a.ndim) if keepdim else out).to(dt)
        return fn(a, int(unwrap(axis)), keepdim=keepdim).to(dt)

    return apply_fn(name, f, x)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg_extreme("argmax", torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg_extreme("argmin", torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return apply_fn("argsort", lambda a: torch.argsort(
        a, dim=axis, descending=descending, stable=True), x)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return apply_fn("sort", lambda a: torch.sort(
        a, dim=axis, descending=descending, stable=True).values, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the k largest (smallest) along ``axis``
    (the last by default), in order, ties by the lower index."""
    k = int(unwrap(k))

    def fn(a):
        ax = (axis if axis is not None else -1) % a.ndim
        idx = torch.argsort(a, dim=ax, descending=largest,
                            stable=True).narrow(ax, 0, k)
        return torch.take_along_dim(a, idx, ax), idx

    return apply_fn("topk", fn, x)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """(the k-th smallest value along ``axis``, its int64 index)."""
    def fn(a):
        ax = axis % a.ndim
        idx = torch.argsort(a, dim=ax, stable=True).narrow(ax, k - 1, 1)
        v = torch.take_along_dim(a, idx, ax)
        return (v, idx) if keepdim else (v.squeeze(ax), idx.squeeze(ax))

    return apply_fn("kthvalue", fn, x)


def mode(x, axis=-1, keepdim=False, name=None):
    """(the most frequent value along ``axis`` — the smallest on a tie — and
    the index of its first occurrence), computed on the host."""
    t = unwrap(x).detach().cpu()
    a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    ax = axis % a.ndim

    def most(v):
        vals, counts = np.unique(v, return_counts=True)
        return vals[np.argmax(counts)]

    vals_k = np.expand_dims(np.apply_along_axis(most, ax, a), ax)
    idx = np.argmax(a == vals_k, axis=ax)
    vals = vals_k if keepdim else np.squeeze(vals_k, ax)
    if keepdim:
        idx = np.expand_dims(idx, ax)
    dev = x.device
    return (torch.as_tensor(vals, device=dev).to(x.dtype).as_subclass(Tensor),
            torch.as_tensor(idx.astype(np.int64), device=dev)
            .as_subclass(Tensor))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply_fn("searchsorted", lambda s, v: torch.searchsorted(
        s, v, out_int32=out_int32, right=right), sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)
