"""Tensor creation ops — port of ``paddle_tpu/tensor/creation.py``.

A function with no tensor argument places its result on ``place`` when it
takes one, else on the port's current place (the CUDA device unless
``paddle_tpu_torch.set_device`` chose another; without a card that raises,
never a silent CPU tensor). A ``*_like`` function follows its argument.

dtypes: a float default is ``get_default_dtype()`` (float32), as in the
JAX package. An integer default is torch's int64 where the JAX package,
with JAX's 64-bit mode off, gives int32 (``arange(5)``, ``full([2], 3)``,
``to_tensor([1, 2])``); Paddle's own default is int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.op_registry import apply_fn
from ..core.tensor import Tensor, unwrap
from ..device import CUDAPinnedPlace, resolve_place


def _dt(dtype, default=None):
    return dtype_mod.convert_dtype(dtype) or default


def _host_value(v):
    """A Python scalar from a number or a 0-dim tensor (a host read)."""
    return v.item() if isinstance(v, torch.Tensor) else v


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: ``data`` (a tensor, numpy array, list or
    number) as a Paddle ``Tensor`` on ``place`` (the current place by
    default; a tensor's own device when it is one and no place is given).
    float64 numpy data and Python floats take the default dtype (float32),
    as in the JAX package. A tensor argument keeps its graph only when
    ``stop_gradient`` is False."""
    dt = _dt(dtype)
    if isinstance(data, torch.Tensor):
        dev = data.device if place is None else resolve_place(place)
        t = unwrap(data)
        t = t.detach() if stop_gradient else t
        t = t.to(device=dev, dtype=dt or t.dtype)
        if t is unwrap(data):   # to_tensor copies, as Paddle's does
            t = t.clone()
        t = t.as_subclass(Tensor)
    else:
        dev = resolve_place(place)
        arr = np.asarray(data)
        if dt is None and (arr.dtype == np.float64 or isinstance(data,
                                                                 float)):
            dt = dtype_mod.get_default_dtype()
        t = torch.as_tensor(arr).to(device=dev, dtype=dt, copy=True
                                    ).as_subclass(Tensor)
    if isinstance(place, CUDAPinnedPlace):
        t = t.pin_memory()
    if not stop_gradient:
        if t.is_leaf:
            t.requires_grad_(True)
        else:
            t.stop_gradient = False
    return t


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(_host_value(s)) for s in shape)


def zeros(shape, dtype=None, name=None, place=None):
    dt = _dt(dtype, dtype_mod.get_default_dtype())
    shape, dev = _shape(shape), resolve_place(place)
    return apply_fn("zeros", lambda: torch.zeros(shape, dtype=dt,
                                                 device=dev))


def ones(shape, dtype=None, name=None, place=None):
    dt = _dt(dtype, dtype_mod.get_default_dtype())
    shape, dev = _shape(shape), resolve_place(place)
    return apply_fn("ones", lambda: torch.ones(shape, dtype=dt, device=dev))


def full(shape, fill_value, dtype=None, name=None, place=None):
    """``fill_value`` sets the dtype when none is given: a float the
    default float dtype, an int int64, a bool bool."""
    fill_value = _host_value(fill_value)
    dt = _dt(dtype)
    if dt is None and isinstance(fill_value, float):
        dt = dtype_mod.get_default_dtype()
    shape, dev = _shape(shape), resolve_place(place)
    return apply_fn("full", lambda: torch.full(shape, fill_value, dtype=dt,
                                               device=dev))


def zeros_like(x, dtype=None, name=None):
    return apply_fn("zeros_like", lambda a: torch.zeros_like(
        a, dtype=_dt(dtype)), x)


def ones_like(x, dtype=None, name=None):
    return apply_fn("ones_like", lambda a: torch.ones_like(
        a, dtype=_dt(dtype)), x)


def full_like(x, fill_value, dtype=None, name=None):
    return apply_fn("full_like", lambda a: torch.full_like(
        a, _host_value(fill_value), dtype=_dt(dtype)), x)


def empty(shape, dtype=None, name=None):
    """Zeros, as the JAX package's (an empty buffer reads garbage)."""
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = (_host_value(v) for v in (start, end, step))
    if end is None:
        start, end = 0, start
    dt = _dt(dtype)
    if dt is None and any(isinstance(v, float) for v in (start, end, step)):
        dt = dtype_mod.get_default_dtype()
    return torch.arange(start, end, step, dtype=dt,
                        device=resolve_place()).as_subclass(Tensor)


def linspace(start, stop, num, dtype=None, name=None):
    dt = _dt(dtype, dtype_mod.get_default_dtype())
    return torch.linspace(_host_value(start), _host_value(stop),
                          int(_host_value(num)), dtype=dt,
                          device=resolve_place()).as_subclass(Tensor)


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    dt = _dt(dtype, dtype_mod.get_default_dtype())
    return torch.logspace(_host_value(start), _host_value(stop),
                          int(_host_value(num)), base=_host_value(base),
                          dtype=dt, device=resolve_place()).as_subclass(Tensor)


def eye(num_rows, num_columns=None, dtype=None, name=None):
    dt = _dt(dtype, dtype_mod.get_default_dtype())
    m = int(num_columns) if num_columns is not None else int(num_rows)
    return torch.eye(int(num_rows), m, dtype=dt,
                     device=resolve_place()).as_subclass(Tensor)


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D x: the square matrix with x on diagonal ``offset`` and
    ``padding_value`` elsewhere; a 2-D x: its diagonal ``offset``."""
    def fn(a):
        if a.ndim == 1 and padding_value != 0:
            on = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
            return torch.where(on, torch.diag(a, offset), padding_value)
        return torch.diag(a, offset)

    return apply_fn("diag", fn, x)


def diagflat(x, offset=0, name=None):
    return apply_fn("diagflat", lambda a: torch.diagflat(a, offset), x)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply_fn("diag_embed", lambda a: torch.diag_embed(
        a, offset, dim1, dim2), x)


def tril(x, diagonal=0, name=None):
    return apply_fn("tril", lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return apply_fn("triu", lambda a: torch.triu(a, diagonal), x)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return [o.as_subclass(Tensor) for o in torch.meshgrid(
        *[unwrap(a) for a in args], indexing="ij")]


def assign(x, output=None):
    """A copy of ``x`` (tensor, array or number); into ``output`` in place
    when given."""
    if output is not None:
        return output.set_value(x)
    if isinstance(x, torch.Tensor):
        return clone(x)
    return to_tensor(x)


def clone(x, name=None):
    return apply_fn("clone", torch.clone, x)


def numel(x, name=None):
    return torch.tensor(int(np.prod(tuple(x.shape))) if x.ndim else 1,
                        device=x.device).as_subclass(Tensor)


def tril_indices(row, col, offset=0, dtype="int64"):
    r, c = np.tril_indices(row, offset, col)
    return to_tensor(np.stack([r, c]), dtype=dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = col if col is not None else row
    r, c = np.triu_indices(row, offset, col)
    return to_tensor(np.stack([r, c]), dtype=dtype)


def complex(real, imag, name=None):
    return apply_fn("complex", torch.complex, real, imag)


def polar(abs_t, angle, name=None):
    return apply_fn("polar", torch.polar, abs_t, angle)
