"""Shape, layout and indexing ops — port of ``paddle_tpu/tensor/
manipulation.py``, each dispatched through the op registry.

Index operands that torch saves for the backward (``gather``,
``gather_nd``, ``index_select``, ``index_sample``, ``take_along_axis``) are
copied first, so an index tensor changed in place after the forward does
not change the gradient, as the JAX package snapshots them.

Departures where torch cannot do what JAX does: ``reshape_`` changes the
tensor in place only outside autograd (a tensor that requires grad cannot
change its shape in place in torch, where JAX rebinds a handle); an
integer index result is int64 (JAX, with 64-bit mode off, gives int32).
``unique``, ``unique_consecutive``, ``masked_select``, ``nonzero`` and the
one-argument ``where`` have data-dependent shapes and read to the host, as
in the JAX package.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as dtype_mod
from ..core.op_registry import apply_fn
from ..core.tensor import Tensor, unwrap


def _u(x):
    return unwrap(x)


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _resolve_shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.tolist())
    if isinstance(shape, (list, tuple, torch.Size)):
        return tuple(_int(s) for s in shape)
    return (int(shape),)


def _on(like, value):
    """A host value (list, array, number) as a tensor on ``like``'s
    device."""
    return torch.as_tensor(np.asarray(value), device=like.device)


def reshape(x, shape, name=None):
    shp = _resolve_shape(shape)
    return apply_fn("reshape", lambda a: torch.reshape(a, shp), x)


def reshape_(x, shape, name=None):
    """Reshape ``x`` itself (same storage). torch cannot change the shape
    of a tensor that requires grad in place: use :func:`reshape` there."""
    if x.requires_grad:
        raise RuntimeError("reshape_ on a tensor that requires grad: torch "
                           "has no in-place reshape under autograd; use "
                           "reshape")
    x.data = torch.reshape(_u(x), _resolve_shape(shape))
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(a):
        if a.ndim == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis, stop_axis)

    return apply_fn("flatten", fn, x)


def squeeze(x, axis=None, name=None):
    def fn(a):
        if axis is None:
            return torch.squeeze(a)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        return torch.squeeze(a, tuple(_int(ax) % a.ndim for ax in axes)) \
            if a.ndim else a

    return apply_fn("squeeze", fn, x)


def unsqueeze(x, axis, name=None):
    def fn(a):
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        out = a
        for ax in sorted(_int(v) for v in axes):
            out = out.unsqueeze(ax)
        return out

    return apply_fn("unsqueeze", fn, x)


def transpose(x, perm, name=None):
    perm = [_int(p) for p in perm]
    return apply_fn("transpose", lambda a: a.permute(perm), x)


def t(x, name=None):
    return apply_fn("t", lambda a: a.t() if a.ndim >= 2 else a, x)


def moveaxis(x, source, destination, name=None):
    return apply_fn("moveaxis", lambda a: torch.movedim(a, source,
                                                        destination), x)


def swapaxes(x, axis0, axis1, name=None):
    return apply_fn("swapaxes", lambda a: torch.swapaxes(a, axis0, axis1), x)


swapdims = swapaxes


def concat(x, axis=0, name=None):
    axis = _int(axis)
    return apply_fn("concat", lambda *xs: torch.cat(xs, axis), *list(x))


def stack(x, axis=0, name=None):
    return apply_fn("stack", lambda *xs: torch.stack(xs, axis), *list(x))


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` equal parts (the axis must divide), or section
    sizes with at most one -1 (the rest)."""
    axis = _int(axis)

    def fn(a):
        n = a.shape[axis]
        if isinstance(num_or_sections, int):
            if n % num_or_sections:
                raise ValueError(f"split: axis of size {n} does not divide "
                                 f"into {num_or_sections} equal parts")
            return tuple(torch.split(a, n // num_or_sections, axis))
        secs = [_int(s) for s in num_or_sections]
        known = builtins.sum(s for s in secs if s >= 0)
        secs = [s if s >= 0 else n - known for s in secs]
        return tuple(torch.split(a, secs, axis))

    return list(apply_fn("split", fn, x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(apply_fn("unbind", lambda a: tuple(torch.unbind(
        a, int(axis))), x))


def unstack(x, axis=0, num=None, name=None):
    return unbind(x, axis)


def tile(x, repeat_times, name=None):
    reps = tuple(_int(r) for r in repeat_times) \
        if isinstance(repeat_times, (list, tuple)) else (_int(repeat_times),)
    return apply_fn("tile", lambda a: torch.tile(a, reps), x)


def expand(x, shape, name=None):
    shp = _resolve_shape(shape)

    def fn(a):
        tgt = list(shp)
        off = len(tgt) - a.ndim
        for i in range(len(tgt)):
            if tgt[i] == -1:
                tgt[i] = a.shape[i - off]
        return torch.broadcast_to(a, tuple(tgt))

    return apply_fn("expand", fn, x)


def expand_as(x, y, name=None):
    shp = tuple(y.shape)
    return apply_fn("expand_as", lambda a: torch.broadcast_to(a, shp), x)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(apply_fn("broadcast_tensors", lambda *xs: tuple(
        torch.broadcast_tensors(*xs)), *inputs))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return apply_fn("flip", lambda a: torch.flip(a, tuple(axes)), x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_fn("rot90", lambda a: torch.rot90(a, k, tuple(axes)), x)


def roll(x, shifts, axis=None, name=None):
    return apply_fn("roll", lambda a: torch.roll(a, shifts, axis), x)


def cast(x, dtype):
    dt = dtype_mod.convert_dtype(dtype)
    return apply_fn("cast", lambda a: a.to(dt), x)


def gather(x, index, axis=0, name=None):
    axis = _int(axis)
    return apply_fn("gather", lambda a, i: torch.index_select(
        a, axis, i.reshape(-1).clone()), x, index)


def _nd_index(idx):
    """[..., k] integer indices as the tuple of k index tensors."""
    return tuple(idx.long().clone().movedim(-1, 0))


def gather_nd(x, index, name=None):
    return apply_fn("gather_nd", lambda a, i: a[_nd_index(i)], x, index)


def _scatter(a, i, u, overwrite):
    i = (i.reshape(-1).long(),)
    if overwrite:
        return a.index_put(i, u)
    return a.index_put(i, torch.zeros_like(u)).index_put(i, u,
                                                         accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of x replaced by ``updates`` (``overwrite``), or set
    to the sum of their updates."""
    return apply_fn("scatter", lambda a, i, u: _scatter(a, i, u, overwrite),
                    x, index, updates)


def scatter_(x, index, updates, overwrite=True, name=None):
    """:func:`scatter` into x itself."""
    out = scatter(x, index, updates, overwrite)
    with torch.no_grad():
        x.copy_(out)
    return x


def scatter_nd_add(x, index, updates, name=None):
    return apply_fn("scatter_nd_add", lambda a, i, u: a.index_put(
        _nd_index(i), u, accumulate=True), x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    return apply_fn("scatter_nd", lambda i, u: torch.zeros(
        _resolve_shape(shape), dtype=u.dtype, device=u.device).index_put(
        _nd_index(i), u, accumulate=True), index, updates)


def index_select(x, index, axis=0, name=None):
    return apply_fn("index_select", lambda a, i: torch.index_select(
        a, _int(axis), i.reshape(-1).clone()), x, index)


def index_sample(x, index, name=None):
    return apply_fn("index_sample", lambda a, i: torch.gather(
        a, 1, i.long().clone()), x, index)


def index_add(x, index, axis, value, name=None):
    return apply_fn("index_add", lambda a, i, v: torch.index_add(
        a, axis % a.ndim, i.reshape(-1), v), x, index, value)


def index_put(x, indices, value, accumulate=False, name=None):
    return apply_fn("index_put", lambda a, v, *idx: a.index_put(
        tuple(idx), v, accumulate=accumulate), x, value, *indices)


def masked_select(x, mask, name=None):
    return apply_fn("masked_select", torch.masked_select, x, mask)


def masked_fill(x, mask, value, name=None):
    return apply_fn("masked_fill", lambda a, m: torch.where(
        m, torch.as_tensor(_u(value), dtype=a.dtype, device=a.device), a),
        x, mask)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply_fn("take_along_axis", lambda a, i: torch.take_along_dim(
        a, i.long().clone(), axis), arr, indices)


_REDUCE = {"add": "sum", "mul": "prod", "multiply": "prod", "amin": "amin",
           "amax": "amax", "mean": "mean"}


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    """``values`` written at ``indices`` along ``axis``: assigned, or
    combined with x's element by add / mul / amin / amax / mean
    (``include_self`` matters for mean only, as in the JAX package)."""
    def fn(a, i, *v):
        i = i.long()
        val = v[0] if v else values
        val = torch.as_tensor(val, dtype=a.dtype, device=a.device) \
            .broadcast_to(i.shape)
        if reduce == "assign":
            return torch.scatter(a, axis, i, val)
        return torch.scatter_reduce(a, axis, i, val, _REDUCE[reduce],
                                    include_self=include_self
                                    if reduce == "mean" else True)

    if isinstance(values, torch.Tensor):
        return apply_fn("put_along_axis", fn, arr, indices, values)
    return apply_fn("put_along_axis", fn, arr, indices)


def take(x, index, mode="raise", name=None):
    """Elements of the flattened x at ``index``; out-of-range indices raise
    (``mode="raise"``) or are clipped (any other mode, as the JAX
    package's)."""
    def fn(a, i):
        flat = a.reshape(-1)
        i = i.long()
        if mode != "raise":
            i = i.clamp(0, flat.numel() - 1)
        return torch.take(flat, i)

    return apply_fn("take", fn, x, index)


def slice(input, axes, starts, ends, name=None):
    def fn(a):
        sl = [builtins.slice(None)] * a.ndim
        for ax, s, e in zip(axes, starts, ends):
            sl[ax] = builtins.slice(_int(s), _int(e))
        return a[tuple(sl)]

    return apply_fn("slice", fn, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    def fn(a):
        sl = [builtins.slice(None)] * a.ndim
        flips = []
        for ax, s, e, st in zip(axes, starts, ends, strides):
            s, e, st = _int(s), _int(e), _int(st)
            if st < 0:   # torch slices take positive steps only
                n = a.shape[ax]
                idx = list(range(n))[builtins.slice(s, e, st)]
                sl[ax] = torch.as_tensor(idx, dtype=torch.long,
                                         device=a.device)
                flips.append(ax)
            else:
                sl[ax] = builtins.slice(s, e, st)
        out = a
        for ax, s in enumerate(sl):
            if isinstance(s, torch.Tensor):
                out = out.index_select(ax, s)
            else:
                out = out[(builtins.slice(None),) * ax + (s,)]
        return out

    return apply_fn("strided_slice", fn, x)


def crop(x, shape=None, offsets=None, name=None):
    shp = _resolve_shape(shape)
    offs = [_int(o) for o in (offsets or [0] * len(shp))]

    def fn(a):
        return a[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]

    return apply_fn("crop", fn, x)


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad widths as the JAX package reads them: 2 n values pad every dim
    in order (dim 0 first); fewer pad the last ones (the spatial dims of an
    NC* layout), pairs in dim order."""
    def fn(a):
        p = [_int(v) for v in pad]
        nd = a.ndim
        if len(p) == 2 * nd:
            width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
        else:
            width = [(0, 0)] * nd
            npairs = len(p) // 2
            first = 2 if (data_format.startswith("NC") and nd >= 3
                          and npairs == nd - 2) else nd - npairs
            for i in range(npairs):
                width[first + i] = (p[2 * i], p[2 * i + 1])
        # torch's F.pad lists (before, after) from the last dim backwards,
        # and pads only as many trailing dims as it is given
        lead = min((i for i, w in enumerate(width) if w != (0, 0)),
                   default=nd)
        tp = [v for i in range(nd - 1, lead - 1, -1) for v in width[i]]
        if not tp:
            return a.clone()
        if mode == "constant":
            return F.pad(a, tp, value=value)
        return F.pad(a, tp, mode=_PAD_MODES[mode])

    return apply_fn("pad", fn, x)


def repeat_interleave(x, repeats, axis=None, name=None):
    def fn(a, *r):
        rep = r[0] if r else repeats
        return torch.repeat_interleave(a if axis is not None
                                       else a.reshape(-1), rep,
                                       0 if axis is None else axis)

    if isinstance(repeats, torch.Tensor):
        return apply_fn("repeat_interleave", fn, x, repeats)
    return apply_fn("repeat_interleave", fn, x)


def _host(x):
    t = _u(x).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """numpy's ``unique`` of x on the host (sorted values), as the JAX
    package computes it; results on x's device."""
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _on(x, res).to(x.dtype).as_subclass(Tensor)
    outs = [_on(x, res[0]).to(x.dtype)] + [_on(x, r) for r in res[1:]]
    return tuple(o.as_subclass(Tensor) for o in outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    a = _host(x).reshape(-1) if axis is None else _host(x)
    vals, counts = [], []
    inverse = np.zeros(a.shape[0], dtype=np.int64)
    for i, v in enumerate(a):
        if not vals or not np.array_equal(v, vals[-1]):
            vals.append(v)
            counts.append(1)
        else:
            counts[-1] += 1
        inverse[i] = len(vals) - 1
    outs = [_on(x, np.array(vals)).to(x.dtype)]
    if return_inverse:
        outs.append(_on(x, inverse))
    if return_counts:
        outs.append(_on(x, np.array(counts, dtype=np.int64)))
    outs = [o.as_subclass(Tensor) for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; with neither, the
    indices of the true elements, one tensor per dim."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)

    def fn(c, a, b):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return torch.where(c, a, b)

    return apply_fn("where", fn, condition, x, y)


def nonzero(x, as_tuple=False):
    out = torch.nonzero(_u(x), as_tuple=as_tuple)
    if as_tuple:
        return tuple(o.as_subclass(Tensor) for o in out)
    return out.as_subclass(Tensor)


def as_real(x, name=None):
    return apply_fn("as_real", lambda a: torch.stack(
        [a.real, a.imag], -1), x)


def as_complex(x, name=None):
    return apply_fn("as_complex", lambda a: torch.complex(
        a[..., 0], a[..., 1]), x)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    dt = dtype_mod.convert_dtype(shape_or_dtype)
    return apply_fn("view_dtype", lambda a: a.view(dt), x)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def _atleast(fn_name, inputs):
    fn = getattr(torch, fn_name)
    outs = [apply_fn(fn_name, fn, i) for i in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast("atleast_1d", inputs)


def atleast_2d(*inputs, name=None):
    return _atleast("atleast_2d", inputs)


def atleast_3d(*inputs, name=None):
    return _atleast("atleast_3d", inputs)


def tensordot(x, y, axes=2, name=None):
    return apply_fn("tensordot", lambda a, b: torch.tensordot(a, b, axes),
                    x, y)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def fn(i):
        size = index_num // nshards
        lo, hi = shard_id * size, (shard_id + 1) * size
        return torch.where((i >= lo) & (i < hi), i - lo,
                           torch.full_like(i, ignore_value))

    return apply_fn("shard_index", fn, input)
