"""The long tail of ``paddle.tensor`` — port of ``paddle_tpu/tensor/
extras.py``.

Each op is a torch function dispatched through ``core/op_registry.apply_fn``
under the JAX op name, so AMP, the nan/inf check and the stats hook of
``amp.debugging`` see it, and torch's autograd records it. The four
``linalg`` names of the JAX module (``cholesky_inverse``, ``lu_unpack``,
``svd_lowrank``, ``ormqr``) and ``i0`` / ``i1`` live in ``tensor/linalg.py``
and ``tensor/math.py`` and are re-exported here.

Where JAX's formula and torch's op differ at an edge, the JAX formula is
written out: ``cdist`` / ``dist`` / ``renorm`` (the norms and the clamp),
``masked_scatter`` (positions clipped into the source, never an error),
``multigammaln`` (no host check of the domain), ``logit`` (the clip), and
the histogram edges (``jnp.linspace``: ``lo * (1 - t) + hi * t``, the last
edge exactly ``hi``). ``as_strided`` takes JAX's strides: element strides
over a contiguous copy of ``x``, never strides into ``x``'s storage.
``top_p_sampling`` keeps JAX's nucleus rule and tie order (a stable
descending sort) and draws from an explicit ``torch.Generator``: one seeded
by ``seed``, else the port's global generator of the logits' device.

Departures: integer results are int64 where JAX's are int32 (``frexp``'s
exponent is int32 in both, ``top_p_sampling``'s indices int64);
``gammainc`` / ``gammaincc`` have no gradient for their first argument
(torch has none; JAX differentiates both).
"""

from __future__ import annotations

import math as _math

import torch

from ..core.op_registry import apply_fn
from ..core.tensor import unwrap
from .linalg import cholesky_inverse, lu_unpack, ormqr, svd_lowrank  # noqa
from .math import _float_in, _quantile, i0, i1  # noqa: F401

__all__ = [
    "addmm", "block_diag", "cdist", "cholesky_inverse", "cumulative_trapezoid",
    "diagonal_scatter", "diff", "dist", "dsplit", "frexp", "gammainc",
    "gammaincc", "gammaln", "histogram_bin_edges", "histogramdd", "hsplit",
    "i0", "i0e", "i1", "i1e", "index_fill", "inverse", "is_complex",
    "is_empty", "is_floating_point", "is_integer", "is_tensor", "isin",
    "isneginf", "isposinf", "isreal", "ldexp", "logcumsumexp", "logit",
    "lu_unpack", "masked_scatter", "multigammaln", "nanquantile", "polygamma",
    "reduce_as", "renorm", "reverse", "select_scatter", "sgn", "signbit",
    "sinc", "slice_scatter", "svd_lowrank", "tensor_split", "top_p_sampling",
    "trapezoid", "unflatten", "unfold", "vander", "vsplit", "as_strided",
    "ormqr",
]


def _as_tensor(v, like):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, device=like.device)


# ---- predicates (reference: tensor/attribute.py) ----

def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_complex(x):
    return unwrap(x).is_complex()


def is_floating_point(x):
    return unwrap(x).is_floating_point()


def is_integer(x):
    a = unwrap(x)
    return not (a.is_floating_point() or a.is_complex()
                or a.dtype == torch.bool)


def is_empty(x):
    return unwrap(x).numel() == 0


def isreal(x):
    return apply_fn("isreal", torch.isreal, x)


def isneginf(x):
    return apply_fn("isneginf", torch.isneginf, x)


def isposinf(x):
    return apply_fn("isposinf", torch.isposinf, x)


def signbit(x):
    return apply_fn("signbit", torch.signbit, x)


# ---- math (reference: tensor/math.py) ----

def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply_fn("addmm", lambda i, a, b: beta * i + alpha * (a @ b),
                    input, x, y)


def _pnorm(d, p, dim):
    """JAX's p-norms of ``d`` over ``dim`` (sqrt of a clamped sum of
    squares for 2, the largest magnitude for inf)."""
    if p == 2.0:
        return torch.sqrt(torch.clamp((d * d).sum(dim), min=0.0))
    if p == float("inf"):
        return d.abs().amax(dim)
    return (d.abs() ** p).sum(dim) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    return apply_fn("cdist", lambda a, b: _pnorm(
        a[..., :, None, :] - b[..., None, :, :], p, -1), x, y)


def dist(x, y, p=2, name=None):
    def fn(a, b):
        d = (a - b).reshape(-1)
        if p == 0:
            return torch.count_nonzero(d).to(a.dtype)
        if p == float("inf"):
            return d.abs().max()
        if p == float("-inf"):
            return d.abs().min()
        return (d.abs() ** p).sum() ** (1.0 / p)

    return apply_fn("dist", fn, x, y)


def _edge(v, a, axis):
    """A ``prepend`` / ``append`` value as ``jnp.diff`` takes it: a scalar
    (or 0-dim) broadcast to ``a``'s shape with size 1 along ``axis``."""
    if v is None:
        return None
    v = _as_tensor(unwrap(v), a).to(a.dtype)
    if v.ndim == 0:
        shape = list(a.shape)
        shape[axis] = 1
        v = v.expand(shape)
    return v


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    def fn(a):
        return torch.diff(a, n=n, dim=axis, prepend=_edge(prepend, a, axis),
                          append=_edge(append, a, axis))

    return apply_fn("diff", fn, x)


def frexp(x, name=None):
    return apply_fn("frexp", torch.frexp, x)


def ldexp(x, y, name=None):
    def fn(a, b):
        a = a if a.is_floating_point() else a.float()
        return a * torch.exp2(b.to(torch.int32).to(a.dtype))

    return apply_fn("ldexp", fn, x, y)


def _special(fn):
    """A scipy.special function as JAX runs it: integer inputs in float32,
    bf16/fp16 computed in float32 and rounded back (torch's CPU kernels
    refuse half types for several of them)."""
    def f(*args):
        args = [a if a.is_floating_point() else a.float() for a in args]
        low = args[0].dtype in (torch.bfloat16, torch.float16)
        out = fn(*[a.float() for a in args] if low else args)
        return out.to(args[0].dtype) if low else out
    return f


def gammaln(x, name=None):
    return apply_fn("gammaln", _special(torch.special.gammaln), x)


def gammainc(x, y, name=None):
    return apply_fn("gammainc", _special(torch.special.gammainc), x, y)


def gammaincc(x, y, name=None):
    return apply_fn("gammaincc", _special(torch.special.gammaincc), x, y)


def multigammaln(x, p, name=None):
    """sum_j gammaln(x - j / 2) + p (p - 1) / 4 log(pi), JAX's formula
    (torch's op checks the domain on the host)."""
    p = int(p)

    def fn(a):
        j = torch.arange(p, dtype=a.dtype, device=a.device)
        return (torch.special.gammaln(a[..., None] - j / 2).sum(-1)
                + p * (p - 1) / 4 * _math.log(_math.pi))

    return apply_fn("multigammaln", _special(fn), x)


def polygamma(x, n, name=None):
    return apply_fn("polygamma", _special(
        lambda a: torch.special.polygamma(int(n), a)), x)


def i0e(x, name=None):
    return apply_fn("i0e", _special(torch.special.i0e), x)


def i1e(x, name=None):
    return apply_fn("i1e", _special(torch.special.i1e), x)


def logit(x, eps=None, name=None):
    def fn(a):
        if eps is not None:
            a = torch.clamp(a, eps, 1.0 - eps)
        return torch.log(a / (1 - a))

    return apply_fn("logit", _float_in(fn), x)


def logcumsumexp(x, axis=None, dtype=None, name=None):
    def fn(a):
        if axis is None:
            return torch.logcumsumexp(a.reshape(-1), 0)
        return torch.logcumsumexp(a, axis)

    return apply_fn("logcumsumexp", fn, x)


def sgn(x, name=None):
    def fn(a):
        if a.is_complex():
            mag = a.abs()
            return torch.where(mag == 0, torch.zeros_like(a),
                               a / torch.clamp(mag, min=1e-38))
        return torch.sign(a)

    return apply_fn("sgn", fn, x)


def sinc(x, name=None):
    return apply_fn("sinc", _float_in(torch.sinc), x)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return apply_fn("isin", lambda a, t: torch.isin(a, t, invert=invert),
                    x, test_x)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    xv = unwrap(x)

    def fn(a):
        if xv is not None:
            return torch.trapezoid(a, _as_tensor(xv, a), dim=axis)
        return torch.trapezoid(a, dx=dx if dx is not None else 1.0, dim=axis)

    return apply_fn("trapezoid", fn, y)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    xv = unwrap(x)

    def fn(a):
        d = (torch.diff(_as_tensor(xv, a), dim=axis) if xv is not None
             else (dx if dx is not None else 1.0))
        n = a.shape[axis]
        avg = (a.narrow(axis, 1, n - 1) + a.narrow(axis, 0, n - 1)) / 2.0
        return torch.cumsum(avg * d, dim=axis)

    return apply_fn("cumulative_trapezoid", fn, y)


def _sorted_nanquantile(a, q, dim=None, keepdim=False,
                        interpolation="linear"):
    """``torch.nanquantile`` written out over one sort: the ranks q *
    (count - 1) of each row's non-NaN values, interpolated as numpy does
    (``nearest`` rounds half to even). NaNs are sorted as +inf: torch's
    CUDA sort puts a NaN with its sign bit set (what a cast from bf16
    gives) first, its CPU sort last, so torch's own nanquantile put rows
    of bf16 data 0.72 off on an H100."""
    if dim is None:
        a, dim = a.reshape(-1), 0
    x = a.movedim(dim, -1)
    nan = torch.isnan(x)
    s = torch.sort(torch.where(nan, torch.inf, x), dim=-1).values
    n = (~nan).sum(-1, keepdim=True)
    qs = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    scalar = qs.ndim == 0
    qs = qs.reshape(-1)
    pos = qs.reshape((-1,) + (1,) * x.ndim) * (n - 1).clamp(min=0)
    sb = s.expand((qs.shape[0],) + s.shape)
    lo_i, hi_i = pos.floor().long(), pos.ceil().long()
    lower, upper = sb.gather(-1, lo_i), sb.gather(-1, hi_i)
    if interpolation == "lower":
        out = lower
    elif interpolation == "higher":
        out = upper
    elif interpolation == "midpoint":
        out = (lower + upper) / 2
    elif interpolation == "nearest":
        out = sb.gather(-1, torch.round(pos).long())
    else:
        out = lower + (upper - lower) * (pos - lo_i)
    out = torch.where(n == 0, torch.nan, out).squeeze(-1)
    if keepdim:
        out = out.unsqueeze(1 + dim % a.ndim)
    return out[0] if scalar else out


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    def fn(a):
        # half types are computed in float32 and rounded back (JAX's
        # result dtype)
        half = a.dtype in (torch.bfloat16, torch.float16)
        x = a.float() if half else a
        qv = unwrap(q)
        qq = qv if isinstance(qv, (list, tuple, torch.Tensor)) \
            else float(qv)
        out = _quantile(x, qq, axis, keepdim, interpolation,
                        fn=_sorted_nanquantile)
        return out.to(a.dtype) if half else out

    return apply_fn("nanquantile", fn, x)


def reduce_as(x, target, name=None):
    """Sum-reduce x to target's shape (reference: tensor/math.py
    reduce_as)."""
    def fn(a, t):
        extra = a.ndim - t.ndim
        axes = tuple(range(extra)) + tuple(
            i + extra for i, s in enumerate(t.shape)
            if s == 1 and a.shape[i + extra] != 1)
        out = a.sum(axes) if axes else a
        return out.reshape(t.shape)

    return apply_fn("reduce_as", fn, x, target)


def renorm(x, p, axis, max_norm, name=None):
    def fn(a):
        axes = tuple(i for i in range(a.ndim) if i != axis % a.ndim)
        norms = (a.abs() ** p).sum(axes, keepdim=True) ** (1.0 / p)
        factor = torch.where(norms > max_norm,
                             max_norm / torch.clamp(norms, min=1e-12),
                             torch.ones_like(norms))
        return a * factor

    return apply_fn("renorm", fn, x)


def vander(x, n=None, increasing=False, name=None):
    def fn(a):
        cols = a.shape[0] if n is None else int(n)
        powers = torch.arange(cols, device=a.device)
        if not increasing:
            powers = powers.flip(0)
        return a[:, None] ** powers.to(a.dtype if a.is_floating_point()
                                       else torch.int64)

    return apply_fn("vander", fn, x)


# ---- linalg (reference: tensor/linalg.py) ----

def inverse(x, name=None):
    return apply_fn("inverse", torch.linalg.inv, x)


def block_diag(inputs, name=None):
    from .creation import to_tensor

    args = [i if isinstance(i, torch.Tensor) else to_tensor(i)
            for i in inputs]
    return apply_fn("block_diag", lambda *a: torch.block_diag(*a), *args)


# ---- manipulation (reference: tensor/manipulation.py) ----

def _sections(num_or_indices):
    if isinstance(num_or_indices, int):
        return num_or_indices
    return [int(unwrap(i)) for i in num_or_indices]


def _split_helper(op_name, axis):
    def f(x, num_or_indices, name=None):
        def fn(a):
            if isinstance(num_or_indices, int) \
                    and a.shape[axis] % num_or_indices:
                raise ValueError(f"{op_name}: the size {a.shape[axis]} of "
                                 f"axis {axis} does not divide into "
                                 f"{num_or_indices} equal parts")
            return tuple(torch.tensor_split(a, _sections(num_or_indices),
                                            dim=axis))

        return apply_fn(op_name, fn, x)

    f.__name__ = op_name
    return f


hsplit = _split_helper("hsplit", 1)
vsplit = _split_helper("vsplit", 0)
dsplit = _split_helper("dsplit", 2)


def tensor_split(x, num_or_indices, axis=0, name=None):
    return apply_fn("tensor_split", lambda a: tuple(torch.tensor_split(
        a, _sections(num_or_indices), dim=axis)), x)


def reverse(x, axis, name=None):
    axes = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return apply_fn("reverse", lambda a: torch.flip(a, axes), x)


def unflatten(x, axis, shape, name=None):
    shp = tuple(int(unwrap(s)) for s in shape)

    def fn(a):
        ax = axis % a.ndim
        return a.reshape(a.shape[:ax] + shp + a.shape[ax + 1:])

    return apply_fn("unflatten", fn, x)


def unfold(x, axis, size, step, name=None):
    """Sliding windows along axis -> an appended window dim (torch's
    ``Tensor.unfold`` layout)."""
    return apply_fn("unfold", lambda a: a.unfold(axis % a.ndim, size, step),
                    x)


def as_strided(x, shape, stride, offset=0, name=None):
    """JAX's strided view: element strides over a contiguous copy of x."""
    shape = tuple(int(s) for s in shape)
    stride = tuple(int(s) for s in stride)

    def fn(a):
        flat = a.contiguous().reshape(-1)
        if not shape:
            return flat[offset]
        return torch.as_strided(flat, shape, stride,
                                flat.storage_offset() + offset).clone()

    return apply_fn("as_strided", fn, x)


def index_fill(x, index, axis, value, name=None):
    val = unwrap(value)

    def fn(a, idx):
        v = val.to(a.dtype) if isinstance(val, torch.Tensor) else val
        return torch.index_fill(a, axis, idx.reshape(-1), v)

    return apply_fn("index_fill", fn, x, index)


def masked_scatter(x, mask, value, name=None):
    """JAX's formula: the k-th True position takes value's k-th element,
    positions past the source's end its last."""
    def fn(a, m, v):
        mb = torch.broadcast_to(m, a.shape).reshape(-1)
        pos = torch.cumsum(mb.to(torch.int64), 0) - 1
        src = v.reshape(-1)
        gathered = src[torch.clamp(pos, 0, src.shape[0] - 1)]
        return torch.where(mb, gathered, a.reshape(-1)).reshape(a.shape)

    return apply_fn("masked_scatter", fn, x, mask, value)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return apply_fn("diagonal_scatter", lambda a, b: torch.diagonal_scatter(
        a, b.to(a.dtype), offset, axis1, axis2), x, y)


def select_scatter(x, values, axis, index, name=None):
    return apply_fn("select_scatter", lambda a, v: torch.select_scatter(
        a, v.to(a.dtype), axis, index), x, values)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def fn(a, v):
        sl = [slice(None)] * a.ndim
        for ax, st, en, sd in zip(axes, starts, ends, strides):
            sl[ax] = slice(st, en, sd)
        out = a.clone()
        out[tuple(sl)] = v.to(a.dtype)
        return out

    return apply_fn("slice_scatter", fn, x, value)


# ---- histogram (reference: tensor/linalg.py histogram*) ----

def _linspace(lo, hi, num, dtype):
    """``jnp.linspace(lo, hi, num)`` as XLA rounds it: lo * (1 - t) + hi * t
    for t = i * (1 / (num - 1)) (a product with the reciprocal, not a
    quotient), the last point exactly hi."""
    lo = torch.as_tensor(lo, dtype=dtype)
    hi = torch.as_tensor(hi, dtype=dtype, device=lo.device)
    t = torch.arange(num - 1, dtype=dtype, device=lo.device) * torch.tensor(
        1.0 / (num - 1), dtype=dtype, device=lo.device)
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def histogram_bin_edges(x, bins=100, min=0.0, max=0.0, name=None):
    def fn(a):
        if min == max == 0.0:
            lo, hi = a.min(), a.max()
        else:
            lo = torch.tensor(min, dtype=a.dtype, device=a.device)
            hi = torch.tensor(max, dtype=a.dtype, device=a.device)
        dt = a.dtype if a.is_floating_point() else torch.float32
        return _linspace(lo.to(dt), hi.to(dt), bins + 1,
                         dt).to(torch.float32)

    return apply_fn("histogram_bin_edges", fn, x)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``jnp.histogramdd`` of the rows of ``x`` [N, D]: ``ranges`` is a
    FLAT [min0, max0, min1, max1, ...] list (the reference's API). Returns
    (hist, [edges of each dim]); the counts are int64 (JAX's int32) unless
    weighted or ``density``."""
    rng_pairs = None
    if ranges is not None:
        flat = [float(v) for v in ranges]
        if len(flat) % 2:
            raise ValueError("ranges must hold min/max pairs, got odd length")
        rng_pairs = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]

    def fn(a, *w):
        n, d = a.shape
        dt = a.dtype if a.is_floating_point() else torch.float32
        a = a.to(dt)
        per_dim = list(bins) if isinstance(bins, (list, tuple)) else [bins] * d
        edges, idx = [], []
        for i in range(d):
            col = a[:, i]
            b = per_dim[i]
            if isinstance(b, torch.Tensor) or not isinstance(b, int):
                e = torch.as_tensor(unwrap(b), dtype=dt, device=a.device)
            else:
                if rng_pairs is None:
                    lo, hi = col.min(), col.max()
                else:
                    lo = torch.tensor(rng_pairs[i][0], dtype=dt,
                                      device=a.device)
                    hi = torch.tensor(rng_pairs[i][1], dtype=dt,
                                      device=a.device)
                same = lo == hi
                lo = torch.where(same, lo - 0.5, lo)
                hi = torch.where(same, hi + 0.5, hi)
                e = _linspace(lo, hi, b + 1, dt)
            k = torch.searchsorted(e, col.contiguous(), right=True)
            k = torch.where(col == e[-1], k - 1, k)
            edges.append(e)
            idx.append(k)
        nbins = [e.shape[0] + 1 for e in edges]
        flat_idx = torch.zeros(n, dtype=torch.int64, device=a.device)
        for k, nb in zip(idx, nbins):
            flat_idx = flat_idx * nb + torch.clamp(k, 0, nb - 1)
        size = _math.prod(nbins)
        if w:   # summed in fp32, rounded to the weights' dtype once
            hist = torch.zeros(size, dtype=torch.float32, device=a.device)
            hist = hist.index_add(0, flat_idx, w[0].reshape(-1).float()
                                  ).to(w[0].dtype)
        else:
            hist = torch.bincount(flat_idx, minlength=size)
        hist = hist.reshape(nbins)[(slice(1, -1),) * d]
        if density:
            hist = hist.to(dt)
            hist = hist / hist.sum()
            for i, e in enumerate(edges):
                shape = [1] * d
                shape[i] = -1
                hist = hist / torch.diff(e).reshape(shape)
        return hist, edges

    args = (x,) if weights is None else (x, weights)
    return apply_fn("histogramdd", fn, *args)


# ---- sampling (reference: tensor/search.py top_p_sampling) ----

def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling over the last axis; ``ps`` a scalar or a per-row
    tensor [batch]. Returns (values, indices), each [..., 1]. The nucleus
    is JAX's: sorted by probability (descending, ties in index order) a
    token is kept while the mass before it is <= p, so the first always
    is."""
    from ..framework.random import generator

    def fn(logits, *p_arr):
        probs = torch.softmax(logits.float(), dim=-1)
        sorted_p, sort_idx = torch.sort(probs, dim=-1, descending=True,
                                        stable=True)
        cum = torch.cumsum(sorted_p, dim=-1)
        if p_arr:
            pv = p_arr[0].float()
            p_b = pv.reshape(tuple(pv.shape)
                             + (1,) * (logits.ndim - pv.ndim))
        else:
            p_b = float(ps)
        keep = cum - sorted_p <= p_b
        filtered = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
        filtered = filtered / filtered.sum(-1, keepdim=True)
        gen = (torch.Generator(device=logits.device).manual_seed(int(seed))
               if seed is not None else generator(logits.device))
        rows = filtered.reshape(-1, filtered.shape[-1])
        choice = torch.multinomial(rows, 1, generator=gen).reshape(
            filtered.shape[:-1] + (1,))
        idx = torch.gather(sort_idx, -1, choice)
        return torch.gather(probs, -1, idx), idx

    if isinstance(ps, (float, int)):
        return apply_fn("top_p_sampling", fn, x)
    return apply_fn("top_p_sampling", fn, x, ps)
