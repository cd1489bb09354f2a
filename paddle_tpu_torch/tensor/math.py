"""Elementwise and reduction math ops — port of ``paddle_tpu/tensor/
math.py``.

Each op is a torch function dispatched through the op registry
(``core/op_registry.apply_fn``): AMP and the nan/inf check see it, and
torch's autograd records it. ``matmul``, ``inner`` and
``outer`` carry the JAX package's white ``OpDef("matmul")`` and
``logsumexp`` its black ``OpDef("logsumexp")``; every other op is neutral.

A Python number meets a tensor as JAX's weak type does: it takes the
tensor's dtype (a float number and an integer tensor give the default
float dtype). Integer sums, products and counts are int64 (torch's and
Paddle's rule) where the JAX package, with 64-bit mode off, gives int32.
"""

from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtype_mod
from ..core.op_registry import AMP_BLACK, AMP_WHITE, OpDef, apply_fn
from ..core.tensor import Tensor, unwrap
from ..device import resolve_place

_MATMUL_DEF = OpDef("matmul", None, amp=AMP_WHITE)
_LSE_DEF = OpDef("logsumexp", None, amp=AMP_BLACK)


def _u(x):
    return unwrap(x)


def _axis(axis):
    """Paddle's axis argument as torch's dim: None, an int or a tuple."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        a = axis.tolist()
        return tuple(a) if isinstance(a, list) else int(a)
    if isinstance(axis, (list, tuple)):
        return tuple(int(_u(a)) for a in axis)
    return int(axis)


def _dims(a, axis):
    """``_axis`` as a tuple of dims (every dim for None)."""
    ax = _axis(axis)
    if ax is None:
        return tuple(range(a.ndim))
    return ax if isinstance(ax, tuple) else (ax,)


def _weak(s, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-dim tensor of the dtype JAX's weak type gives
    it against ``like`` (filled on the device: no copy from the host)."""
    if isinstance(s, builtins.bool):
        dt = like.dtype
    elif isinstance(s, builtins.complex):
        dt = like.dtype if like.is_complex() else torch.complex64
    elif isinstance(s, float):
        dt = like.dtype if (like.is_floating_point() or like.is_complex()) \
            else dtype_mod.get_default_dtype()
    else:
        dt = like.dtype if like.dtype != torch.bool else torch.int64
    return torch.full((), s, dtype=dt, device=like.device)


def _pair(a, b):
    """Both operands as tensors, a Python number weakly typed against the
    other; two numbers on the current place."""
    a_t, b_t = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if a_t and b_t:
        return a, b
    if a_t:
        return a, _weak(b, a)
    if b_t:
        return _weak(a, b), b
    dev = resolve_place()
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def _binary(name, fn):
    def torch_fn(a, b):
        return fn(*_pair(a, b))

    def op(x, y, name=None):
        return apply_fn(op_name, torch_fn, x, y)

    op_name = name
    op.__name__ = name
    return op


def _float_in(fn):
    """fn over a floating input: an integer or bool tensor is cast to the
    default float dtype first (JAX's rule for transcendental ops)."""
    def f(a):
        if not (a.is_floating_point() or a.is_complex()):
            a = a.to(dtype_mod.get_default_dtype())
        return fn(a)
    return f


# ---------- binary elementwise ----------

add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
mod = _binary("mod", torch.remainder)
remainder = mod
floor_mod = mod
pow = _binary("pow", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)
hypot = _binary("hypot", torch.hypot)
copysign = _binary("copysign", torch.copysign)
nextafter = _binary("nextafter", torch.nextafter)
heaviside = _binary("heaviside", torch.heaviside)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
logaddexp = _binary("logaddexp", torch.logaddexp)


# ---------- unary elementwise ----------

def _unary(name, fn, amp=None):
    op_name = name

    def op(x, name=None):
        return apply_fn(op_name, fn, x)

    op.__name__ = op_name
    return op


exp = _unary("exp", _float_in(torch.exp))
expm1 = _unary("expm1", _float_in(torch.expm1))
log = _unary("log", _float_in(torch.log))
log2 = _unary("log2", _float_in(torch.log2))
log10 = _unary("log10", _float_in(torch.log10))
log1p = _unary("log1p", _float_in(torch.log1p))
sqrt = _unary("sqrt", _float_in(torch.sqrt))
rsqrt = _unary("rsqrt", _float_in(torch.rsqrt))
abs = _unary("abs", torch.abs)
sign = _unary("sign", torch.sign)
neg = _unary("neg", torch.neg)
negative = neg
sin = _unary("sin", _float_in(torch.sin))
cos = _unary("cos", _float_in(torch.cos))
tan = _unary("tan", _float_in(torch.tan))
asin = _unary("asin", _float_in(torch.asin))
acos = _unary("acos", _float_in(torch.acos))
atan = _unary("atan", _float_in(torch.atan))
sinh = _unary("sinh", _float_in(torch.sinh))
cosh = _unary("cosh", _float_in(torch.cosh))
tanh = _unary("tanh", _float_in(torch.tanh))
asinh = _unary("asinh", _float_in(torch.asinh))
acosh = _unary("acosh", _float_in(torch.acosh))
atanh = _unary("atanh", _float_in(torch.atanh))
ceil = _unary("ceil", torch.ceil)
floor = _unary("floor", torch.floor)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda a: a - torch.trunc(a))
reciprocal = _unary("reciprocal", torch.reciprocal)
square = _unary("square", torch.square)
sigmoid = _unary("sigmoid", _float_in(torch.sigmoid))
erf = _unary("erf", _float_in(torch.erf))
erfinv = _unary("erfinv", _float_in(torch.erfinv))
lgamma = _unary("lgamma", _float_in(torch.lgamma))
digamma = _unary("digamma", _float_in(torch.digamma))
i0 = _unary("i0", _float_in(torch.i0))
i1 = _unary("i1", _float_in(torch.special.i1))
angle = _unary("angle", torch.angle)
conj = _unary("conj", lambda a: torch.conj_physical(a) if a.is_complex()
              else a.clone())
real = _unary("real", lambda a: torch.real(a).clone())
imag = _unary("imag", lambda a: torch.imag(a).clone() if a.is_complex()
              else torch.zeros_like(a))
deg2rad = _unary("deg2rad", _float_in(torch.deg2rad))
rad2deg = _unary("rad2deg", _float_in(torch.rad2deg))
exponent = None  # the JAX module's placeholder (not in paddle)


def isnan(x, name=None):
    return apply_fn("isnan", torch.isnan, x)


def isinf(x, name=None):
    return apply_fn("isinf", torch.isinf, x)


def isfinite(x, name=None):
    return apply_fn("isfinite", torch.isfinite, x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_fn("nan_to_num", lambda a: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf), x)


def clip(x, min=None, max=None, name=None):
    return apply_fn("clip", lambda a: torch.clamp(a, _u(min), _u(max)), x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s, b = _u(scale), _u(bias)

    def fn(a):
        return a * s + b if bias_after_scale else (a + b) * s

    return apply_fn("scale", fn, x)


def increment(x, value=1.0, name=None):
    """``x += value`` in place (outside autograd), as the JAX package
    rebinds x."""
    with torch.no_grad():
        x.add_(value)
    return x


def lerp(x, y, weight, name=None):
    """``x + weight * (y - x)`` (the formula itself: torch.lerp switches
    formula at weight 0.5)."""
    if isinstance(weight, (int, float)):
        return apply_fn("lerp", lambda a, b: a + weight * (b - a), x, y)
    return apply_fn("lerp", lambda a, b, w: a + w * (b - a), x, y, weight)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_fn("stanh", lambda a: scale_b * torch.tanh(scale_a * a), x)


def multiplex(inputs, index, name=None):
    """Row r of the result is row r of ``inputs[index[r]]``."""
    def fn(idx, *xs):
        stacked = torch.stack(xs, 0)
        sel = idx.reshape(1, -1, *([1] * (stacked.ndim - 2))).long()
        return torch.take_along_dim(stacked, sel, 0)[0]

    return apply_fn("multiplex", fn, index, *inputs)


# ---------- matmul family (tensor-core ops — AMP white) ----------

def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.ndim > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.ndim > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply_fn("matmul", fn, x, y, _opdef=_MATMUL_DEF)


def inner(x, y, name=None):
    return apply_fn("inner", torch.inner, x, y, _opdef=_MATMUL_DEF)


def outer(x, y, name=None):
    return apply_fn("outer", lambda a, b: torch.outer(
        a.reshape(-1), b.reshape(-1)), x, y, _opdef=_MATMUL_DEF)


def kron(x, y, name=None):
    return apply_fn("kron", torch.kron, x, y)


# ---------- reductions ----------

def _keep_all(out, a, keepdim):
    """A reduction over every dim, reshaped to ones when ``keepdim``."""
    return out.reshape((1,) * a.ndim) if keepdim else out


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    dt = dtype_mod.convert_dtype(dtype)
    return apply_fn("sum", lambda a: torch.sum(
        a, dim=_dims(a, axis), keepdim=keepdim, dtype=dt)
        if a.ndim else torch.sum(a, dtype=dt), x)


def mean(x, axis=None, keepdim=False, name=None):
    def fn(a):
        a = _float_in(lambda t: t)(a)
        return torch.mean(a, dim=_dims(a, axis), keepdim=keepdim) \
            if a.ndim else a.clone()

    return apply_fn("mean", fn, x)


def max(x, axis=None, keepdim=False, name=None):
    return apply_fn("max", lambda a: torch.amax(a, dim=_dims(a, axis),
                                                keepdim=keepdim), x)


def min(x, axis=None, keepdim=False, name=None):
    return apply_fn("min", lambda a: torch.amin(a, dim=_dims(a, axis),
                                                keepdim=keepdim), x)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    dt = dtype_mod.convert_dtype(dtype)

    def fn(a):
        if axis is None:
            return _keep_all(torch.prod(a, dtype=dt), a, keepdim)
        out = a if dt is None else a.to(dt)
        for d in sorted((d % a.ndim for d in _dims(a, axis)), reverse=True):
            out = torch.prod(out, d, keepdim=keepdim)
        return out

    return apply_fn("prod", fn, x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply_fn("logsumexp", lambda a: torch.logsumexp(
        a, _dims(a, axis), keepdim=keepdim), x, _opdef=_LSE_DEF)


def all(x, axis=None, keepdim=False, name=None):
    return apply_fn("all", lambda a: torch.all(a, dim=_dims(a, axis),
                                               keepdim=keepdim), x)


def any(x, axis=None, keepdim=False, name=None):
    return apply_fn("any", lambda a: torch.any(a, dim=_dims(a, axis),
                                               keepdim=keepdim), x)


def cumsum(x, axis=None, dtype=None, name=None):
    dt = dtype_mod.convert_dtype(dtype)

    def fn(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=dt)
        return torch.cumsum(a, _axis(axis), dtype=dt)

    return apply_fn("cumsum", fn, x)


def cumprod(x, dim=None, dtype=None, name=None):
    dt = dtype_mod.convert_dtype(dtype)

    def fn(a):
        if dim is None:
            return torch.cumprod(a.reshape(-1), 0, dtype=dt)
        return torch.cumprod(a, _axis(dim), dtype=dt)

    return apply_fn("cumprod", fn, x)


def _cum_extreme(x, axis, dtype, op, new):
    """Shared cummax/cummin: the running extreme and the index of its FIRST
    occurrence (the JAX package's scan keeps the earlier index on a tie;
    torch's cummax keeps the later one)."""
    dt = dtype_mod.convert_dtype(dtype)

    def fn(a):
        arr = a.reshape(-1) if axis is None else a
        ax = 0 if axis is None else _axis(axis) % arr.ndim
        vals = op(arr, ax).values
        prev = torch.cat([vals.narrow(ax, 0, 1), vals.narrow(
            ax, 0, arr.shape[ax] - 1)], ax)
        pos = torch.arange(arr.shape[ax], device=a.device).reshape(
            [-1 if i == ax else 1 for i in range(arr.ndim)]).expand(arr.shape)
        first = pos == 0
        idx = torch.where(first | new(arr, prev), pos, 0)
        return vals, torch.cummax(idx, ax).values.to(dt)

    return apply_fn("cum_extreme", fn, x)


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, torch.cummax, torch.gt)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, torch.cummin, torch.lt)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    dt = dtype_mod.convert_dtype(dtype)
    return apply_fn("nansum", lambda a: torch.nansum(
        a, dim=_dims(a, axis), keepdim=keepdim, dtype=dt), x)


def nanmean(x, axis=None, keepdim=False, name=None):
    return apply_fn("nanmean", lambda a: torch.nanmean(
        a, dim=_dims(a, axis), keepdim=keepdim), x)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def fn(a):
        dims = _dims(a, axis)
        out = torch.count_nonzero(a, dim=dims)
        if keepdim:
            for d in sorted(d % a.ndim for d in dims):
                out = out.unsqueeze(d)
        return out

    return apply_fn("count_nonzero", fn, x)


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs

    def fn(*xs):
        out = xs[0]
        for a in xs[1:]:
            out = out + a
        return out

    return apply_fn("add_n", fn, *inputs)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_fn("trace", lambda a: torch.diagonal(
        a, offset, axis1, axis2).sum(-1), x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_fn("diagonal", lambda a: torch.diagonal(
        a, offset, axis1, axis2), x)


# ---------- logic / comparison ----------

equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)


def equal_all(x, y, name=None):
    a, b = _u(x), _u(y)
    same = a.shape == b.shape and builtins.bool(torch.equal(a, b))
    return torch.tensor(same, device=a.device).as_subclass(Tensor)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a = _u(x)
    out = torch.allclose(a, _u(y), rtol=_u(rtol), atol=_u(atol),
                         equal_nan=equal_nan)
    return torch.tensor(out, device=a.device).as_subclass(Tensor)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply_fn("isclose", lambda a, b: torch.isclose(
        a, b, rtol=_u(rtol), atol=_u(atol), equal_nan=equal_nan), x, y)


logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)


def logical_not(x, out=None, name=None):
    return apply_fn("logical_not", torch.logical_not, x)


bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _binary("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _binary("bitwise_right_shift",
                              torch.bitwise_right_shift)


def bitwise_not(x, out=None, name=None):
    return apply_fn("bitwise_not", torch.bitwise_not, x)


# ---------- stat ----------

def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_fn("std", lambda a: torch.std(
        a, dim=_dims(a, axis), correction=1 if unbiased else 0,
        keepdim=keepdim), x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_fn("var", lambda a: torch.var(
        a, dim=_dims(a, axis), correction=1 if unbiased else 0,
        keepdim=keepdim), x)


def _quantile(a, q, axis, keepdim, method, nan=False, fn=None):
    """torch.quantile over an axis, a tuple of axes (moved last and
    flattened) or every element (None); ``fn`` (torch.quantile's
    signature) replaces torch's function."""
    fn = fn or (torch.nanquantile if nan else torch.quantile)
    if axis is None:
        out = fn(a.reshape(-1), q, interpolation=method)
        return out.reshape(out.shape + (1,) * a.ndim) if keepdim else out
    dims = tuple(d % a.ndim for d in _dims(a, axis))
    if len(dims) == 1:
        return fn(a, q, dims[0], keepdim=keepdim, interpolation=method)
    rest = [d for d in range(a.ndim) if d not in dims]
    flat = a.permute(rest + list(dims)).reshape(
        [a.shape[d] for d in rest] + [-1])
    out = fn(flat, q, -1, interpolation=method)
    if keepdim:
        kept = tuple(1 if d in dims else a.shape[d] for d in range(a.ndim))
        out = out.reshape(out.shape[:out.ndim - len(rest)] + kept)
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The mean of the two middle values ("avg"), or the lower one
    ("min", and for integer inputs, in float32, as the JAX package)."""
    def fn(a):
        if mode == "min" or not a.is_floating_point():
            return _quantile(a.float(), 0.5, axis, keepdim, "lower")
        return _quantile(a, 0.5, axis, keepdim, "linear")

    return apply_fn("median", fn, x)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return apply_fn("nanmedian", lambda a: _quantile(
        a, 0.5, axis, keepdim, "linear", nan=True), x)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    def fn(a):
        qq = torch.as_tensor(_u(q), dtype=a.dtype, device=a.device) \
            if isinstance(q, (list, tuple, torch.Tensor)) else float(q)
        return _quantile(a, qq, axis, keepdim, interpolation)

    return apply_fn("quantile", fn, x)


def histogram(x, bins=100, min=0, max=0, name=None):
    """Counts of ``bins`` equal bins over [min, max] (the data's range when
    both are 0), the last bin closed; int64 counts."""
    a = _u(x).float()
    lo, hi = _u(min), _u(max)
    if lo == 0 and hi == 0:
        lo, hi = a.min().item(), a.max().item()
    return torch.histc(a, bins, lo, hi).long().as_subclass(Tensor)


def bincount(x, weights=None, minlength=0, name=None):
    out = torch.bincount(_u(x), weights=None if weights is None
                         else _u(weights), minlength=minlength)
    return out.as_subclass(Tensor)
