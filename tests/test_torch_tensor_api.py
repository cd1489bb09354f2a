"""The port's ``paddle.*`` tensor functions (``tensor/creation``, ``math``,
``manipulation``, ``search``, ``random``, ``einsum`` and indexing) and the
``Tensor`` methods ``tensor._install`` maps, against the JAX package on the
same numpy inputs (CPU, ``np.random.default_rng``), one case a function.

Tolerances:
- float outputs: max |port - jax| <= 1e-6 x max(1, max |jax|) (fp32; the
  two packages' kernels round differently in the last place), and the same
  float dtype;
- integer and bool outputs equal (values: the JAX package, with 64-bit
  mode off, gives int32 where the port gives Paddle's int64);
- gradients of the differentiable functions, of sum(out * cotangent) with
  a fixed random cotangent: max |port - jax| <= 1e-5 x max(1, max |jax|)
  (the JAX tape differentiates ``jax.vjp`` of the same formulas);
- random functions: their bits cannot equal ``jax.random``'s, so shape,
  dtype, range and ``seed`` / ``get_rng_state`` reproducibility are held.
``tests/op_sweep_specs.py``'s ``paddle:`` / ``method:`` symbols (read, never
edited) are the checklist: the port's coverage of them is reported and
held to a floor.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from paddle_tpu_torch.core.tensor import Tensor as PTensor

torch.set_num_threads(1)
RNG = np.random.default_rng(20260718)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def F(*s):
    return RNG.standard_normal(s).astype(np.float32)


def POS(*s):
    return (np.abs(RNG.standard_normal(s)) + 0.5).astype(np.float32)


def UNIT(*s):
    return RNG.uniform(-0.9, 0.9, s).astype(np.float32)


def GT1(*s):
    return (np.abs(RNG.standard_normal(s)) + 1.5).astype(np.float32)


def I(*s, lo=0, hi=5):
    return RNG.integers(lo, hi, s).astype(np.int64)


def B(*s):
    return RNG.integers(0, 2, s).astype(bool)


def C(*s):
    return (RNG.standard_normal(s) + 1j * RNG.standard_normal(s)).astype(
        np.complex64)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy() if isinstance(x, PTensor) else \
            x.detach().cpu().numpy()
    return np.asarray(getattr(x, "_data", x))


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat(o)]
    return [out]


def _compare(port, ref, tol=1e-6):
    ps, rs = _flat(port), _flat(ref)
    assert len(ps) == len(rs), (len(ps), len(rs))
    for p, r in zip(ps, rs):
        a, b = _np(p), _np(r)
        if not hasattr(b, "dtype") or b.dtype.kind not in "fc":
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64)
                                          if np.asarray(b).dtype != bool
                                          else a, np.asarray(b).astype(
                                              np.int64)
                                          if np.asarray(b).dtype != bool
                                          else b)
            continue
        assert a.shape == b.shape, (a.shape, b.shape)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        err = np.abs(a - b).max() if b.size else 0.0
        assert err <= tol * max(1.0, np.abs(b).max()), err


# (name, fn(P, *tensors), input makers, indices of inputs to differentiate)
CASES = []


def case(name, fn, inputs, grad=(), tol=1e-6):
    CASES.append(pytest.param(fn, inputs, grad, tol, id=name))


# ---- creation ----
case("to_tensor", lambda P, x: P.to_tensor(x), [F(3, 4)])
case("zeros", lambda P: P.zeros([2, 3]), [])
case("ones", lambda P: P.ones([2, 3], dtype="float32"), [])
case("full", lambda P: P.full([2, 3], 1.5), [])
case("zeros_like", lambda P, x: P.zeros_like(x), [F(2, 3)])
case("ones_like", lambda P, x: P.ones_like(x), [F(2, 3)])
case("full_like", lambda P, x: P.full_like(x, 2.5), [F(2, 3)])
case("empty", lambda P: P.empty([2, 2]), [])
case("empty_like", lambda P, x: P.empty_like(x), [F(2, 3)])
case("arange", lambda P: P.arange(0.5, 4.0, 0.5), [])
case("linspace", lambda P: P.linspace(-1.0, 2.0, 7), [])
case("logspace", lambda P: P.logspace(0.0, 2.0, 5), [])
case("eye", lambda P: P.eye(3, 4), [])
case("diag_vec", lambda P, x: P.diag(x, offset=1, padding_value=2.0),
     [F(3)], grad=(0,))
case("diag_mat", lambda P, x: P.diag(x, offset=-1), [F(4, 4)], grad=(0,))
case("diagflat", lambda P, x: P.diagflat(x, 1), [F(2, 2)], grad=(0,))
case("diag_embed", lambda P, x: P.diag_embed(x, 1), [F(2, 3)], grad=(0,))
case("tril", lambda P, x: P.tril(x, 1), [F(4, 5)], grad=(0,))
case("triu", lambda P, x: P.triu(x, -1), [F(4, 5)], grad=(0,))
case("meshgrid", lambda P, a, b: P.meshgrid(a, b), [F(3), F(4)])
case("assign", lambda P, x: P.assign(x), [F(2, 3)])
case("clone", lambda P, x: P.clone(x) * 2, [F(2, 3)], grad=(0,))
case("numel", lambda P, x: P.numel(x), [F(2, 3)])
case("tril_indices", lambda P: P.tril_indices(4, 3, 0), [])
case("triu_indices", lambda P: P.triu_indices(3, 4, 1), [])
case("complex", lambda P, a, b: P.complex(a, b), [F(3), F(3)])
case("polar", lambda P, a, b: P.polar(a, b), [POS(3), F(3)])

# ---- math: binary ----
for _n in ("add", "subtract", "multiply", "divide", "maximum", "minimum",
           "fmax", "fmin", "atan2", "hypot", "copysign", "logaddexp"):
    case(_n, lambda P, a, b, n=_n: getattr(P, n)(a, b), [F(3, 4), F(3, 4)],
         grad=(0, 1))
case("add_broadcast_scalar", lambda P, a: P.add(a, 2.5) * 3.0 - 1.0,
     [F(3, 4)], grad=(0,))
case("floor_divide", lambda P, a, b: P.floor_divide(a, b),
     [I(3, 4, lo=-9, hi=9), I(3, 4, lo=1, hi=4)])
case("mod", lambda P, a, b: P.mod(a, b), [F(3, 4), POS(3, 4)])
case("remainder", lambda P, a, b: P.remainder(a, b),
     [I(3, 4, lo=-9, hi=9), I(3, 4, lo=1, hi=4)])
case("pow", lambda P, a, b: P.pow(a, b), [POS(3, 4), F(3, 4)], grad=(0, 1))
case("pow_scalar", lambda P, a: P.pow(a, 3.0), [F(3, 4)], grad=(0,))
case("nextafter", lambda P, a, b: P.nextafter(a, b), [F(4), F(4)])
case("heaviside", lambda P, a, b: P.heaviside(a, b), [F(4), F(4)])
case("gcd", lambda P, a, b: P.gcd(a, b), [I(5, hi=30), I(5, hi=30)])
case("lcm", lambda P, a, b: P.lcm(a, b), [I(5, lo=1, hi=12),
                                          I(5, lo=1, hi=12)])

# ---- math: unary ----
_UNARY = {
    "exp": F, "expm1": F, "log": POS, "log2": POS, "log10": POS,
    "log1p": POS, "sqrt": POS, "rsqrt": POS, "abs": F, "sign": F, "neg": F,
    "sin": F, "cos": F, "tan": UNIT, "asin": UNIT, "acos": UNIT, "atan": F,
    "sinh": F, "cosh": F, "tanh": F, "asinh": F, "acosh": GT1,
    "atanh": UNIT, "ceil": F, "floor": F, "round": F, "trunc": F,
    "frac": F, "reciprocal": POS, "square": F, "sigmoid": F, "erf": F,
    "erfinv": UNIT, "lgamma": POS, "digamma": POS, "i0": UNIT, "i1": UNIT,
    "deg2rad": F, "rad2deg": F,
}
_NO_GRAD = {"sign", "ceil", "floor", "round", "trunc", "i1"}
for _n, _mk in _UNARY.items():
    case(_n, lambda P, x, n=_n: getattr(P, n)(x), [_mk(3, 4)],
         grad=() if _n in _NO_GRAD else (0,))
case("negative", lambda P, x: P.negative(x), [F(3)], grad=(0,))
for _n in ("angle", "conj", "real", "imag"):
    case(_n + "_complex", lambda P, x, n=_n: getattr(P, n)(x), [C(3, 2)])
case("angle_real", lambda P, x: P.angle(x), [F(5)])
case("imag_real", lambda P, x: P.imag(x), [F(5)])
case("isnan", lambda P, x: P.isnan(P.log(x)), [F(8)])
case("isinf", lambda P, x: P.isinf(P.reciprocal(x * 0.0)), [F(4)])
case("isfinite", lambda P, x: P.isfinite(P.log(x)), [F(8)])
case("nan_to_num", lambda P, x: P.nan_to_num(P.log(x), 0.5, 9.0, -9.0),
     [F(8)])
case("clip", lambda P, x: P.clip(x, -0.5, 0.7), [F(3, 4)], grad=(0,))
case("scale", lambda P, x: P.scale(x, 2.0, 0.5, bias_after_scale=False),
     [F(3, 4)], grad=(0,))
case("increment", lambda P, x: P.increment(P.clone(x), 2.0), [F(3)])
case("lerp", lambda P, a, b: P.lerp(a, b, 0.3), [F(3, 4), F(3, 4)],
     grad=(0, 1))
case("lerp_tensor", lambda P, a, b, w: P.lerp(a, b, w),
     [F(3, 4), F(3, 4), UNIT(3, 4)], grad=(0, 1, 2))
case("stanh", lambda P, x: P.stanh(x), [F(3, 4)], grad=(0,))
case("multiplex", lambda P, a, b, i: P.multiplex([a, b], i),
     [F(4, 3), F(4, 3), I(4, 1, hi=2)], grad=(0, 1))
case("matmul", lambda P, a, b: P.matmul(a, b, transpose_y=True),
     [F(2, 3, 4), F(2, 5, 4)], grad=(0, 1), tol=1e-5)
case("matmul_vec", lambda P, a, b: P.matmul(a, b), [F(4), F(4, 3)],
     grad=(0, 1), tol=1e-5)
case("inner", lambda P, a, b: P.inner(a, b), [F(2, 4), F(3, 4)],
     grad=(0, 1), tol=1e-5)
case("outer", lambda P, a, b: P.outer(a, b), [F(3), F(4)], grad=(0, 1))
case("kron", lambda P, a, b: P.kron(a, b), [F(2, 2), F(2, 3)], grad=(0, 1))

# ---- math: reductions ----
for _n in ("sum", "mean", "max", "min", "amax", "amin", "prod",
           "logsumexp"):
    case(_n, lambda P, x, n=_n: getattr(P, n)(x, axis=1, keepdim=True),
         [F(3, 4, 2)], grad=(0,), tol=1e-5)
    case(_n + "_all", lambda P, x, n=_n: getattr(P, n)(x), [F(3, 4)],
         grad=(0,), tol=1e-5)
case("sum_axes", lambda P, x: P.sum(x, axis=[0, 2]), [F(3, 4, 2)],
     grad=(0,), tol=1e-5)
case("sum_int", lambda P, x: P.sum(x, axis=0), [I(3, 4)])
case("mean_int", lambda P, x: P.mean(x), [I(3, 4)])
case("prod_axes", lambda P, x: P.prod(x, axis=[0, 1]), [F(3, 4, 2)],
     grad=(0,), tol=1e-5)
case("all", lambda P, x: P.all(x, axis=1), [B(3, 4)])
case("any", lambda P, x: P.any(x), [B(3, 4)])
case("cumsum", lambda P, x: P.cumsum(x, axis=1), [F(3, 4)], grad=(0,),
     tol=1e-5)
case("cumsum_flat", lambda P, x: P.cumsum(x), [F(3, 4)], grad=(0,),
     tol=1e-5)
case("cumprod", lambda P, x: P.cumprod(x, dim=0), [F(3, 4)], grad=(0,),
     tol=1e-5)
case("cummax", lambda P, x: P.cummax(x, axis=0), [I(6, 3)])
case("cummin", lambda P, x: P.cummin(x, axis=1), [F(3, 5)])
case("nansum", lambda P, x: P.nansum(P.log(x), axis=1), [F(3, 4)])
case("nanmean", lambda P, x: P.nanmean(P.log(x), axis=0), [F(6, 4)])
case("count_nonzero", lambda P, x: P.count_nonzero(x, axis=1),
     [I(3, 5, hi=2)])
case("add_n", lambda P, a, b: P.add_n([a, b, a]), [F(3), F(3)],
     grad=(0, 1))
case("trace", lambda P, x: P.trace(x, 1), [F(4, 4)], grad=(0,))
case("diagonal", lambda P, x: P.diagonal(x, 0, 1, 2), [F(2, 3, 3)],
     grad=(0,))

# ---- math: logic ----
for _n in ("equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal"):
    case(_n, lambda P, a, b, n=_n: getattr(P, n)(a, b),
         [I(3, 4), I(3, 4)])
case("equal_all", lambda P, a: P.equal_all(a, a), [F(3)])
case("allclose", lambda P, a, b: P.allclose(a, a + b * 1e-9),
     [F(3), F(3)])
case("isclose", lambda P, a, b: P.isclose(a, b), [F(5), F(5)])
for _n in ("logical_and", "logical_or", "logical_xor"):
    case(_n, lambda P, a, b, n=_n: getattr(P, n)(a, b), [B(6), B(6)])
case("logical_not", lambda P, a: P.logical_not(a), [B(6)])
for _n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    case(_n, lambda P, a, b, n=_n: getattr(P, n)(a, b),
         [I(6, hi=64), I(6, hi=64)])
case("bitwise_not", lambda P, a: P.bitwise_not(a), [I(6, lo=-9, hi=9)])
case("bitwise_shift", lambda P, a, b: [P.bitwise_left_shift(a, b),
                                       P.bitwise_right_shift(a, b)],
     [I(6, hi=64), I(6, hi=4)])

# ---- math: statistics ----
case("std", lambda P, x: P.std(x, axis=1), [F(3, 6)], grad=(0,), tol=1e-5)
case("var", lambda P, x: P.var(x, unbiased=False), [F(3, 6)], grad=(0,),
     tol=1e-5)
case("median", lambda P, x: P.median(x, axis=1), [F(3, 6)])
case("median_min", lambda P, x: P.median(x, mode="min"), [F(3, 6)])
case("nanmedian", lambda P, x: P.nanmedian(x, axis=0), [F(5, 3)])
case("quantile", lambda P, x: P.quantile(x, 0.3, axis=1), [F(3, 6)])
# counts: Paddle's int64 in the port, float32 in the JAX package
case("histogram", lambda P, x: P.histogram(x, bins=5, min=-2,
                                           max=2).astype("float32"),
     [F(50)])
case("bincount", lambda P, x: P.bincount(x, minlength=7), [I(20, hi=6)])

# ---- manipulation ----
case("reshape", lambda P, x: P.reshape(x, [4, -1]), [F(2, 3, 4)],
     grad=(0,))
case("flatten", lambda P, x: P.flatten(x, 1, 2), [F(2, 3, 4)], grad=(0,))
case("squeeze", lambda P, x: P.squeeze(x, axis=[0, 2]), [F(1, 3, 1)],
     grad=(0,))
case("unsqueeze", lambda P, x: P.unsqueeze(x, [0, 2]), [F(3, 4)],
     grad=(0,))
case("transpose", lambda P, x: P.transpose(x, [2, 0, 1]), [F(2, 3, 4)],
     grad=(0,))
case("t", lambda P, x: P.t(x), [F(3, 4)], grad=(0,))
case("moveaxis", lambda P, x: P.moveaxis(x, 0, 2), [F(2, 3, 4)],
     grad=(0,))
case("swapaxes", lambda P, x: P.swapaxes(x, 0, 1), [F(2, 3)], grad=(0,))
case("concat", lambda P, a, b: P.concat([a, b], axis=1), [F(2, 3), F(2, 2)],
     grad=(0, 1))
case("stack", lambda P, a, b: P.stack([a, b], axis=1), [F(2, 3), F(2, 3)],
     grad=(0, 1))
case("split", lambda P, x: P.split(x, [1, -1, 2], axis=1), [F(2, 6)],
     grad=(0,))
case("split_equal", lambda P, x: P.split(x, 3, axis=1), [F(2, 6)],
     grad=(0,))
case("chunk", lambda P, x: P.chunk(x, 2, axis=0), [F(4, 3)], grad=(0,))
case("unbind", lambda P, x: P.unbind(x, axis=1), [F(2, 3)], grad=(0,))
case("unstack", lambda P, x: P.unstack(x), [F(2, 3)], grad=(0,))
case("tile", lambda P, x: P.tile(x, [2, 1, 3]), [F(2, 3)], grad=(0,))
case("expand", lambda P, x: P.expand(x, [2, -1, 3]), [F(4, 1)], grad=(0,))
case("expand_as", lambda P, x, y: P.expand_as(x, y), [F(1, 3), F(4, 3)],
     grad=(0,))
case("broadcast_to", lambda P, x: P.broadcast_to(x, [3, 2, 4]),
     [F(2, 1)], grad=(0,))
# the JAX package's broadcast_tensors is off its tape: values only
case("broadcast_tensors", lambda P, a, b: P.broadcast_tensors([a, b]),
     [F(3, 1), F(1, 4)])
case("flip", lambda P, x: P.flip(x, [0, 1]), [F(2, 3)], grad=(0,))
case("rot90", lambda P, x: P.rot90(x, 1, [0, 1]), [F(2, 3)], grad=(0,))
case("roll", lambda P, x: P.roll(x, 2, 1), [F(2, 5)], grad=(0,))
case("roll_flat", lambda P, x: P.roll(x, -3), [F(2, 5)], grad=(0,))
case("cast", lambda P, x: P.cast(x, "int32"), [F(3, 4) * 4])
case("cast_float", lambda P, x: P.cast(x, "float32") * 2, [I(3)])
case("gather", lambda P, x, i: P.gather(x, i, axis=1), [F(3, 5), I(4)],
     grad=(0,))
case("gather_nd", lambda P, x, i: P.gather_nd(x, i), [F(3, 4, 2),
                                                      I(5, 2, hi=3)],
     grad=(0,))
case("scatter", lambda P, x, i, u: P.scatter(x, i, u),
     [F(5, 3), np.array([1, 3], np.int64), F(2, 3)], grad=(0, 2))
case("scatter_add", lambda P, x, i, u: P.scatter(x, i, u, overwrite=False),
     [F(5, 3), np.array([1, 3, 1], np.int64), F(3, 3)], grad=(0, 2))
case("scatter_nd_add", lambda P, x, i, u: P.scatter_nd_add(x, i, u),
     [F(4, 3), I(5, 1, hi=4), F(5, 3)], grad=(0, 2))
case("scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [4, 3]),
     [I(5, 1, hi=4), F(5, 3)], grad=(1,))
case("index_select", lambda P, x, i: P.index_select(x, i, axis=0),
     [F(5, 3), I(4)], grad=(0,))
case("index_sample", lambda P, x, i: P.index_sample(x, i),
     [F(3, 5), I(3, 2)], grad=(0,))
case("index_add", lambda P, x, i, v: P.index_add(x, i, 1, v),
     [F(3, 5), I(2), F(3, 2)], grad=(0, 2))
case("index_put", lambda P, x, i, v: P.index_put(x, (i,), v),
     [F(5, 3), np.array([0, 2], np.int64), F(2, 3)], grad=(0, 2))
case("masked_select", lambda P, x, m: P.masked_select(x, m),
     [F(3, 4), B(3, 4)])
case("masked_fill", lambda P, x, m: P.masked_fill(x, m, 0.5),
     [F(3, 4), B(3, 4)], grad=(0,))
case("take_along_axis", lambda P, x, i: P.take_along_axis(x, i, 1),
     [F(3, 5), I(3, 2)], grad=(0,))
# the JAX package's reducing forms need indices as wide as x on the axis
for _r in ("assign", "add", "mul", "amin", "amax", "mean"):
    case("put_along_axis_" + _r,
         lambda P, x, i, v, r=_r: P.put_along_axis(x, i, v, 1, reduce=r),
         [F(3, 5), I(3, 5, hi=5), F(3, 5)])
case("take", lambda P, x, i: P.take(x, i), [F(3, 4), I(2, 3, hi=12)],
     grad=(0,))
case("take_clip", lambda P, x, i: P.take(x, i, mode="clip"),
     [F(3, 4), I(5, lo=-3, hi=20)])
case("slice", lambda P, x: P.slice(x, [0, 1], [1, -3], [3, 4]),
     [F(4, 5)], grad=(0,))
case("strided_slice",
     lambda P, x: P.strided_slice(x, [0, 1], [0, 4], [4, 0], [2, -2]),
     [F(4, 5)], grad=(0,))
case("crop", lambda P, x: P.crop(x, [2, 3], [1, 1]), [F(4, 5)], grad=(0,))
for _m in ("constant", "reflect", "replicate", "circular"):
    case("pad_" + _m, lambda P, x, m=_m: P.pad(x, [1, 2, 2, 1], mode=m,
                                               value=0.5),
         [F(1, 2, 4, 5)], grad=(0,))
case("pad_full", lambda P, x: P.pad(x, [1, 0, 0, 2]), [F(2, 3)], grad=(0,))
case("repeat_interleave", lambda P, x: P.repeat_interleave(x, 2, 1),
     [F(2, 3)], grad=(0,))
case("repeat_interleave_flat", lambda P, x: P.repeat_interleave(x, 3),
     [F(2, 3)], grad=(0,))
case("unique", lambda P, x: P.unique(x, return_index=True,
                                     return_inverse=True,
                                     return_counts=True), [I(10)])
case("unique_consecutive",
     lambda P, x: P.unique_consecutive(x, return_inverse=True,
                                       return_counts=True),
     [np.array([1, 1, 2, 2, 3, 1, 1], np.int64)])
case("where", lambda P, c, a, b: P.where(c, a, b), [B(3, 4), F(3, 4),
                                                    F(3, 4)], grad=(1, 2))
case("where_indices", lambda P, c: P.where(c), [B(3, 4)])
case("nonzero", lambda P, x: P.nonzero(x), [I(3, 4, hi=2)])
case("nonzero_tuple", lambda P, x: P.nonzero(x, as_tuple=True),
     [I(3, 4, hi=2)])
case("as_real", lambda P, x: P.as_real(x), [C(3)])
case("as_complex", lambda P, x: P.as_complex(x), [F(3, 2)])
case("view", lambda P, x: P.view(x, [3, 4]), [F(2, 6)], grad=(0,))
case("view_as", lambda P, x, y: P.view_as(x, y), [F(2, 6), F(4, 3)],
     grad=(0,))
case("atleast", lambda P, x: [P.atleast_1d(x), P.atleast_2d(x),
                              P.atleast_3d(x)], [F(3)])
case("tensordot", lambda P, a, b: P.tensordot(a, b, axes=[[1], [0]]),
     [F(2, 3), F(3, 4)], grad=(0, 1), tol=1e-5)
case("shard_index", lambda P, x: P.shard_index(x, 20, 2, 1), [I(6, hi=20)])
case("einsum", lambda P, a, b: P.einsum("ij,jk->ik", a, b),
     [F(2, 3), F(3, 4)], grad=(0, 1), tol=1e-5)

# ---- search ----
case("argmax", lambda P, x: P.argmax(x, axis=1), [F(3, 5)])
case("argmax_keep", lambda P, x: P.argmax(x, keepdim=True), [F(3, 5)])
case("argmin", lambda P, x: P.argmin(x, axis=0), [F(3, 5)])
case("argsort", lambda P, x: P.argsort(x, axis=1), [I(3, 6)])
case("argsort_desc", lambda P, x: P.argsort(x, descending=True),
     [F(3, 6)])
case("sort", lambda P, x: P.sort(x, axis=0, descending=True), [F(4, 3)],
     grad=(0,))
case("topk", lambda P, x: P.topk(x, 3), [I(2, 6)])
case("topk_small", lambda P, x: P.topk(x, 2, axis=0, largest=False),
     [F(5, 3)], grad=(0,))
case("kthvalue", lambda P, x: P.kthvalue(x, 2, axis=1), [F(3, 5)],
     grad=(0,))
case("mode", lambda P, x: P.mode(x, axis=1), [I(3, 7, hi=3)])
case("searchsorted", lambda P, s, v: P.searchsorted(s, v, right=True),
     [np.sort(F(8)), F(5)])
case("bucketize", lambda P, x, s: P.bucketize(x, s), [F(5), np.sort(F(6))])

# ---- indexing ----
case("getitem", lambda P, x: x[1:, ::2], [F(3, 5)], grad=(0,))
case("getitem_int_tensor", lambda P, x, i: x[i], [F(5, 3), I(4)],
     grad=(0,))


def _setitem(P, x, v):
    y = x * 1.0
    y[1] = v
    return y


# the JAX package's setitem loses gradients (its tape node loops onto the
# tensor it rebinds, and the rebound tensor keeps stop_gradient): values
# compare here, test_setitem_gradients holds the port's gradients
case("setitem", _setitem, [F(3, 4), F(4)])


def test_setitem_gradients():
    x = pt.to_tensor(F(3, 4), stop_gradient=False)
    v = pt.to_tensor(F(4), stop_gradient=False)
    y = _setitem(pt, x, v)
    y.sum().backward()
    expect = np.ones((3, 4), np.float32)
    expect[1] = 0.0
    np.testing.assert_array_equal(x.grad.numpy(), expect)
    np.testing.assert_array_equal(v.grad.numpy(), np.ones(4, np.float32))


def _run(P, fn, inputs, grad):
    ts = [P.to_tensor(x, stop_gradient=i not in grad)
          for i, x in enumerate(inputs)]
    return ts, fn(P, *ts)


def _grads(P, ts, out, grad, cots):
    loss = None
    for o, c in zip(_flat(out), cots):
        term = (o * P.to_tensor(c)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return [ts[i].grad for i in grad]


@pytest.mark.parametrize("fn,inputs,grad,tol", CASES)
def test_function_matches_jax(fn, inputs, grad, tol):
    jts, jout = _run(jp, fn, inputs, grad)
    tts, tout = _run(pt, fn, inputs, grad)
    _compare(tout, jout, tol)
    if grad:
        cots = [np.random.default_rng(7).standard_normal(
            _np(o).shape).astype(np.float32) for o in _flat(jout)]
        jg = _grads(jp, jts, jout, grad, cots)
        tg = _grads(pt, tts, tout, grad, cots)
        _compare(tg, jg, 1e-5)


def test_inplace_and_operator_methods_match_jax():
    x = F(3, 4)
    for P in (jp, pt):
        t = P.to_tensor(x)
        got = [t + 1.0, 2.0 - t, t * t, 1.0 / (t * t + 1.0), t ** 2.0,
               -t, abs(t), t @ P.to_tensor(x.T), t > 0.0, t <= 0.5,
               (t > 0) & (t < 1), ~(t > 0), t.astype("float32"),
               t.reshape([4, 3]), t.sum(axis=1), t.max(), t.transpose([1, 0]),
               t.clip(-0.5, 0.5), t.cumsum(axis=0), t.argmax(axis=1),
               t.topk(2)[0], t.mm(P.to_tensor(x.T)), t.rank()]
        inplace = t.clone()
        inplace.add_(1.0)
        inplace.scale_(2.0)
        inplace.clip_(-1.0, 5.0)
        got.append(inplace)
        if P is jp:
            ref = got
    _compare(got, ref)


# every name _install maps, checked by name on the port's Tensor
from paddle_tpu_torch.tensor import (_CREATION_METHODS,  # noqa: E402
                                     _INPLACE, _LINALG_METHODS,
                                     _MANIPULATION_METHODS, _MATH_METHODS,
                                     _SEARCH_METHODS)


@pytest.mark.parametrize("name", _MATH_METHODS + _MANIPULATION_METHODS
                         + _SEARCH_METHODS + _CREATION_METHODS
                         + [n + "_" for n in _INPLACE])
def test_tensor_method_installed(name):
    assert callable(getattr(PTensor, name))
    assert hasattr(jp.Tensor, name), name
    assert not hasattr(torch.Tensor, "astype")   # torch itself untouched


def test_later_slice_methods_raise_or_stay_torch():
    """The methods of tensor/extras.py were refused (``later_slice``) until
    their slice; now each is Paddle's where torch's Tensor lacks the name
    and torch's where it has it (the top-level function is Paddle's), as
    for linalg below. stft / istft stay torch's too."""
    from paddle_tpu_torch.tensor import extras

    t = pt.to_tensor(F(3, 3))
    for name in extras.__all__:
        if name in ("is_tensor", "block_diag"):
            continue
        if hasattr(torch.Tensor, name):
            assert getattr(pt.Tensor, name) is getattr(torch.Tensor, name)
        else:
            assert getattr(pt.Tensor, name) is getattr(extras, name)
            assert getattr(t, name).__self__ is t
    for name in ("stft", "istft"):
        assert getattr(pt.Tensor, name) is getattr(torch.Tensor, name)
    # the linalg methods are ported: Paddle's where torch's Tensor lacks
    # the name, torch's where it has it (paddle.linalg holds Paddle's)
    for name in _LINALG_METHODS:
        if hasattr(torch.Tensor, name):
            assert getattr(pt.Tensor, name) is getattr(torch.Tensor, name)
        else:
            assert getattr(pt.Tensor, name) is getattr(pt.linalg, name)
    w = pt.to_tensor(F(3, 3) + 3 * np.eye(3, dtype=np.float32))
    assert torch.allclose(w.inv() @ w, torch.eye(3), atol=1e-5)


def test_random_functions_shapes_ranges_and_seed():
    def draw():
        pt.seed(11)
        return [pt.rand([3, 4]), pt.randn([3, 4]), pt.standard_normal([2]),
                pt.normal(1.0, 2.0, [5]), pt.gaussian([4], 0.0, 1.0),
                pt.uniform([6], min=2.0, max=3.0),
                pt.randint(1, 5, [10]), pt.randperm(7),
                pt.multinomial(pt.to_tensor([0.2, 0.8]), 3, True),
                pt.bernoulli(pt.full([8], 0.5)), pt.poisson(pt.ones([4])),
                pt.binomial(pt.full([4], 5.0), pt.full([4], 0.5)),
                pt.rand_like(pt.ones([2, 2])), pt.randn_like(pt.ones([2])),
                pt.randint_like(pt.ones([3]), 0, 4)]
    a, b = draw(), draw()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[0].dtype == torch.float32 and list(a[0].shape) == [3, 4]
    assert 0 <= a[0].min() and a[0].max() < 1
    assert 2.0 <= a[5].min() and a[5].max() < 3.0
    assert a[6].dtype == torch.int64 and 1 <= a[6].min() and a[6].max() < 5
    assert sorted(a[7].tolist()) == list(range(7))
    x = pt.zeros([1000])
    for fn, args in ((pt.uniform_, (-1.0, 1.0)), (pt.normal_, (0.0, 1.0)),
                     (pt.exponential_, (2.0,)), (pt.bernoulli_, (0.3,))):
        fn(x, *args)
    assert abs(x.mean().item() - 0.3) < 0.06
    state = pt.get_rng_state()
    first = pt.rand([4])
    pt.set_rng_state(state)
    assert torch.equal(pt.rand([4]), first)


def test_op_sweep_symbols_covered():
    """The port's share of the JAX package's op-sweep checklist: each
    ``paddle:X`` symbol a function of the port's top level, each
    ``method:X`` a method of its Tensor (later slices' names raise and do
    not count)."""
    import op_sweep_specs as specs

    syms = {s for spec in specs.SPECS for s in spec.symbols
            if s.startswith(("paddle:", "method:"))}
    have = set()
    for s in syms:
        kind, name = s.split(":", 1)
        if kind == "paddle":
            try:
                ok = callable(getattr(pt, name))
            except (AttributeError, NotImplementedError):
                ok = False
        else:
            ok = name in PTensor.__dict__ and not getattr(
                PTensor.__dict__[name], "__name__", "").startswith("_later")
        if ok:
            have.add(s)
    print(f"op-sweep checklist: the port covers {len(have)} of {len(syms)} "
          f"paddle:/method: symbols")
    assert len(have) >= 390, len(have)
