"""Tensor op namespaces and the method table of the port's ``Tensor`` —
port of ``paddle_tpu/tensor/__init__.py``.

``_install`` puts the JAX package's operators and methods on the port's
``Tensor`` class (never on ``torch.Tensor``): ``x + y``, ``x @ w`` (through
``math.matmul``, so it is white under AMP, as in JAX), comparisons,
``x[i]`` / ``x[i] = v`` through the dispatcher, and the functions of
``creation``, ``math``, ``manipulation`` and ``search`` as methods
(``x.reshape([2, 3])``, ``x.sum(axis=1)``, ``x.astype("bfloat16")``).
Those methods take Paddle's arguments, so a name torch also has
(``reshape``, ``sum``, ``transpose`` ...) has Paddle's meaning on a Paddle
tensor; ``numel``, ``size``, ``dim``, ``to``, ``cuda`` and ``cpu`` stay
torch's. The methods of ``tensor/linalg.py`` and ``tensor/extras.py`` are
installed where ``torch.Tensor`` lacks the name; where it has it
(``diff``, ``unfold``, ``renorm``, ``frexp``, ``polygamma``, ``logit``,
``inverse``, ``as_strided``, ``tensor_split``, ``stft`` ...) torch's method
stays and the top-level function is Paddle's. The in-place family
(``toplevel_extras.INPLACE_BASES``, the random fills) is Paddle's on the
Tensor and at the top level alike.
"""

from __future__ import annotations

import builtins

import torch

from ..core.op_registry import apply_fn
from ..core.tensor import Tensor, unwrap
from . import creation, extras, linalg, manipulation, math, random, search
from . import toplevel_extras
from .creation import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .toplevel_extras import *  # noqa: F401,F403


def einsum(equation, *operands):
    """paddle.einsum (reference: python/paddle/tensor/einsum.py), a neutral
    op as in the JAX package."""
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply_fn("einsum", lambda *ops: torch.einsum(equation, *ops),
                    *operands)


def _index_prepare(item):
    if isinstance(item, tuple):
        return tuple(unwrap(i) for i in item)
    if isinstance(item, list):
        return [unwrap(i) for i in item]
    return unwrap(item)


def _getitem(self, item):
    idx = _index_prepare(item)
    return apply_fn("getitem", lambda a: torch.Tensor.__getitem__(a, idx),
                    self)


def _setitem(self, item, value):
    """``self[item] = value`` in place (torch's autograd records it, as the
    JAX package rebinds the handle to the updated array)."""
    idx = _index_prepare(item)
    v = unwrap(value)
    apply_fn("setitem", lambda a: torch.Tensor.__setitem__(a, idx, v), self)


def _iter(self):
    for i in range(self.shape[0]):
        yield self[i]


# the JAX package's method list (paddle_tpu/tensor/__init__.py :120-148)
_MATH_METHODS = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "maximum", "minimum", "fmax", "fmin", "exp", "expm1",
    "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "abs", "sign", "neg",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "ceil", "floor", "round", "trunc", "frac",
    "reciprocal", "square", "sigmoid", "erf", "erfinv", "lgamma", "digamma",
    "isnan", "isinf", "isfinite", "nan_to_num", "clip", "scale", "lerp",
    "matmul", "inner", "outer", "kron", "sum", "mean", "max", "min", "amax",
    "amin", "prod", "logsumexp", "all", "any", "cumsum", "cumprod", "cummax",
    "cummin", "nansum", "nanmean", "count_nonzero", "trace", "diagonal",
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "std", "var", "median", "nanmedian",
    "quantile", "histogram", "bincount", "atan2", "heaviside", "deg2rad",
    "rad2deg", "angle", "conj", "real", "imag", "logaddexp",
]
_MANIPULATION_METHODS = [
    "reshape", "reshape_", "flatten", "squeeze", "unsqueeze", "transpose",
    "t", "moveaxis", "swapaxes", "split", "chunk", "unbind", "tile",
    "expand", "expand_as", "broadcast_to", "flip", "rot90", "roll", "cast",
    "gather", "gather_nd", "scatter", "scatter_", "scatter_nd_add",
    "index_select", "index_sample", "index_add", "masked_select",
    "masked_fill", "take_along_axis", "put_along_axis", "take",
    "repeat_interleave", "unique", "unique_consecutive", "where", "nonzero",
    "as_real", "as_complex", "tensordot", "view", "view_as", "pad",
]
_SEARCH_METHODS = ["argmax", "argmin", "argsort", "sort", "topk",
                   "kthvalue", "mode", "searchsorted", "bucketize"]
_CREATION_METHODS = ["tril", "triu", "diag"]
# the JAX list's linalg methods (:136-137) and the four linalg names of its
# extras: installed where torch.Tensor lacks the name
_LINALG_METHODS = [
    "dot", "bmm", "mv", "norm", "cholesky", "qr", "svd", "inv", "pinv",
    "det", "slogdet", "solve", "triangular_solve", "matrix_power", "cross",
    "cholesky_inverse", "lu_unpack", "ormqr", "svd_lowrank"]
# in-place variants of the JAX package's list (:160-162)
_INPLACE = ["add", "subtract", "multiply", "divide", "clip", "scale", "exp",
            "sqrt", "rsqrt", "floor", "ceil", "round", "reciprocal", "tanh",
            "sigmoid", "cast", "flatten", "squeeze", "unsqueeze",
            "transpose", "abs"]


def _inplace(fn, name):
    """``x.<op>_(...)``: the op's result written into x, recorded by
    torch's autograd as an in-place copy. A result of another shape or
    dtype replaces x's data, which torch allows only outside autograd."""
    def method(self, *args, **kwargs):
        # in a graph the op runs on a copy of x: its backward may save x,
        # which the write below changes
        graph = torch.is_grad_enabled() and builtins.any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in (self,) + args)
        src = self.clone() if graph else self
        out = unwrap(fn(src, *args, **kwargs))
        if tuple(out.shape) == tuple(self.shape) and out.dtype == self.dtype:
            unwrap(self).copy_(out)
        elif self.requires_grad:
            raise RuntimeError(f"{name} changes the shape or dtype of a "
                               f"tensor that requires grad: torch cannot do "
                               f"that in place")
        else:
            self.data = out
        return self

    method.__name__ = name
    return method


def _install():
    T = Tensor
    M = math
    T.__add__ = lambda s, o: M.add(s, o)
    T.__radd__ = lambda s, o: M.add(o, s)
    T.__sub__ = lambda s, o: M.subtract(s, o)
    T.__rsub__ = lambda s, o: M.subtract(o, s)
    T.__mul__ = lambda s, o: M.multiply(s, o)
    T.__rmul__ = lambda s, o: M.multiply(o, s)
    T.__truediv__ = lambda s, o: M.divide(s, o)
    T.__rtruediv__ = lambda s, o: M.divide(o, s)
    T.__floordiv__ = lambda s, o: M.floor_divide(s, o)
    T.__mod__ = lambda s, o: M.mod(s, o)
    T.__pow__ = lambda s, o: M.pow(s, o)
    T.__rpow__ = lambda s, o: M.pow(o, s)
    T.__neg__ = lambda s: M.neg(s)
    T.__abs__ = lambda s: M.abs(s)
    T.__matmul__ = lambda s, o: M.matmul(s, o)
    T.__rmatmul__ = lambda s, o: M.matmul(o, s)
    T.__eq__ = lambda s, o: M.equal(s, o)
    T.__ne__ = lambda s, o: M.not_equal(s, o)
    T.__lt__ = lambda s, o: M.less_than(s, o)
    T.__le__ = lambda s, o: M.less_equal(s, o)
    T.__gt__ = lambda s, o: M.greater_than(s, o)
    T.__ge__ = lambda s, o: M.greater_equal(s, o)
    # __eq__ defined on the class would otherwise make it unhashable; the
    # optimizers key their state by parameter
    T.__hash__ = torch.Tensor.__hash__
    T.__invert__ = lambda s: (M.logical_not(s) if s.dtype == torch.bool
                              else M.bitwise_not(s))
    T.__and__ = lambda s, o: (M.logical_and(s, o) if s.dtype == torch.bool
                              else M.bitwise_and(s, o))
    T.__or__ = lambda s, o: (M.logical_or(s, o) if s.dtype == torch.bool
                             else M.bitwise_or(s, o))
    T.__xor__ = lambda s, o: (M.logical_xor(s, o) if s.dtype == torch.bool
                              else M.bitwise_xor(s, o))
    T.__getitem__ = _getitem
    T.__setitem__ = _setitem
    T.__iter__ = _iter

    for mod, names in ((math, _MATH_METHODS),
                       (manipulation, _MANIPULATION_METHODS),
                       (search, _SEARCH_METHODS),
                       (creation, _CREATION_METHODS)):
        for name in names:
            setattr(T, name, getattr(mod, name))
    for name in _LINALG_METHODS:
        if not hasattr(torch.Tensor, name):
            setattr(T, name, getattr(linalg, name))
    for name in extras.__all__:
        if name not in ("is_tensor", "block_diag") \
                and not hasattr(torch.Tensor, name):
            setattr(T, name, getattr(extras, name))
    for name in _INPLACE:
        setattr(T, name + "_", _inplace(getattr(Tensor, name), name + "_"))
    for name, fn in _INPLACE_FAMILY.items():
        if name != "where_":
            setattr(T, name, fn)
    T.astype = lambda s, dtype: manipulation.cast(s, dtype)
    T.mm = math.matmul
    T.zero_ = lambda s: s.set_value(torch.zeros_like(unwrap(s)))
    T.fill_ = lambda s, v: s.set_value(torch.full_like(unwrap(s), v))
    T.rank = lambda s: s.ndim


# the in-place family as top-level functions (and Tensor methods, above)
_INPLACE_FAMILY = toplevel_extras.inplace_variants(globals())
globals().update(_INPLACE_FAMILY)
_install()
