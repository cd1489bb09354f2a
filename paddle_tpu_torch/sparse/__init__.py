"""Sparse tensors — port of ``paddle_tpu/sparse/__init__.py``.

:class:`SparseCooTensor` keeps ``indices`` [sparse_ndim, nnz] and
``values`` [nnz, *dense dims] as torch tensors on one device;
:class:`SparseCsrTensor` keeps ``crows``, ``cols`` and ``values`` and
converts through COO for compute, as in JAX. Duplicate indices add up
(BCOO's and ``torch.sparse_coo_tensor``'s meaning).

- :func:`matmul`: sparse @ dense through ``torch.sparse.mm`` on a
  ``torch.sparse_coo_tensor`` (cuSPARSE's SpMM on the card; JAX's BCOO
  ``dot_general`` is XLA, no Pallas kernel); dense @ sparse as the
  transpose of sparse.T @ dense.T.
- :func:`masked_matmul` (sampled dense-dense): JAX's gather of x's rows
  and y's columns at the mask's indices and a row dot, in chunks of
  indices so the gathered operands stay bounded.
- ``add`` / ``subtract`` take the union of the patterns (merged,
  duplicates summed, sorted row-major: :func:`coalesce`; JAX keeps a
  padded fixed size, which densifies the same); ``multiply`` / ``divide``
  evaluate on x's pattern; the unaries act on the values; :func:`softmax`
  normalises each row over its stored entries.

Values go through the op dispatcher, so autograd reaches them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.op_registry import apply_fn
from ..core.tensor import unwrap
from ..device import resolve_device

__all__ = [
    "SparseCooTensor", "SparseCsrTensor", "sparse_coo_tensor",
    "sparse_csr_tensor", "matmul", "masked_matmul", "add", "subtract",
    "multiply", "divide", "is_same_shape", "transpose", "coalesce",
    "sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh",
    "sqrt", "square", "log1p", "abs", "pow", "neg", "expm1", "relu",
    "relu6", "leaky_relu", "softmax", "cast", "nn",
]

# indices gathered a step by masked_matmul (bounds its two gathers)
_SDDMM_CHUNK = 1 << 14


def _dev_tensor(x, device, dtype=None):
    """``x`` as a plain tensor on ``device`` (in ``dtype``); array data as
    ``to_tensor`` takes it (float64 becomes float32)."""
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype) if dtype is not None \
            else x.to(device)
    from ..tensor.creation import to_tensor

    return unwrap(to_tensor(x, dtype=dtype, place=device))


class SparseCooTensor:
    """COO sparse tensor: ``indices`` [sparse_ndim, nnz] (int64),
    ``values`` [nnz, *dense dims], ``shape``."""

    def __init__(self, indices, values, shape):
        self.indices = indices
        self.values = values
        self._shape = [int(s) for s in shape]

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def ndim(self):
        return len(self._shape)

    def nnz(self):
        return int(self.values.shape[0])

    def is_sparse_coo(self):
        return True

    def is_sparse_csr(self):
        return False

    def _sparse_nd(self):
        return int(self.indices.shape[0])

    def to_dense(self):
        shape = tuple(self._shape)
        nd = self._sparse_nd()

        def fn(idx, vals):
            dense = torch.zeros(shape[:nd] + tuple(vals.shape[1:]),
                                dtype=vals.dtype, device=vals.device)
            return dense.index_put(tuple(idx), vals, accumulate=True)

        return apply_fn("sparse_to_dense", fn, self.indices, self.values)

    def to_sparse_csr(self) -> "SparseCsrTensor":
        if len(self._shape) != 2:
            raise ValueError("to_sparse_csr supports 2-D tensors")
        t = coalesce(self)
        rows = t.indices[0]
        counts = torch.bincount(rows, minlength=self._shape[0])
        crows = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        return SparseCsrTensor(crows, t.indices[1], t.values, self._shape)

    def values_tensor(self):
        return self.values

    def _replace_values(self, new_values) -> "SparseCooTensor":
        return SparseCooTensor(self.indices, new_values, self._shape)

    def _torch(self, values=None):
        """A ``torch.sparse_coo_tensor`` of this tensor (``values`` in
        place of its own)."""
        return torch.sparse_coo_tensor(
            self.indices, self.values if values is None else values,
            self._shape, check_invariants=False)

    def __repr__(self):
        return (f"SparseCooTensor(shape={self._shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


class SparseCsrTensor:
    """CSR sparse tensor: ``crows`` [rows + 1], ``cols`` [nnz],
    ``values`` [nnz]."""

    def __init__(self, crows, cols, values, shape):
        self.crows = crows
        self.cols = cols
        self.values = values
        self._shape = [int(s) for s in shape]

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self.values.dtype

    def nnz(self):
        return int(self.values.shape[0])

    def is_sparse_coo(self):
        return False

    def is_sparse_csr(self):
        return True

    def to_sparse_coo(self, sparse_dim=2) -> SparseCooTensor:
        crows = self.crows.long()
        rows = torch.repeat_interleave(
            torch.arange(crows.shape[0] - 1, device=crows.device),
            crows.diff())
        return SparseCooTensor(torch.stack([rows, self.cols.long()]),
                               self.values, self._shape)

    def to_dense(self):
        return self.to_sparse_coo().to_dense()

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self._shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


_SPARSE = (SparseCooTensor, SparseCsrTensor)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def _place(values, place):
    if place is not None:
        return resolve_device(getattr(place, "device", place)
                              if not isinstance(place, str) else place)
    if isinstance(values, torch.Tensor):
        return values.device
    return resolve_device()


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True):
    """A COO tensor on ``place`` (default: the values' device, else the
    current place); ``shape`` defaults to the largest index + 1 a sparse
    axis (a host read) and the values' dense dims."""
    dev = _place(values, place)
    from ..core.dtype import convert_dtype

    vals = _dev_tensor(values, dev, convert_dtype(dtype))
    idx = _dev_tensor(indices, dev, torch.int64)
    if shape is None:
        shape = ((idx.amax(dim=1) + 1).tolist()
                 + list(vals.shape[1:]))
    if not stop_gradient and vals.is_floating_point():
        vals.requires_grad_(True)
    return SparseCooTensor(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    """A CSR tensor on ``place`` (default: the values' device, else the
    current place)."""
    dev = _place(values, place)
    from ..core.dtype import convert_dtype

    vals = _dev_tensor(values, dev, convert_dtype(dtype))
    if not stop_gradient and vals.is_floating_point():
        vals.requires_grad_(True)
    return SparseCsrTensor(_dev_tensor(crows, dev, torch.int64),
                           _dev_tensor(cols, dev, torch.int64), vals, shape)


def _coo(x) -> SparseCooTensor:
    return x.to_sparse_coo() if isinstance(x, SparseCsrTensor) else x


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _linear_key(idx, shape):
    key = torch.zeros_like(idx[0])
    for ax in range(idx.shape[0]):
        key = key * shape[ax] + idx[ax]
    return key


def _merge(idx, vals, shape):
    """Duplicate indices summed, sorted row-major: (indices, values)."""
    key = _linear_key(idx, shape)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    new_idx = torch.stack(torch.unravel_index(
        uniq, tuple(shape[:idx.shape[0]])))
    summed = apply_fn(
        "sparse_coalesce",
        lambda v: v.new_zeros((uniq.shape[0],) + tuple(v.shape[1:]))
        .index_add(0, inv, v), vals)
    return new_idx, summed


def coalesce(x) -> SparseCooTensor:
    """Merge duplicate indices (their values summed), sorted row-major."""
    x = _coo(x)
    idx, vals = _merge(x.indices, x.values, x._shape)
    return SparseCooTensor(idx, vals, x._shape)


def transpose(x, perm):
    x = _coo(x)
    return SparseCooTensor(x.indices[list(perm)], x.values,
                           [x.shape[p] for p in perm])


def is_same_shape(x, y) -> bool:
    return list(x.shape) == list(y.shape)


def cast(x, index_dtype=None, value_dtype=None):
    from ..core.dtype import convert_dtype

    x = _coo(x)
    idx = (x.indices if index_dtype is None
           else x.indices.to(convert_dtype(index_dtype)))
    vals = (x.values if value_dtype is None
            else x.values.to(convert_dtype(value_dtype)))
    return SparseCooTensor(idx, vals, x.shape)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def matmul(x, y):
    """sparse @ dense -> dense (``torch.sparse.mm``); dense @ sparse and
    sparse @ sparse (the second densified) through the same product."""
    if isinstance(x, _SPARSE):
        xc = _coo(x)
        yv = y.to_dense() if isinstance(y, _SPARSE) else y

        def fn(vals, d):
            return torch.sparse.mm(xc._torch(vals), d)

        return apply_fn("sparse_matmul", fn, xc.values, yv)
    if isinstance(y, _SPARSE):
        yt = transpose(_coo(y), [1, 0])
        return matmul(yt, x.t()).t()
    return torch.matmul(x, y)


def masked_matmul(x, y, mask):
    """(x @ y) at ``mask``'s indices, as a COO tensor of its pattern: for
    each index (r, c), x[r] . y[:, c]."""
    mask = _coo(mask)
    rows, cols = mask.indices[0], mask.indices[1]

    def fn(xd, yd):
        yt = yd.t()
        out = []
        for s in range(0, rows.shape[0], _SDDMM_CHUNK):
            r, c = rows[s:s + _SDDMM_CHUNK], cols[s:s + _SDDMM_CHUNK]
            out.append(torch.einsum("nk,nk->n", xd[r], yt[c]))
        return torch.cat(out) if out else xd.new_zeros((0,))

    vals = apply_fn("masked_matmul", fn, x, y)
    return SparseCooTensor(mask.indices, vals, mask.shape)


# ---------------------------------------------------------------------------
# binary value ops
# ---------------------------------------------------------------------------

def _union_binary(name, negate):
    def f(x, y):
        if isinstance(x, _SPARSE) and isinstance(y, _SPARSE):
            xc, yc = _coo(x), _coo(y)
            yv = apply_fn("neg", torch.neg, yc.values) if negate \
                else yc.values
            idx = torch.cat([xc.indices, yc.indices], dim=1)
            vals = torch.cat([xc.values, yv], dim=0)
            idx, vals = _merge(idx, vals, xc._shape)
            return SparseCooTensor(idx, vals, xc._shape)
        xd = x.to_dense() if isinstance(x, _SPARSE) else x
        yd = y.to_dense() if isinstance(y, _SPARSE) else y
        return apply_fn(name, torch.sub if negate else torch.add, xd, yd)

    f.__name__ = name
    f.__doc__ = (f"x {'-' if negate else '+'} y: two sparse tensors give "
                 f"the union of their patterns, coalesced; otherwise dense.")
    return f


def _pattern_binary(name, op):
    def f(x, y):
        if isinstance(x, _SPARSE) and isinstance(y, _SPARSE):
            xc, yc = _coo(x), _coo(y)
            yd = yc.to_dense()

            def fn(xv, ydd):
                return op(xv, ydd[tuple(xc.indices)])

            vals = apply_fn(f"sparse_{name}", fn, xc.values, yd)
            return SparseCooTensor(xc.indices, vals, xc._shape)
        xd = x.to_dense() if isinstance(x, _SPARSE) else x
        yd = y.to_dense() if isinstance(y, _SPARSE) else y
        return apply_fn(name, op, xd, yd)

    f.__name__ = name
    f.__doc__ = (f"x {name} y on x's pattern when both are sparse (y read "
                 f"at x's indices); otherwise dense.")
    return f


add = _union_binary("add", negate=False)
subtract = _union_binary("subtract", negate=True)
multiply = _pattern_binary("multiply", torch.mul)
divide = _pattern_binary("divide", torch.div)


# ---------------------------------------------------------------------------
# unary value ops (zero-preserving: the values only)
# ---------------------------------------------------------------------------

def _unary(name, fn):
    def f(x):
        if isinstance(x, _SPARSE):
            new_vals = apply_fn(f"sparse_{name}", fn, x.values)
            if isinstance(x, SparseCsrTensor):
                return SparseCsrTensor(x.crows, x.cols, new_vals, x.shape)
            return x._replace_values(new_vals)
        return apply_fn(name, fn, x)

    f.__name__ = name
    return f


sin = _unary("sin", torch.sin)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
atanh = _unary("atanh", torch.atanh)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
log1p = _unary("log1p", torch.log1p)
abs = _unary("abs", torch.abs)
neg = _unary("neg", torch.neg)
expm1 = _unary("expm1", torch.expm1)
relu = _unary("relu", F.relu)
relu6 = _unary("relu6", lambda a: a.clamp(0, 6))


def leaky_relu(x, negative_slope=0.01):
    return _unary("leaky_relu", lambda a: torch.where(
        a >= 0, a, negative_slope * a))(x)


def pow(x, factor):
    return _unary("pow", lambda a: torch.pow(a, factor))(x)


def softmax(x, axis=-1):
    """Row-wise softmax over each row's stored entries (2-D, last axis);
    a dense tensor takes ``nn.functional.softmax``."""
    if not isinstance(x, _SPARSE):
        from ..nn import functional as PF

        return PF.softmax(x, axis=axis)
    xc = _coo(x)
    if len(xc.shape) != 2 or axis not in (-1, 1):
        raise ValueError("sparse softmax supports 2-D tensors over the last "
                         "axis")
    n_rows = xc.shape[0]
    rows = xc.indices[0]

    def fn(vals):
        row_max = vals.new_full((n_rows,), float("-inf")).scatter_reduce(
            0, rows, vals, "amax")
        e = torch.exp(vals - row_max[rows])
        denom = vals.new_zeros((n_rows,)).index_add(0, rows, e)
        return e / denom[rows]

    return xc._replace_values(apply_fn("sparse_softmax", fn, xc.values))


class nn:
    """sparse.nn layers."""

    class ReLU:
        def __call__(self, x):
            return relu(x)

    class LeakyReLU:
        def __init__(self, negative_slope=0.01):
            self.negative_slope = negative_slope

        def __call__(self, x):
            return leaky_relu(x, self.negative_slope)

    class Softmax:
        def __init__(self, axis=-1):
            self.axis = axis

        def __call__(self, x):
            return softmax(x, self.axis)
