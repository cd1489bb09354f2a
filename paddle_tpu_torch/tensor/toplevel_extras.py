"""The rest of Paddle's top level — port of ``paddle_tpu/tensor/
toplevel_extras.py``: ``iinfo`` / ``finfo`` over Paddle dtype names, the
float8 dtypes, ``mm``, ``pdist``, the stack family, ``cartesian_prod``,
``combinations``, the samplers ``log_normal`` / ``standard_gamma``, small
helpers (``shape``, ``rank``, ``check_shape`` ...), the CUDA RNG state and
the in-place family.

The in-place family is JAX's ``INPLACE_BASES`` (68 names) plus ``where_``
and the random fills ``log_normal_``, ``cauchy_`` and ``geometric_``. Each
``<op>_`` runs the op and writes its result into ``x`` through
``tensor._inplace`` (torch's autograd records an in-place copy; a result of
another shape or dtype replaces x's data, which torch allows only outside
autograd). ``where_(condition, x, y)`` writes into ``x``, not into the
condition. The fills draw from the port's global generator of ``x``'s
device and drop ``x``'s history, as JAX's ``_replace_`` does;
``geometric_`` is continuous, ``log(u) / log1p(-p)`` with no floor, as in
JAX (torch's own ``Tensor.geometric_`` is the discrete one).
"""

from __future__ import annotations

import itertools as _it

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.op_registry import apply_fn
from ..core.tensor import Tensor, unwrap
from ..device import CUDAPinnedPlace, resolve_place  # noqa: F401
from ..framework.random import generator

__all__ = [
    "iinfo", "finfo", "dtype", "float8_e4m3fn", "float8_e5m2",
    "mm", "pdist", "hstack", "vstack", "dstack", "column_stack", "row_stack",
    "cartesian_prod", "combinations", "log_normal", "standard_gamma",
    "shape", "tolist", "is_grad_enabled", "rank", "LazyGuard", "check_shape",
    "disable_signal_handler", "get_cuda_rng_state", "set_cuda_rng_state",
    "CUDAPinnedPlace", "batch",
]

# dtype objects (reference: paddle.dtype + float8 members)
dtype = torch.dtype
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2


def iinfo(dt):
    return torch.iinfo(dtype_mod.convert_dtype(dt))


def finfo(dt):
    return torch.finfo(dtype_mod.convert_dtype(dt))


def mm(input, mat2, name=None):
    from .math import matmul

    return matmul(input, mat2)


def pdist(x, p=2.0, name=None):
    """Pairwise distances of rows, the condensed upper triangle. Only the
    pairs are formed: the JAX function takes the norms of the full matrix,
    whose zero diagonal makes every gradient nan."""
    from .extras import _pnorm

    def fn(a):
        n = a.shape[0]
        iu = torch.triu_indices(n, n, 1, device=a.device)
        return _pnorm(a[iu[0]] - a[iu[1]], p, -1)

    return apply_fn("pdist", fn, x)


def _tensors(x):
    from .creation import to_tensor

    return [t if isinstance(t, torch.Tensor) else to_tensor(t) for t in x]


def _stack_family(op_name, fn):
    def f(x, name=None):
        return apply_fn(op_name, lambda *a: fn(a), *_tensors(x))

    f.__name__ = op_name
    return f


hstack = _stack_family("hstack", torch.hstack)
vstack = _stack_family("vstack", torch.vstack)
dstack = _stack_family("dstack", torch.dstack)
column_stack = _stack_family("column_stack", torch.column_stack)
row_stack = vstack  # reference alias


def cartesian_prod(x, name=None):
    """Cartesian product of 1-D tensors, [prod(n_i), len(x)] (one input
    gives [n, 1], as JAX's)."""
    def fn(*arrs):
        grids = torch.meshgrid(*arrs, indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)

    return apply_fn("cartesian_prod", fn, *_tensors(x))


def combinations(x, r=2, with_replacement=False, name=None):
    """r-combinations of a 1-D tensor's elements, [count, r]."""
    def fn(a):
        n = a.shape[0]
        it = (_it.combinations_with_replacement(range(n), r)
              if with_replacement else _it.combinations(range(n), r))
        idx = np.array(list(it), np.int64).reshape(-1, r)
        return a[torch.as_tensor(idx, device=a.device)]

    return apply_fn("combinations", fn, x)


def _dt(dtype):
    return dtype_mod.convert_dtype(dtype) or dtype_mod.get_default_dtype()


def log_normal(mean=1.0, std=2.0, shape=None, dtype=None, name=None):
    """Log-normal samples exp(N(mean, std)) on the current place."""
    dev = resolve_place()
    shp = tuple(int(unwrap(s)) for s in (shape or [1]))
    z = torch.empty(shp, dtype=torch.float32, device=dev).normal_(
        generator=generator(dev))
    return torch.exp(z * std + mean).to(_dt(dtype)).as_subclass(Tensor)


def standard_gamma(alpha, name=None):
    from .creation import to_tensor

    a = alpha if isinstance(alpha, torch.Tensor) else to_tensor(
        np.asarray(alpha, np.float32))
    return apply_fn("standard_gamma", lambda t: torch._standard_gamma(
        t, generator=generator(t.device)), a)


def shape(input):
    """The shape as an int32 tensor on the current place."""
    return torch.tensor(list(unwrap(input).shape), dtype=torch.int32,
                        device=resolve_place()).as_subclass(Tensor)


def tolist(x):
    return x.tolist() if isinstance(x, torch.Tensor) else \
        np.asarray(x).tolist()


def is_grad_enabled():
    from ..core import autograd_engine

    return autograd_engine.grad_enabled()


def rank(input):
    """The rank (ndim) as a 0-dim int32 tensor on the current place."""
    return torch.tensor(unwrap(input).ndim, dtype=torch.int32,
                        device=resolve_place()).as_subclass(Tensor)


class LazyGuard:
    """Deferred-init guard (reference: LazyGuard). Initialization is eager
    here, as in the JAX package; the guard is a no-op context."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def check_shape(x, expected):
    got = list(unwrap(x).shape)
    exp = [int(s) if s is not None else None for s in expected]
    if len(got) != len(exp):
        raise ValueError(f"rank mismatch: got {got}, expected {exp}")
    for g, e in zip(got, exp):
        if e is not None and e != -1 and g != e:
            raise ValueError(f"shape mismatch: got {got}, expected {exp}")
    return True


def disable_signal_handler():
    pass  # no native signal handlers installed


def get_cuda_rng_state():
    """The states of the port's global generators of every card (empty
    without one)."""
    if not torch.cuda.is_available():
        return []
    return [generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state):
    for i, s in enumerate(state or []):
        generator(torch.device("cuda", i)).set_state(s)


def batch(reader, batch_size, drop_last=False):
    """Deprecated reader decorator (reference: paddle.batch)."""

    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


# ---------------------------------------------------------------------------
# the in-place family
# ---------------------------------------------------------------------------

# base names whose name_ form the reference exports at top level (JAX
# toplevel_extras.py INPLACE_BASES; where_ is separate: its target is x)
INPLACE_BASES = [
    "addmm", "t", "cumsum", "cumprod", "logit", "equal", "cos",
    "tan", "unsqueeze", "logical_and", "less_than", "squeeze", "floor_divide",
    "remainder", "logical_or", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "less_equal", "triu", "sin", "mod", "abs", "tril", "pow",
    "acos", "expm1", "sinh", "sinc", "neg", "lgamma", "gammaincc", "gammainc",
    "square", "divide", "gammaln", "atan", "gcd", "lcm", "cast",
    "greater_equal", "erf", "greater_than", "tanh", "transpose", "flatten",
    "multiply", "logical_not", "log", "log2", "log10", "trunc", "frac",
    "digamma", "renorm", "multigammaln", "nan_to_num", "ldexp", "i0",
    "polygamma", "copysign", "bitwise_left_shift", "bitwise_right_shift",
    "masked_fill", "masked_scatter", "hypot", "floor_mod",
]


def _random_fill(name, sampler):
    """``x.<name>(...)``: x overwritten (no history) with samples of its
    shape drawn on its device."""
    def f(x, *args, **kwargs):
        kwargs.pop("name", None)
        a = unwrap(x)
        new = sampler(a, generator(a.device), *args, **kwargs)
        with torch.no_grad():
            a.copy_(new.to(a.dtype))
        return x

    f.__name__ = name
    return f


def _uniform(a, gen, low=0.0):
    return torch.empty(a.shape, dtype=torch.float32, device=a.device
                       ).uniform_(low, 1.0, generator=gen)


def _normal(a, gen):
    return torch.empty(a.shape, dtype=torch.float32, device=a.device
                       ).normal_(generator=gen)


log_normal_ = _random_fill(
    "log_normal_", lambda a, gen, mean=1.0, std=2.0: torch.exp(
        _normal(a, gen) * std + mean))

cauchy_ = _random_fill(
    "cauchy_", lambda a, gen, loc=0.0, scale=1.0: loc + scale * torch.tan(
        torch.pi * (_uniform(a, gen) - 0.5)))


def _geometric_sample(a, gen, probs):
    # continuous log(u) / log1p(-p), the reference's
    # x.uniform_().log_().divide_(log1p(-p)) with no floor (JAX's)
    p = unwrap(probs)
    p = p.to(a.device).float() if isinstance(p, torch.Tensor) else \
        torch.tensor(float(p), device=a.device)
    return torch.log(_uniform(a, gen, 1e-7)) / torch.log1p(-p)


geometric_ = _random_fill("geometric_", _geometric_sample)


def where_(condition, x, y, name=None):
    """In-place where: x receives where(condition, x, y) (the target is x,
    not the first positional argument)."""
    from . import _inplace
    from .manipulation import where as _where

    return _inplace(lambda xx, c, yy: _where(c, xx, yy), "where_")(
        x, condition, y)


def inplace_variants(namespace):
    """{<op>_: function} for every base of INPLACE_BASES in ``namespace``,
    plus where_ and the random fills."""
    from . import _inplace

    out = {base + "_": _inplace(namespace[base], base + "_")
           for base in INPLACE_BASES}
    out.update(log_normal_=log_normal_, cauchy_=cauchy_,
               geometric_=geometric_, where_=where_)
    return out
