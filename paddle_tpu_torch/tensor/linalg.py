"""Linear algebra — port of ``paddle_tpu/tensor/linalg.py`` (``paddle.linalg``)
and the four functions it re-exports from ``tensor/extras.py``
(``cholesky_inverse``, ``lu_unpack``, ``ormqr``, ``svd_lowrank``).

Each function goes through the op dispatcher under the JAX package's op
name; ``bmm``, ``mv`` and ``multi_dot`` under its white ``OpDef("matmul")``
(:11), the rest neutral (``dot`` has no OpDef, :14-15). The JAX package
calls ``jnp.linalg`` / ``jax.scipy.linalg`` (XLA's decompositions, no
Pallas kernel); the port calls ``torch.linalg`` (cuSOLVER and cuBLAS on
the card, which have no bf16: the decompositions take fp32 or fp64).
Results keep JAX's conventions: ``svd`` returns V (not V^H), ``slogdet``
the stacked [sign, log|det|], ``lu`` 1-based pivots, ``cross(axis=9)``
the first axis of size 3, ``lstsq`` JAX's SVD solution with its rank,
residuals and singular values, ``pca_lowrank`` a full (deterministic) SVD.

Where the JAX package ignores an argument the port gives Paddle's meaning
from torch's one call: ``cov``'s ``fweights`` / ``aweights``,
``matrix_rank``'s ``hermitian``, ``lu``'s ``get_infos`` (LAPACK's info,
where JAX returns zeros). ``svd_lowrank`` draws its Gaussian sketch from
the port's generator of the input's device. ``fp8_fp8_half_gemm_fused``
casts both operands to float8_e4m3fn as JAX's XLA cast does (an element
beyond +-464 becomes NaN; torch's cast saturates at 448) and multiplies
with an fp32 accumulator: on the card through ``torch._scaled_mm`` (2-D
operands whose inner and output widths are multiples of 16), else as an
fp32 matmul of the cast values.
"""

from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ..core.op_registry import AMP_WHITE, OpDef, apply_fn
from ..core.tensor import unwrap
from ..framework.random import generator as global_generator

__all__ = [
    "dot", "bmm", "mv", "norm", "vector_norm", "matrix_norm", "cond",
    "cholesky", "cholesky_solve", "qr", "svd", "svdvals", "pca_lowrank",
    "inv", "pinv", "det", "slogdet", "solve", "triangular_solve", "lstsq",
    "lu", "matrix_power", "matrix_rank", "eig", "eigh", "eigvals",
    "eigvalsh", "cross", "householder_product", "corrcoef", "cov",
    "multi_dot", "matrix_exp", "fp8_fp8_half_gemm_fused",
    "cholesky_inverse", "lu_unpack", "ormqr", "svd_lowrank",
]

_MM = OpDef("matmul", None, amp=AMP_WHITE)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _ord(p):
    if p in ("inf", float("inf")):
        return float("inf")
    if p in ("-inf", -float("inf")):
        return -float("inf")
    return p


def dot(x, y, name=None):
    return apply_fn("dot", lambda a, b: torch.sum(a * b, -1), x, y)


def bmm(x, y, name=None):
    return apply_fn("bmm", torch.matmul, x, y, _opdef=_MM)


def mv(x, vec, name=None):
    return apply_fn("mv", torch.matmul, x, vec, _opdef=_MM)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """Paddle's ``norm``: ``p`` None / "fro" (over everything when
    ``axis`` is None, keepdim then ignored, as in JAX), "nuc", a number or
    "inf" / "-inf"; ``axis`` an int (vector norm) or a pair (matrix
    norm); with a number and no axis, the vector norm of the flattened
    input."""
    def fn(a):
        if p is None or p == "fro":
            if axis is None:
                return torch.sqrt(torch.sum(torch.square(a)))
            return torch.linalg.norm(a, None, _axes(axis), keepdim)
        if axis is None:
            return torch.linalg.norm(a.reshape(-1), _ord(p), 0, keepdim)
        return torch.linalg.norm(a, _ord(p), _axes(axis), keepdim)

    return apply_fn("norm", fn, x)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    """The vector p-norm over ``axis`` (all of x when None). Over two axes
    it stays a vector norm (Paddle's), where JAX's ``jnp.linalg.norm``
    takes the matrix norm of that order."""
    def fn(a):
        if axis is None:
            return torch.linalg.vector_norm(a.reshape(-1), _ord(p), 0,
                                            keepdim)
        return torch.linalg.vector_norm(a, _ord(p), _axes(axis), keepdim)

    return apply_fn("vector_norm", fn, x)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return apply_fn("matrix_norm", lambda a: torch.linalg.matrix_norm(
        a, _ord(p), tuple(axis), keepdim), x)


def cond(x, p=None, name=None):
    return apply_fn("cond", lambda a: torch.linalg.cond(a, _ord(p)), x)


def _triangle(a, upper):
    return a.triu() if upper else a.tril()


def cholesky(x, upper=False, name=None):
    return apply_fn("cholesky", lambda a: torch.linalg.cholesky(
        a, upper=upper), x)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A X = x`` with A's Cholesky factor ``y`` (lower unless
    ``upper``), of which only that triangle is read (and differentiated),
    as JAX's triangular solves read it."""
    return apply_fn("cholesky_solve", lambda b, fac: torch.cholesky_solve(
        b, _triangle(fac, upper), upper), x, y)


def qr(x, mode="reduced", name=None):
    """``(Q, R)``; ``mode="r"`` returns R alone."""
    if mode == "r":
        return apply_fn("qr", lambda a: torch.linalg.qr(a, "r")[1], x)
    return apply_fn("qr", lambda a: tuple(torch.linalg.qr(a, mode)), x)


def svd(x, full_matrices=False, name=None):
    """``(U, S, V)`` with ``x = U diag(S) V^H`` (V, not V^H)."""
    def fn(a):
        u, s, vh = torch.linalg.svd(a, full_matrices=full_matrices)
        return u, s, vh.mH

    return apply_fn("svd", fn, x)


def svdvals(x, name=None):
    return apply_fn("svdvals", torch.linalg.svdvals, x)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The first ``q`` (default ``min(6, m, n)``) singular triples of x
    (centred over its rows), from a full SVD: deterministic, as in JAX
    (``niter`` has nothing to iterate)."""
    def fn(a):
        if center:
            a = a - a.mean(-2, keepdim=True)
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        k = q if q is not None else min(6, *a.shape[-2:])
        return u[..., :k], s[..., :k], vh.mH[..., :k]

    return apply_fn("pca_lowrank", fn, x)


def inv(x, name=None):
    return apply_fn("inv", torch.linalg.inv, x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """Pseudo-inverse; singular values below ``rcond`` times the largest
    are dropped."""
    return apply_fn("pinv", lambda a: torch.linalg.pinv(
        a, rtol=rcond, hermitian=hermitian), x)


def det(x, name=None):
    return apply_fn("det", torch.linalg.det, x)


def slogdet(x, name=None):
    """[sign, log|det|] stacked on a new first axis."""
    return apply_fn("slogdet", lambda a: torch.stack(
        tuple(torch.linalg.slogdet(a)), 0), x)


def solve(x, y, name=None):
    """``x X = y``; a ``y`` with one dim fewer than ``x`` is a (batch of)
    vector(s)."""
    def fn(a, b):
        if b.ndim == a.ndim - 1:
            return torch.linalg.solve(a, b[..., None])[..., 0]
        return torch.linalg.solve(a, b)

    return apply_fn("solve", fn, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """``x X = y`` (``x^T X = y`` with ``transpose``) for triangular x."""
    def fn(a, b):
        if transpose:
            a, up = a.mT, not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return apply_fn("triangular_solve", fn, x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)`` of the least
    squares problem ``x X = y`` (2-D x), JAX's SVD solution: singular
    values below ``rcond`` (default eps x max(m, n)) times the largest are
    dropped; the residuals are the squared column norms of ``y - x X``,
    always returned as in JAX. ``driver`` picks a LAPACK routine in Paddle;
    every routine gives this solution on well-posed inputs."""
    def fn(a, b):
        m, n = a.shape[-2:]
        vec = b.ndim == 1
        bb = b[:, None] if vec else b
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        rc = torch.finfo(a.dtype).eps * max(m, n) if rcond is None \
            else rcond
        keep = s >= rc * s[0]
        s_inv = torch.where(keep, 1 / torch.where(keep, s, 1), 0)[:, None]
        sol = vh.mH @ (s_inv * (u.mH @ bb))
        resid = torch.linalg.vector_norm(bb - a @ sol, dim=0) ** 2
        return (sol[:, 0] if vec else sol), resid, keep.sum(), s

    return apply_fn("lstsq", fn, x, y)


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots)`` (1-based, int32), and LAPACK's info with
    ``get_infos``."""
    out = apply_fn("lu", lambda a: tuple(torch.linalg.lu_factor_ex(
        a, pivot=pivot)), x)
    return tuple(out) if get_infos else (out[0], out[1])


def matrix_power(x, n, name=None):
    return apply_fn("matrix_power", lambda a: torch.linalg.matrix_power(
        a, n), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """Singular values above ``tol`` (default: the largest x eps x max(m,
    n)), counted."""
    def fn(a):
        if tol is None:
            return torch.linalg.matrix_rank(a, hermitian=hermitian)
        return torch.linalg.matrix_rank(a, atol=float(unwrap(tol)), rtol=0.0,
                                        hermitian=hermitian)

    return apply_fn("matrix_rank", fn, x)


def eig(x, name=None):
    """Complex eigenvalues and eigenvectors of a general matrix."""
    return apply_fn("eig", lambda a: tuple(torch.linalg.eig(a)), x)


def eigh(x, UPLO="L", name=None):
    """Eigenvalues and eigenvectors of the symmetric matrix held in x's
    ``UPLO`` triangle (Paddle's and LAPACK's; JAX averages x with its
    transpose first, so the two agree on symmetric input only)."""
    return apply_fn("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO)), x)


def eigvals(x, name=None):
    return apply_fn("eigvals", torch.linalg.eigvals, x)


def eigvalsh(x, UPLO="L", name=None):
    return apply_fn("eigvalsh", lambda a: torch.linalg.eigvalsh(a, UPLO), x)


def cross(x, y, axis=9, name=None):
    """Cross product along ``axis``; the default 9 means the first axis of
    size 3."""
    def fn(a, b):
        ax = axis
        if ax == 9:
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)

    return apply_fn("cross", fn, x, y)


def householder_product(x, tau, name=None):
    """The first n columns of ``H_1 ... H_n``, ``H_i = I - tau_i v_i
    v_i^H`` with v_i the i-th column of x below the diagonal and a unit
    on it."""
    return apply_fn("householder_product", torch.linalg.householder_product,
                    x, tau)


def corrcoef(x, rowvar=True, name=None):
    return apply_fn("corrcoef", lambda a: torch.corrcoef(
        a if rowvar else a.T), x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """Covariance of the rows (the columns unless ``rowvar``), divided by
    N - 1 (N with ``ddof=False``); ``fweights`` (integer repeat counts)
    and ``aweights`` (observation weights) as torch's ``cov`` takes them
    (JAX ignores both)."""
    extra = [t for t in (fweights, aweights) if t is not None]

    def fn(a, *w):
        it = iter(w)
        fw = next(it) if fweights is not None else None
        aw = next(it) if aweights is not None else None
        return torch.cov(a if rowvar else a.T, correction=int(bool(ddof)),
                         fweights=fw, aweights=aw)

    return apply_fn("cov", fn, x, *extra)


def multi_dot(x, name=None):
    return apply_fn("multi_dot", lambda *xs: torch.linalg.multi_dot(xs), *x,
                    _opdef=_MM)


def matrix_exp(x, name=None):
    return apply_fn("matrix_exp", torch.linalg.matrix_exp, x)


def _fp8(a):
    """``a`` cast to float8_e4m3fn as XLA casts: NaN beyond +-464 (torch's
    cast saturates)."""
    return torch.where(a.abs() > 464, float("nan"), a.float()).to(
        torch.float8_e4m3fn)


def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, scale=1.0,
                            output_dtype="float16", activation_type="identity",
                            name=None):
    """``act(scale (fp8(x) @ fp8(y)) + bias)`` in ``output_dtype``, the
    product accumulated in fp32; ``act`` identity, ``relu`` or ``gelu``
    (tanh form, as ``jax.nn.gelu``)."""
    if activation_type not in ("identity", "relu", "gelu"):
        raise ValueError(f"unknown activation_type {activation_type!r}")
    out_dt = dtype_mod.convert_dtype(output_dtype)

    def fn(a, b, *bias_arr):
        if transpose_x:
            a = a.mT
        if transpose_y:
            b = b.mT
        a8, b8 = _fp8(a), _fp8(b)
        if a8.is_cuda and a8.ndim == b8.ndim == 2 \
                and a8.shape[1] % 16 == 0 and b8.shape[1] % 16 == 0:
            one = torch.ones((), device=a8.device)
            acc = torch._scaled_mm(a8.contiguous(), b8.T.contiguous().T,
                                   one, one, out_dtype=torch.float32)
        else:
            acc = torch.matmul(a8.float(), b8.float())
        out = acc * scale
        if bias_arr:
            out = out + bias_arr[0].float()
        if activation_type == "gelu":
            out = torch.nn.functional.gelu(out, approximate="tanh")
        elif activation_type == "relu":
            out = torch.relu(out)
        return out.to(out_dt)

    extra = [bias] if bias is not None else []
    return apply_fn("fp8_gemm_fused", fn, x, y, *extra)


# ---- the four ``paddle.linalg`` names of tensor/extras.py ----

def cholesky_inverse(x, upper=False, name=None):
    """The inverse of ``A = L L^T`` (``U^T U`` with ``upper``) from its
    factor x, of which only that triangle is read."""
    return apply_fn("cholesky_inverse", lambda f: torch.cholesky_inverse(
        _triangle(f, upper), upper), x)


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """``(P, L, U)`` of a combined LU factor and its 1-based pivots."""
    return apply_fn("lu_unpack", lambda a, piv: tuple(torch.lu_unpack(
        a, piv.int(), unpack_ludata, unpack_pivots)), lu_data, lu_pivots)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized SVD (JAX's ``svd_lowrank``): ``min(q, m, n)`` Gaussian
    test vectors from the port's generator of x's device, ``niter`` power
    iterations, a QR and an SVD of the small projection; returns ``(U,
    S, V)``. ``M`` (which JAX ignores) is subtracted from x first, as
    Paddle's."""
    def fn(a, *m_):
        if m_:
            a = a - m_[0]
        m, n = a.shape[-2:]
        r = min(q, m, n)
        g = torch.randn(a.shape[:-2] + (n, r), dtype=a.dtype,
                        device=a.device, generator=global_generator(a.device))
        y = a @ g
        for _ in range(niter):
            y = a @ (a.mT @ y)
        qmat = torch.linalg.qr(y)[0]
        u, s, vh = torch.linalg.svd(qmat.mT @ a, full_matrices=False)
        return qmat @ u, s, vh.mT

    extra = [M] if M is not None else []
    return apply_fn("svd_lowrank", fn, x, *extra)


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """``Q y`` (``y Q`` unless ``left``; ``Q^T`` with ``transpose``), Q the
    full m x m product of the Householder reflectors in x and tau."""
    return apply_fn("ormqr", lambda a, t, other: torch.ormqr(
        a, t, other, left, transpose), x, tau, y)
