"""``paddle_tpu_torch.linalg`` (``tensor/linalg.py`` and its four
``tensor/extras.py`` names) against the JAX package's ``paddle_tpu.linalg``,
CPU, fp32, numpy inputs from a seed.

Functions with a unique result are held directly: outputs within ``tol``
of max(1, max |jax|) (1e-5; 1e-4 for the iterative ones: ``matrix_exp``,
``cond``, ``pinv``, ``lstsq``) and the gradients of sum(out * cotangent)
within ``gtol``. QR, SVD, ``eig`` and ``eigh`` are defined only up to
the sign (phase) of each vector: held are the values, the
reconstructions and the orthogonality. Where the port gives an argument
JAX ignores its Paddle meaning (``cov``'s weights, ``lu``'s infos) the
reference is numpy.
"""

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pt_device
from torch_nn_parity import F, as_np, check, compare

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_place():
    prev = pt_device._PLACE
    pt.set_device("cpu")
    yield
    pt_device._PLACE = prev


def SPD(*batch, n=5):
    a = F(*batch, n, n)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def WELL(*batch, n=5):
    """Well-conditioned square matrices."""
    return (F(*batch, n, n, scale=0.3) + 2 * np.eye(n)).astype(np.float32)


def TRI(n=5, upper=True):
    a = np.triu(F(n, n)) if upper else np.tril(F(n, n))
    return (a + 3 * np.eye(n) * np.sign(np.diag(a) + 1e-3)).astype(
        np.float32)


CASES = []


def case(name, fn, inputs, grad=(0,), tol=1e-5, gtol=1e-5):
    CASES.append(pytest.param(fn, inputs, grad, tol, gtol, id=name))


L = lambda P: P.linalg  # noqa: E731
case("dot", lambda P, a, b: L(P).dot(a, b), [F(4, 6), F(4, 6)], (0, 1))
case("bmm", lambda P, a, b: L(P).bmm(a, b), [F(3, 4, 5), F(3, 5, 2)], (0, 1))
case("mv", lambda P, a, b: L(P).mv(a, b), [F(4, 5), F(5)], (0, 1))
for _p, _ax, _kd in ((None, None, False), ("fro", [0, 1], True),
                     (2, 1, False), (1, None, True), ("inf", 0, False),
                     ("-inf", None, False), (3.0, -1, True),
                     ("nuc", [0, 1], False), (1, [0, 1], False),
                     ("inf", [0, 1], True), (0, 1, False)):
    case(f"norm-{_p}-{_ax}-{_kd}", lambda P, a, p=_p, ax=_ax, kd=_kd:
         L(P).norm(a, p, ax, kd), [F(4, 6)], (0,) if _p != 0 else (),
         gtol=1e-4)
case("norm-3d-list-axis", lambda P, a: L(P).norm(a, "fro", [1, 2]),
     [F(3, 4, 5)])
for _p, _ax in ((2.0, None), (1.0, 1), (float("inf"), 1)):
    case(f"vector_norm-{_p}-{_ax}", lambda P, a, p=_p, ax=_ax:
         L(P).vector_norm(a, p, ax), [F(4, 6)])
for _p in ("fro", "nuc", 1, 2, float("inf")):
    case(f"matrix_norm-{_p}", lambda P, a, p=_p: L(P).matrix_norm(a, p),
         [F(2, 4, 4)], gtol=1e-4)
case("cond", lambda P, a: L(P).cond(a), [WELL()], (), tol=1e-4)
case("cond-fro", lambda P, a: L(P).cond(a, "fro"), [WELL()], (), tol=1e-4)
case("cholesky", lambda P, a: L(P).cholesky(a), [SPD(2)], (0,), gtol=1e-4)
case("cholesky-upper", lambda P, a: L(P).cholesky(a, upper=True), [SPD()],
     (0,), gtol=1e-4)
_CH = np.linalg.cholesky(SPD(n=4)).astype(np.float32)
case("cholesky_solve", lambda P, b, c: L(P).cholesky_solve(b, c),
     [F(4, 3), _CH], (0, 1), gtol=1e-4)
case("cholesky_solve-upper", lambda P, b, c: L(P).cholesky_solve(
    b, c, upper=True), [F(4, 3), np.ascontiguousarray(_CH.T)], (0,))
case("inv", lambda P, a: L(P).inv(a), [WELL(3)], gtol=1e-4)
case("pinv", lambda P, a: L(P).pinv(a), [F(5, 3)], (), tol=1e-4)
case("det", lambda P, a: L(P).det(a), [WELL(3)], gtol=1e-4)
case("slogdet", lambda P, a: L(P).slogdet(a), [F(3, 4, 4)], (0,),
     gtol=1e-4)
case("solve", lambda P, a, b: L(P).solve(a, b), [WELL(2), F(2, 5, 3)],
     (0, 1), gtol=1e-4)
case("solve-vector", lambda P, a, b: L(P).solve(a, b), [WELL(), F(5)],
     (0, 1), gtol=1e-4)
for _up, _tr, _unit in ((True, False, False), (False, False, True),
                        (True, True, False), (False, True, False)):
    case(f"triangular_solve-{_up}-{_tr}-{_unit}", lambda P, a, b, u=_up,
         t=_tr, un=_unit: L(P).triangular_solve(a, b, u, t, un),
         [TRI(upper=_up), F(5, 2)], (1,), gtol=1e-4)
case("lstsq", lambda P, a, b: L(P).lstsq(a, b), [F(7, 4), F(7, 2)], (),
     tol=1e-4)
case("lstsq-rank-deficient", lambda P, a, b: L(P).lstsq(a, b, rcond=1e-3),
     [np.concatenate([_a := F(6, 2), _a @ F(2, 2)], 1), F(6, 3)], (),
     tol=1e-4)
case("lu", lambda P, a: L(P).lu(a), [F(3, 5, 5)], ())
case("matrix_power", lambda P, a: L(P).matrix_power(a, 3), [F(2, 4, 4,
                                                             scale=0.5)])
case("matrix_power-neg", lambda P, a: L(P).matrix_power(a, -2), [WELL()],
     gtol=1e-4)
case("matrix_rank", lambda P, a: L(P).matrix_rank(a),
     [np.concatenate([_a := F(6, 3), _a @ F(3, 2)], 1)], ())
case("matrix_rank-tol", lambda P, a: L(P).matrix_rank(a, 2.0), [F(3, 6, 6)],
     ())
case("eigvalsh", lambda P, a: L(P).eigvalsh(a), [SPD(2)], (0,), gtol=1e-4)
case("eigvalsh-U", lambda P, a: L(P).eigvalsh(a, "U"), [SPD(3)], (0,),
     gtol=1e-4)
case("svdvals", lambda P, a: L(P).svdvals(a), [F(2, 5, 3)], (0,), gtol=1e-4)
case("cross-9", lambda P, a, b: L(P).cross(a, b), [F(4, 3, 2), F(4, 3, 2)],
     (0, 1))
case("cross-axis", lambda P, a, b: L(P).cross(a, b, axis=-1),
     [F(4, 3), F(4, 3)], (0, 1))
case("householder_product", lambda P, a, t: L(P).householder_product(a, t),
     [F(6, 4), F(4)], (0, 1), gtol=1e-4)
case("corrcoef", lambda P, a: L(P).corrcoef(a), [F(3, 8)], gtol=1e-4)
case("corrcoef-cols", lambda P, a: L(P).corrcoef(a, rowvar=False),
     [F(8, 3)], gtol=1e-4)
case("cov", lambda P, a: L(P).cov(a), [F(3, 8)])
case("cov-cols-ddof0", lambda P, a: L(P).cov(a, rowvar=False, ddof=False),
     [F(8, 3)])
case("multi_dot", lambda P, a, b, c: L(P).multi_dot([a, b, c]),
     [F(3, 4), F(4, 6), F(6, 2)], (0, 1, 2))
case("matrix_exp", lambda P, a: L(P).matrix_exp(a), [F(2, 4, 4, scale=0.5)],
     tol=1e-4, gtol=1e-4)
case("cholesky_inverse", lambda P, a: L(P).cholesky_inverse(a), [_CH],
     tol=1e-4, gtol=1e-4)
case("cholesky_inverse-upper", lambda P, a: L(P).cholesky_inverse(
    a, upper=True), [np.ascontiguousarray(_CH.T)], tol=1e-4, gtol=1e-4)
case("fp8_gemm", lambda P, a, b: L(P).fp8_fp8_half_gemm_fused(
    a, b, output_dtype="float32"), [F(8, 16), F(16, 8)], ())
case("fp8_gemm-bias-gelu-scale-T", lambda P, a, b, c: L(P)
     .fp8_fp8_half_gemm_fused(a, b, c, transpose_y=True, scale=0.5,
                              output_dtype="float32",
                              activation_type="gelu"),
     [F(8, 16), F(4, 16), F(4)], ())
case("fp8_gemm-relu-transpose_x", lambda P, a, b: L(P)
     .fp8_fp8_half_gemm_fused(a, b, transpose_x=True, output_dtype="float32",
                              activation_type="relu"), [F(16, 8), F(16, 8)],
     ())


@pytest.mark.parametrize("fn,inputs,grad,tol,gtol", CASES)
def test_linalg_matches_jax(fn, inputs, grad, tol, gtol):
    check(fn, inputs, grad, tol, gtol)


def test_fp8_gemm_overflow_matches_jax():
    """Beyond +-448: XLA's cast gives NaN past +-464 and rounds to 448
    below it (torch's own cast saturates); the port's result equals JAX's,
    NaNs included."""
    a = np.array([[460.0, 1.0], [470.0, 0.5], [-465.0, 2.0], [300.0, -1.0]],
                 np.float32)
    b = np.eye(2, dtype=np.float32)
    out = pt.linalg.fp8_fp8_half_gemm_fused(pt.to_tensor(a), pt.to_tensor(b),
                                            output_dtype="float32")
    ref = jp.linalg.fp8_fp8_half_gemm_fused(jp.to_tensor(a), jp.to_tensor(b),
                                            output_dtype="float32")
    np.testing.assert_array_equal(as_np(out), as_np(ref))
    assert np.isnan(as_np(out)[1:3]).all()


def test_vector_norm_over_two_axes_and_one_sided_eigh():
    """Two departures from JAX, held against numpy: ``vector_norm`` over
    two axes is a vector norm (JAX's is the matrix norm there), and
    ``eigvalsh`` / ``eigh`` read only the ``UPLO`` triangle (JAX
    symmetrizes first)."""
    a = F(4, 6)
    for p in (1.0, 2.0, float("inf"), 3.0):
        out = pt.linalg.vector_norm(pt.to_tensor(a), p, [0, 1])
        ref = np.linalg.norm(a.reshape(-1), p)
        compare(out, np.float32(ref), 1e-5)
    m = F(4, 4)
    for uplo in ("L", "U"):
        compare(pt.linalg.eigvalsh(pt.to_tensor(m), uplo),
                np.linalg.eigvalsh(m, uplo).astype(np.float32), 1e-5)


def test_fp8_gemm_half_output_and_nan_rule():
    a, b = F(8, 16, scale=4.0), F(16, 8, scale=4.0)
    out = pt.linalg.fp8_fp8_half_gemm_fused(pt.to_tensor(a), pt.to_tensor(b))
    ref = jp.linalg.fp8_fp8_half_gemm_fused(jp.to_tensor(a), jp.to_tensor(b))
    assert out.dtype == torch.float16
    compare(as_np(out), as_np(ref), 1e-3)
    bad = pt.linalg.fp8_fp8_half_gemm_fused(
        pt.to_tensor(np.full((2, 2), 500.0, np.float32)), pt.to_tensor(
            np.eye(2, dtype=np.float32)), output_dtype="float32")
    assert bool(torch.isnan(bad).all())


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_reconstructs_and_matches_r_up_to_sign(mode):
    a = F(2, 6, 4)
    out = pt.linalg.qr(pt.to_tensor(a), mode)
    ref = jp.linalg.qr(jp.to_tensor(a), mode)
    r, jr = (out, ref) if mode == "r" else (out[1], ref[1])
    compare(np.abs(as_np(r)), np.abs(as_np(jr)), 1e-5)
    if mode != "r":
        q = as_np(out[0])
        compare(q @ as_np(r), a, 1e-5)
        compare(np.swapaxes(q, -1, -2) @ q, np.broadcast_to(
            np.eye(q.shape[-1]), (2,) + (q.shape[-1],) * 2), 1e-5)


@pytest.mark.parametrize("full", [False, True])
def test_svd_values_reconstruction_and_gradient_of_values(full):
    a = F(3, 5, 4)
    u, s, v = (as_np(t) for t in pt.linalg.svd(pt.to_tensor(a), full))
    _, js, _ = jp.linalg.svd(jp.to_tensor(a), full)
    compare(s, as_np(js), 1e-5)
    k = s.shape[-1]
    compare((u[..., :k] * s[..., None, :]) @ np.swapaxes(v[..., :k], -1, -2),
            a, 1e-5)
    compare(np.swapaxes(u, -1, -2) @ u, np.broadcast_to(
        np.eye(u.shape[-1]), (3,) + (u.shape[-1],) * 2), 1e-5)
    check(lambda P, x: P.linalg.svd(x)[1], [a], (0,), 1e-5, 1e-4)


def test_eig_and_eigh_values_and_vectors():
    a = F(4, 4)
    w, v = (as_np(t) for t in pt.linalg.eig(pt.to_tensor(a)))
    jw, _ = jp.linalg.eig(jp.to_tensor(a))
    np.testing.assert_allclose(np.sort_complex(w),
                               np.sort_complex(as_np(jw)), atol=1e-4)
    np.testing.assert_allclose(a @ v, v * w[None, :], atol=1e-4)
    np.testing.assert_allclose(np.sort_complex(as_np(pt.linalg.eigvals(
        pt.to_tensor(a)))), np.sort_complex(as_np(jp.linalg.eigvals(
            jp.to_tensor(a)))), atol=1e-4)
    s = SPD(2)
    for uplo in ("L", "U"):
        w, v = (as_np(t) for t in pt.linalg.eigh(pt.to_tensor(s), uplo))
        jw, _ = jp.linalg.eigh(jp.to_tensor(s), uplo)
        compare(w, as_np(jw), 1e-5)
        compare((v * w[..., None, :]) @ np.swapaxes(v, -1, -2), s, 1e-4)


def test_lowrank_decompositions():
    a = F(8, 6)
    u, s, v = (as_np(t) for t in pt.linalg.pca_lowrank(pt.to_tensor(a), 3))
    ju, js, jv = (as_np(t) for t in jp.linalg.pca_lowrank(jp.to_tensor(a),
                                                          3))
    compare(s, js, 1e-5)
    compare((u * s) @ v.T, (ju * js) @ jv.T, 1e-5)
    # randomized, in fp32, its power iterations squaring the condition
    # number twice: a rank-3 matrix back within 2e-3 of its largest entry
    low = (F(9, 3) @ F(3, 7)).astype(np.float32)
    pt.seed(3)
    u, s, v = (as_np(t) for t in pt.linalg.svd_lowrank(pt.to_tensor(low), 3))
    compare((u * s) @ v.T, low, 2e-3)
    compare(s, np.linalg.svd(low, compute_uv=False)[:3], 2e-3)
    mean = np.full((9, 7), 0.5, np.float32)
    u, s, v = (as_np(t) for t in pt.linalg.svd_lowrank(
        pt.to_tensor(low + mean), 3, M=pt.to_tensor(mean)))
    compare((u * s) @ v.T, low, 2e-3)


def test_lu_unpack_and_ormqr_match_jax():
    a = F(2, 5, 5)
    lu_t, piv_t = pt.linalg.lu(pt.to_tensor(a))
    lu_j, piv_j = jp.linalg.lu(jp.to_tensor(a))
    compare(as_np(piv_t), as_np(piv_j), 0)
    p, lo, up = (as_np(t) for t in pt.linalg.lu_unpack(lu_t, piv_t))
    jpm, jl, ju = (as_np(t) for t in jp.linalg.lu_unpack(lu_j, piv_j))
    compare(p, jpm, 0)
    compare(lo, jl, 1e-5)
    compare(up, ju, 1e-5)
    compare(p @ lo @ up, a, 1e-5)
    _, _, info = pt.linalg.lu(pt.to_tensor(a), get_infos=True)
    assert not as_np(info).any()
    refl, tau = torch.geqrf(torch.from_numpy(F(6, 4)))
    y = F(6, 3)
    for left, trans in ((True, False), (True, True)):
        out = pt.linalg.ormqr(pt.to_tensor(refl.numpy()),
                              pt.to_tensor(tau.numpy()), pt.to_tensor(y),
                              left, trans)
        ref = jp.linalg.ormqr(jp.to_tensor(refl.numpy()),
                              jp.to_tensor(tau.numpy()), jp.to_tensor(y),
                              left, trans)
        compare(out, ref, 1e-5)


def test_cov_weights_and_matrix_rank_hermitian():
    """``fweights`` / ``aweights`` (which JAX ignores) as numpy's ``cov``;
    ``matrix_rank(hermitian=True)`` counts |eigenvalues|."""
    x = F(3, 10)
    fw = np.arange(1, 11)
    aw = np.linspace(0.1, 1.0, 10).astype(np.float32)
    out = pt.linalg.cov(pt.to_tensor(x), fweights=pt.to_tensor(fw),
                        aweights=pt.to_tensor(aw))
    compare(out, np.cov(x, fweights=fw, aweights=aw).astype(np.float32),
            1e-5)
    out = pt.linalg.cov(pt.to_tensor(x), ddof=False, fweights=pt.to_tensor(
        fw))
    compare(out, np.cov(x, ddof=0, fweights=fw).astype(np.float32), 1e-5)
    s = SPD(n=6)
    s[:, 0] = s[0, :] = 0
    assert int(pt.linalg.matrix_rank(pt.to_tensor(s), hermitian=True)) == 5


def test_linalg_namespace_top_level_and_methods():
    """``paddle.linalg`` holds every public function of the JAX package's;
    the top level exports them; ``Tensor`` methods torch lacks are
    Paddle's, those torch has stay torch's."""
    names = [n for n in dir(jp.linalg) if not n.startswith("_")
             and callable(getattr(jp.linalg, n))
             and getattr(getattr(jp.linalg, n), "__module__", "").startswith(
                 "paddle_tpu.tensor")]
    assert len(names) >= 38
    for n in names:
        assert callable(getattr(pt.linalg, n)), n
        assert getattr(pt, n) is getattr(pt.linalg, n), n
    x = pt.to_tensor(WELL())
    compare(x.inv(), pt.linalg.inv(x), 0)
    compare(x.pinv(), pt.linalg.pinv(x), 0)
    lu, piv = pt.linalg.lu(x)
    compare(lu.lu_unpack(piv)[0], pt.linalg.lu_unpack(lu, piv)[0], 0)
    for name in ("norm", "dot", "cross", "det", "svd", "slogdet"):
        assert getattr(pt.Tensor, name) is getattr(torch.Tensor, name)
    assert isinstance(pt.linalg.slogdet(x), torch.Tensor)
    assert tuple(pt.linalg.slogdet(x).shape) == (2,)
